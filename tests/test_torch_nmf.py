"""The port's model API against ``nmf_tpu`` on the CPU: ``solve_h_only``,
``solve_w_only``, ``normalize_factors``, the ``NMF`` estimator and
``utils.convert.nmf_from_params``.

The same inputs, made from a seed with NumPy, go through both packages
(``torch.set_num_threads(1)``).  The KL H-only solve goes through K1's and
K3's wrappers (on the CPU their plain versions), counted by wrapping them:
``update_h_fused`` once an iteration, ``kl_cost_fused`` once a check, with
``matmul_dtype="float32"`` in every policy, ``update_w_fused`` never; the
other families call none of them.

Tolerances (measured on these problems, f32 sums in other orders):

* ``normalize_factors``: byte-equal (the same NumPy on the same arrays).
* H-only and W-only solves, fits and transforms of up to 200 iterations:
  factors rtol 1e-4 / atol 1e-6 and costs rel 1e-5, as
  tests/test_torch_solver.py holds the KL solve (measured: factors <= 2.1e-5
  relative, costs <= 5.8e-7, in every family, ``float32_fast`` 4.6e-5 and
  bf16 X 6.3e-6 included, their cost with its true-f32 recon in both
  packages); HALS by relative Frobenius norm 1e-4 (it makes exact zeros;
  equal here); ``bfloat16`` GEMMs: costs rel 1e-4, factors rtol 2e-2,
  tests/test_torch_precision.py's for a solve under bf16 GEMMs, where a
  last-ulp difference of W H flips the bf16 rounding of a Z entry and the
  flips compound (measured 4.5e-3 after 200 iterations); bf16 state: costs
  rel 1e-3, factors by relative Frobenius norm 5e-2
  (tests/test_torch_accel.py's).
* the estimator's ``reconstruction_err_`` and ``score``: rel 1e-5;
  ``n_iter_`` equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import nmf as tnmf  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, nmf_from_params  # noqa: E402

COST_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
FRO, BF16_FRO, BF16_COST_RTOL = 1e-4, 5e-2, 1e-3
BF16_GEMM_COST_RTOL, BF16_GEMM_RTOL = 1e-4, 2e-2

FAMILIES = {
    "kl": dict(),
    "beta0": dict(beta=0.0),
    "beta0.5": dict(beta=0.5),
    "beta2": dict(beta=2.0),
    "beta3": dict(beta=3.0),
    "hals": dict(beta=2.0, algorithm="hals"),
    "kl_reg": dict(l1_w=0.3, l1_h=0.2, l2_w=0.1, l2_h=0.05),
}
VARIANTS = {
    "f32": dict(),
    "accelerate": dict(accelerate=True),
    "int8_x": dict(precision=jt.Precision(x_dtype="int8")),
}
KL_POLICIES = {
    "bfloat16": jt.Precision(matmul_dtype="bfloat16"),
    "float32_fast": jt.Precision(matmul_dtype="float32_fast"),
    "bf16_x": jt.Precision(x_dtype="bfloat16"),
    "bf16_state": jt.Precision(state_dtype="bfloat16"),
    "int8_rows": jt.Precision(x_dtype="int8", x_quant_rows=16),
}
WRAPPERS = ("update_h_fused", "update_w_fused", "kl_cost_fused")


def _problem(m=48, k=5, n=40, seed=8):
    rng = np.random.RandomState(seed)
    return (rng.rand(m, n).astype(np.float32) + 1e-3, rng.rand(m, k).astype(np.float32) + 1e-3,
            rng.rand(k, n).astype(np.float32) + 1e-3)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _counted(fn):
    """(fn(), {wrapper: calls}, the precisions K3 was called with)."""
    calls = dict.fromkeys(WRAPPERS, 0)
    cost_precisions = []
    originals = {name: getattr(tfm, name) for name in WRAPPERS}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            if name == "kl_cost_fused":
                cost_precisions.append(args[4] if len(args) > 4 else kw["precision"])
            return originals[name](*args, **kw)
        return call

    for name in WRAPPERS:
        setattr(tfm, name, counting(name))
    try:
        res = fn()
    finally:
        for name, f in originals.items():
            setattr(tfm, name, f)
    return res, calls, cost_precisions


def _assert_match(rj, rp, family="kl", bf16_state=False, bf16_gemm=False):
    for f in ("iterations", "num_checks", "converged"):
        assert int(getattr(rp, f)) == int(getattr(rj, f)), f
    cost_rtol = BF16_COST_RTOL if bf16_state else BF16_GEMM_COST_RTOL if bf16_gemm else COST_RTOL
    hj, hp = np.asarray(rj.cost_history), _f32(rp.cost_history)
    np.testing.assert_array_equal(np.isnan(hp), np.isnan(hj))
    np.testing.assert_allclose(hp, hj, rtol=cost_rtol)
    for f in ("w", "h"):
        ours, ref = _f32(getattr(rp, f)), _f32(getattr(rj, f))
        assert ours.shape == ref.shape, f
        if bf16_state or family == "hals":
            fro = BF16_FRO if bf16_state else FRO
            assert np.linalg.norm(ours - ref) <= fro * np.linalg.norm(ref), f
        else:
            np.testing.assert_allclose(ours, ref, rtol=BF16_GEMM_RTOL if bf16_gemm else RTOL,
                                       atol=ATOL)


# ---- normalize_factors -----------------------------------------------------


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("zero_column", [False, True])
def test_normalize_factors_byte_equal(norm, zero_column):
    _, w, h = _problem()
    if zero_column:
        w = w.copy()
        w[:, 2] = 0.0
    wj, hj = jt.normalize_factors(w, h, norm)
    wp, hp = pt.normalize_factors(w, h, norm)
    assert wp.tobytes() == np.asarray(wj).tobytes() and hp.tobytes() == np.asarray(hj).tobytes()


def test_normalize_factors_takes_tensors_and_refuses_a_bad_norm():
    _, w, h = _problem()
    wp, hp = pt.normalize_factors(torch.from_numpy(w), torch.from_numpy(h))
    wj, hj = jt.normalize_factors(w, h)
    assert wp.tobytes() == np.asarray(wj).tobytes() and hp.tobytes() == np.asarray(hj).tobytes()
    with pytest.raises(ValueError, match="norm must be"):
        pt.normalize_factors(w, h, "l3")


# ---- solve_h_only / solve_w_only -------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_solve_h_only_matches_jax(family, variant):
    x, w, h = _problem()
    jcfg = jt.SolveConfig(max_iter=30, check_every=10, **FAMILIES[family], **VARIANTS[variant])
    rj = jt.solve_h_only(x, w, h, jcfg)
    rp, calls, precs = _counted(lambda: pt.solve_h_only(x, w, h, _pcfg(jcfg), device="cpu"))
    _assert_match(rj, rp, family)
    # W is fixed: the result's W is the clamped input
    assert _f32(rp.w).tobytes() == np.maximum(w, np.float32(jt.EPS)).tobytes()
    if family == "kl":
        checks = int(rp.num_checks) + (1 if variant == "accelerate" else 0)
        assert calls["update_h_fused"] >= 30 and calls["update_w_fused"] == 0
        assert calls["kl_cost_fused"] >= checks
        assert all(p.matmul_dtype == "float32" for p in precs)
    else:
        assert calls == dict.fromkeys(WRAPPERS, 0), calls


@pytest.mark.parametrize("policy", list(KL_POLICIES))
def test_kl_h_only_policies_match_jax(policy):
    """The KL H-only solve in each precision policy, 200 iterations: K1 once
    an iteration and K3 once a check (with a true-f32 recon, as JAX's H-only
    cost), K2 never; per-row-block int8 scales take the plain ops (none)."""
    x, w, h = _problem()
    jcfg = jt.SolveConfig(max_iter=200, check_every=25, precision=KL_POLICIES[policy])
    rj = jt.solve_h_only(x, w, h, jcfg)
    rp, calls, precs = _counted(lambda: pt.solve_h_only(x, w, h, _pcfg(jcfg), device="cpu"))
    _assert_match(rj, rp, bf16_state=policy == "bf16_state", bf16_gemm=policy == "bfloat16")
    if policy == "int8_rows":
        assert calls == dict.fromkeys(WRAPPERS, 0), calls
    else:
        assert calls == {"update_h_fused": 200, "update_w_fused": 0, "kl_cost_fused": 8}
        assert [p.matmul_dtype for p in precs] == ["float32"] * 8
        assert all(p.x_dtype == KL_POLICIES[policy].x_dtype for p in precs)


def test_kl_h_only_reference_shape_calls():
    """The reference fixtures, 200 iterations: exactly 200 K1 and 8 K3
    wrapper calls, no K2; the cost against ``nmf_tpu.solve_h_only``."""
    x, w, h = (jt.fixtures.as_seen_by_solver(a)
               for a in jt.fixtures.reference_fixture_arrays().values())
    jcfg = jt.reference_preset()
    rp, calls, _ = _counted(lambda: pt.solve_h_only(x, w, h, _pcfg(jcfg), device="cpu"))
    assert calls == {"update_h_fused": 200, "update_w_fused": 0, "kl_cost_fused": 8}
    rj = jt.solve_h_only(x, w, h, jcfg)
    assert float(rp.cost) == pytest.approx(float(rj.cost), rel=COST_RTOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_solve_w_only_matches_jax(family):
    """The transposed problem, its penalties swapped, in each family."""
    x, w, h = _problem()
    jcfg = jt.SolveConfig(max_iter=30, check_every=10, **FAMILIES[family])
    rj = jt.solve_w_only(x, w, h, jcfg)
    rp, calls, _ = _counted(lambda: pt.solve_w_only(x, w, h, _pcfg(jcfg), device="cpu"))
    _assert_match(rj, rp, family)
    assert rp.w.is_contiguous() and rp.h.is_contiguous()
    if family == "kl":
        assert calls == {"update_h_fused": 30, "update_w_fused": 0, "kl_cost_fused": 3}


def test_solve_w_only_hands_the_kernel_contiguous_transposes():
    """X^T, H^T and W0^T are made contiguous once: every K1 call sees
    row-major operands (the CUDA wrappers refuse others), and the caller's
    arrays are untouched."""
    x, w, h = _problem()
    seen = []
    original = tfm.update_h_fused

    def spy(w_, h_, x_, *a, **kw):
        seen.append((w_.is_contiguous(), h_.is_contiguous(), x_.is_contiguous(),
                     tuple(x_.shape)))
        return original(w_, h_, x_, *a, **kw)

    tfm.update_h_fused = spy
    try:
        xt = torch.from_numpy(x.copy())
        pt.solve_w_only(xt, w, h, pt.SolveConfig(max_iter=5), device="cpu")
    finally:
        tfm.update_h_fused = original
    assert seen == [(True, True, True, (40, 48))] * 5
    assert np.array_equal(xt.numpy(), x)


def test_solve_w_only_refuses_a_quantized_pair():
    x, w, h = _problem()
    with pytest.raises(NotImplementedError, match="per-column int8 scales"):
        pt.solve_w_only((x.astype(np.uint8), np.ones(40, np.float32)), w, h,
                        pt.SolveConfig(precision=pt.Precision(x_dtype="int8")), device="cpu")


def test_h_only_pallas_with_row_block_scales_raises():
    x, w, h = _problem()
    cfg = pt.SolveConfig(backend="pallas", precision=pt.Precision(x_dtype="int8", x_quant_rows=16))
    with pytest.raises(NotImplementedError, match="per-row-block"):
        pt.solve_h_only(x, w, h, cfg, device="cpu")


@pytest.mark.parametrize("fn", ["solve_h_only", "solve_w_only"])
def test_mesh_is_refused(fn):
    """``mesh``, refused when this test was named, runs (the H-only and
    W-only solves on a mesh match ``nmf_tpu``'s in tests/test_torch_mesh.py);
    what is not a ``make_mesh`` DeviceMesh is refused."""
    x, w, h = _problem()
    with pytest.raises(TypeError, match="make_mesh"):
        getattr(pt, fn)(x, w, h, pt.SolveConfig(), mesh=object(), device="cpu")


def test_h_only_pair_and_shape_checks():
    x, w, h = _problem()
    with pytest.raises(ValueError, match="pre-quantized"):
        pt.solve_h_only((x.astype(np.uint8), np.ones(40, np.float32)), w, h, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        pt.solve_h_only(x, w, h[:, :7], device="cpu")


def test_h_only_pre_quantized_pair_matches_jax():
    """A ``(codes, scales)`` pair passes through the prep untouched."""
    from nmf_tpu.ops.quant import quantize_columns_np

    x, w, h = _problem()
    pair = quantize_columns_np(np.maximum(x, np.float32(jt.EPS)), jt.EPS)
    jcfg = jt.SolveConfig(max_iter=30, check_every=10, precision=jt.Precision(x_dtype="int8"))
    _assert_match(jt.solve_h_only(pair, w, h, jcfg),
                  pt.solve_h_only(pair, w, h, _pcfg(jcfg), device="cpu"))


# ---- the NMF estimator ------------------------------------------------------

FITS = {
    "kl_nndsvda": dict(),
    "kl_random": dict(init="random"),
    "kl_scaled": dict(init="scaled", accelerate=True),
    "frobenius_cd": dict(beta_loss=2.0, solver="cd", init="nndsvd"),
    "itakura_saito": dict(beta_loss=0.0, init="nndsvdar"),
    "alpha": dict(alpha_W=0.01, alpha_H=0.02, l1_ratio=0.3),
}


def _estimators(**kw):
    return jt.NMF(n_components=5, max_iter=60, **kw), pt.NMF(n_components=5, max_iter=60,
                                                             device="cpu", **kw)


@pytest.mark.parametrize("case", list(FITS))
def test_nmf_fit_transform_matches_jax(case):
    x, _, _ = _problem()
    ej, ep = _estimators(**FITS[case])
    wj, wp = ej.fit_transform(x), ep.fit_transform(x)
    fam = "hals" if ep.solver == "hals" else "kl"
    for ours, ref in ((wp, wj), (ep.components_, ej.components_)):
        if fam == "hals":
            assert np.linalg.norm(ours - ref) <= FRO * np.linalg.norm(ref)
        else:
            np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert isinstance(ep.w_, np.ndarray) and ep.w_.dtype == np.float32
    assert ep.n_iter_ == ej.n_iter_ == 60
    assert ep.reconstruction_err_ == pytest.approx(ej.reconstruction_err_, rel=COST_RTOL)
    assert ep.score(x) == pytest.approx(ej.score(x), rel=COST_RTOL)


@pytest.mark.parametrize("case", ["kl_nndsvda", "frobenius_cd", "alpha"])
def test_nmf_transform_matches_jax(case):
    """transform of new columns against the learned W, from the seeded H of
    ``RandomState(random_state)`` in both."""
    x, _, _ = _problem()
    x_new = np.random.RandomState(5).rand(48, 23).astype(np.float32)
    ej, ep = _estimators(**FITS[case])
    ej.fit(x)
    ep.fit(x)
    hj, hp = np.asarray(ej.transform(x_new, max_iter=40)), ep.transform(x_new, max_iter=40)
    assert hp.shape == (5, 23) and isinstance(hp, np.ndarray)
    if ep.solver == "hals":
        assert np.linalg.norm(hp - hj) <= FRO * np.linalg.norm(hj)
    else:
        np.testing.assert_allclose(hp, hj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("out_of_core", [False, True], ids=["in_memory", "out_of_core"])
@pytest.mark.parametrize("case", ["kl_nndsvda", "alpha"])
def test_nmf_transform_with_a_mask_matches_jax(tmp_path, case, out_of_core):
    """``transform(mask=...)`` against ``nmf_tpu.NMF.transform(mask=...)``:
    the masked H-only solve in memory, or streamed beside X from ``.bin``
    files with ``out_of_core`` (NaN in the unobserved entries of X)."""
    x, _, _ = _problem()
    rng = np.random.RandomState(6)
    x_new = rng.rand(48, 23).astype(np.float32)
    mask = (rng.rand(48, 23) > 0.25).astype(np.float32)
    x_new[mask == 0] = np.nan
    ej, ep = _estimators(**FITS[case])
    ej.fit(x)
    ep.fit(x)
    src, msrc = x_new, mask
    if out_of_core:
        src, msrc = str(tmp_path / "X.bin"), str(tmp_path / "M.bin")
        jbin.write_matrix(x_new, src)
        jbin.write_matrix(mask, msrc)
    hj = np.asarray(ej.transform(src, max_iter=40, out_of_core=out_of_core, mask=msrc))
    hp = ep.transform(src, max_iter=40, out_of_core=out_of_core, mask=msrc)
    assert hp.shape == (5, 23) and isinstance(hp, np.ndarray) and np.isfinite(hp).all()
    np.testing.assert_allclose(hp, hj, rtol=RTOL, atol=ATOL)


def test_nmf_masked_transform_of_ones_is_the_plain_transform():
    """A mask of ones gives the plain transform's H to f32 rounding."""
    x, _, _ = _problem()
    ep = pt.NMF(n_components=5, max_iter=60, device="cpu").fit(x)
    x_new = np.random.RandomState(5).rand(48, 23).astype(np.float32)
    np.testing.assert_allclose(ep.transform(x_new, mask=np.ones_like(x_new)),
                               ep.transform(x_new), rtol=1e-4, atol=ATOL)


def test_nmf_transform_with_explicit_h0_and_inverse():
    x, _, h = _problem()
    ej, ep = _estimators()
    ej.fit(x)
    ep.fit(x)
    hj, hp = np.asarray(ej.transform(x, h0=h)), ep.transform(x, h0=h)
    np.testing.assert_allclose(hp, hj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ep.inverse_transform(hp), np.asarray(ej.inverse_transform(hj)),
                               rtol=RTOL, atol=ATOL)
    assert ep.inverse_transform(hp).tobytes() == (ep.w_ @ hp).tobytes()


def test_nmf_normalized_factors_keep_the_product():
    x, _, _ = _problem()
    ep = pt.NMF(n_components=5, max_iter=30, device="cpu").fit(x)
    wn, hn = pt.normalize_factors(ep.w_, ep.components_)
    np.testing.assert_allclose(wn @ hn, ep.w_ @ ep.components_, rtol=1e-6)
    np.testing.assert_allclose(wn.sum(axis=0), 1.0, rtol=1e-6)


def test_nmf_get_set_params_round_trip():
    ep = pt.NMF(n_components=4, solver="cd", beta_loss=2.0, device="cpu", alpha_W=0.1)
    params = ep.get_params()
    assert params["device"] == "cpu" and params["solver"] == "hals"
    assert set(params) == set(jt.NMF(4).get_params()) | {"device"}
    twin = pt.NMF(**params)
    assert twin.get_params() == params
    twin.set_params(solver="cd", max_iter=7, device="cuda")
    assert (twin.solver, twin.max_iter, twin.device) == ("hals", 7, "cuda")
    with pytest.raises(ValueError, match="invalid parameter"):
        twin.set_params(bogus=1)


def test_nmf_sklearn_clone():
    sklearn_base = pytest.importorskip("sklearn.base")
    ep = pt.NMF(n_components=3, beta_loss=2.0, solver="cd", device="cpu")
    twin = sklearn_base.clone(ep)
    assert twin.get_params() == ep.get_params() and twin is not ep
    tags = ep.__sklearn_tags__()
    assert tags.input_tags.positive_only


@pytest.mark.parametrize(
    "kw,call,err,match",
    [
        (dict(n_restarts=3, mesh=object()), "fit", NotImplementedError, "step 12b"),
        (dict(n_restarts=3), "fit_w0", ValueError, "cannot honor explicit"),
        (dict(mesh=object()), "fit", TypeError, "make_mesh"),
        (dict(beta_loss=2.0), "mask", NotImplementedError, "KL \\(beta=1\\) MU family"),
        (dict(), "transform_unfitted", RuntimeError, "before fit"),
        (dict(), "inverse_unfitted", RuntimeError, "before fit"),
    ],
    ids=["restarts", "restarts_with_w0", "mesh", "mask", "transform_unfitted", "inverse_unfitted"],
)
def test_nmf_refusals(kw, call, err, match):
    """What ``NMF`` refuses.  ``transform(mask=...)``, refused when this test
    was named, is ported: a masked transform of the Euclidean family is
    refused as ``nmf_tpu`` refuses it (the masked solve is KL MU).
    ``n_restarts > 1`` is ported too (``test_nmf_restarts_match_nmf_tpu``):
    with a mesh it is refused for the mesh (ROADMAP.md step 12b).  ``mesh``
    is ported (tests/test_torch_mesh.py): what is not a ``make_mesh``
    DeviceMesh is refused."""
    x, w, h = _problem()
    ep = pt.NMF(n_components=5, max_iter=3, device="cpu", **kw)
    with pytest.raises(err, match=match):
        if call == "fit":
            ep.fit(x)
        elif call == "fit_w0":
            ep.fit(x, w0=w, h0=h)
        elif call == "mask":
            ep.fit(x)
            ep.transform(x, mask=np.ones_like(x))
        elif call == "transform_unfitted":
            ep.transform(x)
        else:
            ep.inverse_transform(h)


def test_nmf_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    x, _, _ = _problem()
    with pytest.raises(RuntimeError, match="is_available"):
        pt.NMF(n_components=5, max_iter=3).fit(x)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_nmf_from_params_of_a_jax_fit(state):
    """A dictionary learned by ``nmf_tpu.NMF`` serves ``transform`` in the
    port: the same parameters, W and H, and the same transform."""
    x, _, _ = _problem()
    ej = jt.NMF(n_components=5, max_iter=40, precision=jt.Precision(state_dtype=state),
                alpha_W=0.01).fit(x)
    ep = nmf_from_params(ej.get_params(), ej.w_, ej.components_, device="cpu")
    params = ep.get_params()
    assert params.pop("device") == "cpu"
    assert dataclasses.asdict(params.pop("precision")) == dataclasses.asdict(ej.precision)
    ref = ej.get_params()
    ref.pop("precision")
    assert params == ref
    assert ep.w_.tobytes() == np.asarray(ej.w_, np.float32).tobytes()
    x_new = np.random.RandomState(1).rand(48, 17).astype(np.float32)
    hj, hp = np.asarray(ej.transform(x_new, max_iter=30), np.float32), ep.transform(x_new, max_iter=30)
    if state == "bfloat16":
        assert np.linalg.norm(hp - hj) <= BF16_FRO * np.linalg.norm(hj)
    else:
        np.testing.assert_allclose(hp, hj, rtol=RTOL, atol=ATOL)


def test_nmf_from_params_refuses_a_mesh():
    """A JAX mesh does not cross to the port (the port's DeviceMesh does)."""
    with pytest.raises(TypeError, match="make_mesh"):
        nmf_from_params({**jt.NMF(3).get_params(), "mesh": object()}, np.ones((4, 3)),
                        np.ones((3, 5)), device="cpu")


def test_h_only_step_cost_routes():
    """KL takes K1 and K3 under ``auto``/``pallas``, plain ops under
    ``jnp``; the cost's precision is f32 whatever the policy."""
    step, cost = tnmf._h_only_step_cost(pt.SolveConfig(
        precision=pt.Precision(matmul_dtype="bfloat16")))
    x, w, h = (torch.from_numpy(a) for a in _problem())
    (_, h1), c = step(w, h, x), cost(x, w, h)
    assert torch.equal(h1, tfm.update_h_fused(w, h, x, precision=pt.Precision("bfloat16")))
    assert torch.equal(c, pt.kl_divergence(x, w, h))


@pytest.mark.parametrize("init", ["random", "scaled", "nndsvdar"])
def test_nmf_restarts_match_nmf_tpu(init):
    """``NMF(n_restarts > 1)`` runs the restarts as one batched solve and
    keeps the lowest-cost member, as ``nmf_tpu.NMF`` (``nmf.py:416-463``):
    the same member, its factors within RTOL / ATOL, ``reconstruction_err_``
    within COST_RTOL, ``n_iter_`` equal."""
    x, _, _ = _problem()
    kw = dict(n_components=4, n_restarts=3, max_iter=30, init=init, random_state=2)
    ours = pt.NMF(device="cpu", **kw).fit(x)
    ref = jt.NMF(**kw).fit(x)
    np.testing.assert_allclose(ours.w_, np.asarray(ref.w_), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.components_, np.asarray(ref.components_), rtol=RTOL, atol=ATOL)
    assert ours.reconstruction_err_ == pytest.approx(ref.reconstruction_err_, rel=COST_RTOL)
    assert ours.n_iter_ == ref.n_iter_ == 30
    sel = pt.solve_restarts(x, rank=4, n_restarts=3, seed=2, init=init, device="cpu",
                            config=ours._config(shape=x.shape))
    assert ours.w_.tobytes() == sel.best[0].numpy().tobytes()


def test_nmf_restarts_warn_on_a_deterministic_init():
    """The default nndsvda would make identical members: 'scaled' is taken,
    with nmf_tpu's warning."""
    x, _, _ = _problem()
    with pytest.warns(UserWarning, match="deterministic"):
        ours = pt.NMF(n_components=4, n_restarts=2, max_iter=5, device="cpu").fit(x)
    with pytest.warns(UserWarning, match="deterministic"):
        ref = jt.NMF(n_components=4, n_restarts=2, max_iter=5).fit(x)
    np.testing.assert_allclose(ours.w_, np.asarray(ref.w_), rtol=RTOL, atol=ATOL)


def test_nmf_restarts_with_penalties_score_the_pure_divergence():
    """With regularization the kept member's ``reconstruction_err_`` is the
    pure divergence, taken again from its factors, as in nmf_tpu."""
    x, _, _ = _problem()
    kw = dict(n_components=4, n_restarts=2, max_iter=20, init="random", alpha_W=0.01,
              l1_ratio=0.5)
    ours = pt.NMF(device="cpu", **kw).fit(x)
    ref = jt.NMF(**kw).fit(x)
    assert ours.reconstruction_err_ == pytest.approx(ref.reconstruction_err_, rel=COST_RTOL)
