"""The port's masked (missing-data) NMF (``nmf_tpu_torch.models.masked``)
against ``nmf_tpu.models.masked`` on the CPU: one step, the cost,
``solve_masked`` and ``solve_masked_h_only``.

The same inputs, made from a seed with NumPy, go through both packages
(``torch.set_num_threads(1)``); the cases mirror the masked ones of
tests/test_extensions.py.  Plain torch ops on every device, as JAX takes its
jnp path: neither package has a kernel for the mask GEMMs, and the kernel
wrappers are never called.

Tolerances between the two packages: one step rtol 1e-5 (``float32_fast``
3e-5, as tests/test_torch_families.py holds one step: the port spells out
the 3-pass split); solves of 20 iterations factors rtol 1e-5 / atol 1e-6
and costs rel 1e-5 (``float32_fast`` and ``accelerate`` factors rtol 1e-4,
the solve's of tests/test_torch_solver.py); bf16 state or GEMMs costs rel
1e-3 and factors by relative Frobenius norm 5e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import masked as jm  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import masked as tm  # noqa: E402
from nmf_tpu_torch.ops import mu as tmu  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.config import Precision as TPrecision  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict  # noqa: E402

EPS = float(np.float32(2.2204e-16))
STEP_RTOL = {"float32": 1e-5, "bfloat16": 1e-5, "float32_fast": 3e-5}
RTOL, ATOL, COST_RTOL, DRIFT_RTOL = 1e-5, 1e-6, 1e-5, 1e-4
BF16_FRO, BF16_COST_RTOL = 5e-2, 1e-3
M, K, N = 48, 5, 40


def _problem(seed=6, missing=0.2):
    rng = np.random.RandomState(seed)
    x = rng.rand(M, N).astype(np.float32) + 1e-3
    w = rng.rand(M, K).astype(np.float32) + 1e-3
    h = rng.rand(K, N).astype(np.float32) + 1e-3
    mask = (rng.rand(M, N) >= missing).astype(np.float32)
    return x, w, h, mask


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_match(rp, rj, bf16=False, rtol=RTOL, fields=("w", "h")):
    for f in ("iterations", "num_checks", "converged"):
        assert int(getattr(rp, f)) == int(getattr(rj, f)), f
    for f in fields:
        ours, ref = _np(getattr(rp, f)), _np(getattr(rj, f))
        if bf16:
            assert np.linalg.norm(ours - ref) <= BF16_FRO * np.linalg.norm(ref), f
        else:
            np.testing.assert_allclose(ours, ref, rtol=rtol, atol=ATOL, err_msg=f)
    n = int(rj.num_checks)
    np.testing.assert_allclose(_np(rp.cost_history)[:n], np.asarray(rj.cost_history)[:n],
                               rtol=BF16_COST_RTOL if bf16 else COST_RTOL)


PENALTIES = {"none": {}, "all": dict(l1_w=0.1, l1_h=0.2, l2_w=0.3, l2_h=0.05)}


@pytest.mark.parametrize("pens", list(PENALTIES))
@pytest.mark.parametrize("policy", list(STEP_RTOL))
def test_mu_step_masked_matches_jax(policy, pens):
    x, w, h, mask = _problem()
    jw, jh = jm.mu_step_masked(w, h, x, mask, EPS, jt.Precision(policy), **PENALTIES[pens])
    tw, th = tm.mu_step_masked(*_t(w, h, x, mask), EPS, TPrecision(policy), **PENALTIES[pens])
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=STEP_RTOL[policy])
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=STEP_RTOL[policy])


def test_mask_of_ones_is_the_reference_step():
    """With M = 1 the masked step is the reference MU step (W^T 1 = colsum
    W, 1 H^T = rowsum H), to f32 rounding."""
    x, w, h, _ = _problem()
    tw, th = tm.mu_step_masked(*_t(w, h, x, np.ones_like(x)))
    rw, rh = tmu.mu_step(*_t(w, h, x))
    np.testing.assert_allclose(_np(tw), _np(rw), rtol=1e-5)
    np.testing.assert_allclose(_np(th), _np(rh), rtol=1e-5)


@pytest.mark.parametrize("pens", list(PENALTIES))
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_masked_kl_matches_jax(x_dtype, pens):
    x, w, h, mask = _problem()
    ref = float(jm.masked_kl(jnp.asarray(x, x_dtype), w, h, mask, EPS, **PENALTIES[pens]))
    xt = torch.from_numpy(x).to(torch.bfloat16 if x_dtype == "bfloat16" else torch.float32)
    ours = float(tm.masked_kl(xt, *_t(w, h, mask), EPS, **PENALTIES[pens]))
    assert ours == pytest.approx(ref, rel=COST_RTOL)


def test_masked_kl_of_zeros_takes_the_limit():
    """An observed x = 0 adds its +y (the x -> 0 limit), a masked one nothing."""
    x, w, h, mask = _problem()
    x[0, :5] = 0.0
    ref = float(jm.masked_kl(x, w, h, mask, EPS))
    ours = float(tm.masked_kl(*_t(x, w, h, mask), EPS))
    assert np.isfinite(ours) and ours == pytest.approx(ref, rel=COST_RTOL)


VARIANTS = {
    "kl": dict(),
    "penalized": dict(l1_w=0.1, l1_h=0.2, l2_w=0.05, l2_h=0.1),
    "int8_x": dict(precision=jt.Precision(x_dtype="int8")),
    "int8_rows": dict(precision=jt.Precision(x_dtype="int8", x_quant_rows=16)),
    "bf16_x": dict(precision=jt.Precision(x_dtype="bfloat16")),
    "bfloat16": dict(precision=jt.Precision("bfloat16")),
    "float32_fast": dict(precision=jt.Precision("float32_fast")),
    "bf16_state": dict(precision=jt.Precision(state_dtype="bfloat16")),
    "accelerate": dict(accelerate=True),
}


def _rtol(variant):
    return DRIFT_RTOL if variant in ("float32_fast", "accelerate") else RTOL


def _counted(fn):
    """(fn(), calls of the K1-K3 wrappers while it ran)."""
    names = ("update_h_fused", "update_w_fused", "kl_cost_fused")
    calls = dict.fromkeys(names, 0)
    originals = {name: getattr(tfm, name) for name in names}
    for name in names:
        def call(*a, _n=name, **kw):
            calls[_n] += 1
            return originals[_n](*a, **kw)
        setattr(tfm, name, call)
    try:
        return fn(), calls
    finally:
        for name, f in originals.items():
            setattr(tfm, name, f)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_solve_masked_matches_jax(variant):
    """``solve_masked`` in each policy and family, NaN in the unobserved
    entries of X, against ``nmf_tpu.solve_masked``; no kernel wrapper."""
    x, w, h, mask = _problem()
    x[mask == 0] = np.nan
    jcfg = jt.SolveConfig(max_iter=20, check_every=5, **VARIANTS[variant])
    rj = jt.solve_masked(x, w, h, mask, jcfg)
    rp, calls = _counted(lambda: pt.solve_masked(x, w, h, mask, _pcfg(jcfg), device="cpu"))
    assert not any(calls.values()), calls
    _assert_match(rp, rj, bf16=variant in ("bfloat16", "bf16_state"), rtol=_rtol(variant))
    assert np.isfinite(_np(rp.w)).all() and np.isfinite(_np(rp.h)).all()


@pytest.mark.parametrize("variant", ["kl", "penalized", "int8_x", "bf16_x", "accelerate"])
def test_solve_masked_h_only_matches_jax(variant):
    x, w, h, mask = _problem(seed=9)
    x[mask == 0] = np.inf
    jcfg = jt.SolveConfig(max_iter=20, check_every=5, **VARIANTS[variant])
    rj = jt.solve_masked_h_only(x, w, h, mask, jcfg)
    rp = pt.solve_masked_h_only(x, w, h, mask, _pcfg(jcfg), device="cpu")
    _assert_match(rp, rj, rtol=_rtol(variant), fields=("h",))
    assert _np(rp.w).tobytes() == np.maximum(w, np.float32(EPS)).tobytes()


def test_weighted_mask_matches_jax():
    """Real-valued confidence weights, not only 0/1."""
    x, w, h, _ = _problem()
    weights = np.random.RandomState(2).rand(M, N).astype(np.float32) * 2.0
    jcfg = jt.SolveConfig(max_iter=20, check_every=5)
    _assert_match(pt.solve_masked(x, w, h, weights, _pcfg(jcfg), device="cpu"),
                  jt.solve_masked(x, w, h, weights, jcfg))


@pytest.mark.parametrize("garbage", [np.nan, np.inf, -np.inf, 1e30])
def test_garbage_in_masked_entries_is_ignored(garbage):
    """Anything in an unobserved entry gives the bits of the same solve on
    X with those entries zeroed (tests/test_extensions.py's invariant)."""
    x, w, h, mask = _problem()
    clean = np.where(mask > 0, x, 0.0).astype(np.float32)
    dirty = x.copy()
    dirty[mask == 0] = garbage
    cfg = pt.SolveConfig(max_iter=10, check_every=5)
    a = pt.solve_masked(dirty, w, h, mask, cfg, device="cpu")
    b = pt.solve_masked(clean, w, h, mask, cfg, device="cpu")
    for f in ("w", "h", "cost_history"):
        assert _np(getattr(a, f)).tobytes() == _np(getattr(b, f)).tobytes(), f


def test_mask_of_ones_matches_the_plain_solve():
    """With every entry observed the masked solve is the reference solve
    (the jnp ``solve``) to 1e-5."""
    x, w, h, _ = _problem()
    cfg = pt.SolveConfig(max_iter=20, check_every=5)
    a = pt.solve_masked(x, w, h, np.ones_like(x), cfg, device="cpu")
    b = pt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"), device="cpu")
    np.testing.assert_allclose(_np(a.w), _np(b.w), rtol=1e-5, atol=ATOL)
    assert float(a.cost) == pytest.approx(float(b.cost), rel=1e-5)


def test_masked_cost_monotone_and_rerun_bitwise():
    x, w, h, mask = _problem()
    cfg = pt.SolveConfig(max_iter=60, check_every=5)
    a = pt.solve_masked(x, w, h, mask, cfg, device="cpu")
    hist = _np(a.cost_history)[: int(a.num_checks)]
    assert np.all(np.diff(hist) <= 1e-6 * np.abs(hist[:-1])), hist
    b = pt.solve_masked(x, w, h, mask, cfg, device="cpu")
    assert _np(a.w).tobytes() == _np(b.w).tobytes()


def test_masked_h_only_is_the_h_half_of_the_masked_step():
    """One iteration of the masked H-only solve is the H half of
    ``mu_step_masked`` (tests/test_extensions.py)."""
    x, w, h, mask = _problem()
    res = pt.solve_masked_h_only(x, w, h, mask, pt.SolveConfig(max_iter=1, check_every=1),
                                 device="cpu")
    _, h1 = tm.mu_step_masked(*_t(w, h, x, mask))
    assert _np(res.h).tobytes() == _np(h1).tobytes()


def test_masked_recovers_missing_entries():
    """A planted low-rank X with 30% missing: the fit's reconstruction on
    the missing entries is close (tests/test_extensions.py)."""
    rng = np.random.RandomState(0)
    wt, ht = rng.rand(30, 3).astype(np.float32), rng.rand(3, 25).astype(np.float32)
    x = wt @ ht
    mask = (rng.rand(*x.shape) > 0.3).astype(np.float32)
    res = pt.solve_masked(x, rng.rand(30, 3), rng.rand(3, 25), mask,
                          pt.SolveConfig(max_iter=500, check_every=50), device="cpu")
    recon = _np(res.w) @ _np(res.h)
    miss = mask == 0
    assert np.mean(np.abs(recon[miss] - x[miss])) / np.mean(x[miss]) < 0.05


def _messages(ours, ref, exc):
    with pytest.raises(exc) as e_ours:
        ours()
    with pytest.raises(exc) as e_ref:
        ref()
    return str(e_ours.value), str(e_ref.value)


@pytest.mark.parametrize("fn", ["solve_masked", "solve_masked_h_only"])
@pytest.mark.parametrize(
    "case,exc",
    [("mask_shape", ValueError), ("w_shape", ValueError), ("beta", NotImplementedError),
     ("hals", NotImplementedError)],
)
def test_validation_matches_jax(fn, case, exc):
    x, w, h, mask = _problem()
    cfg = {}
    if case == "mask_shape":
        mask = mask[:, :-1]
    elif case == "w_shape":
        w = w[:-1]
    elif case == "beta":
        cfg = dict(beta=2.0)
    else:
        cfg = dict(beta=2.0, algorithm="hals")
    jcfg = jt.SolveConfig(max_iter=2, **cfg)
    ours, ref = _messages(lambda: getattr(pt, fn)(x, w, h, mask, _pcfg(jcfg), device="cpu"),
                          lambda: getattr(jt, fn)(x, w, h, mask, jcfg), exc)
    assert ours == ref


@pytest.mark.parametrize("fn", ["solve_masked", "solve_masked_h_only"])
def test_mesh_refused(fn):
    """``mesh``, refused when this test was named, runs: both masked solves
    on a mesh match ``nmf_tpu``'s in tests/test_torch_mesh.py.  What is not
    a ``make_mesh`` DeviceMesh is refused."""
    x, w, h, mask = _problem()
    with pytest.raises(TypeError, match="make_mesh"):
        getattr(pt, fn)(x, w, h, mask, mesh=object(), device="cpu")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    x, w, h, mask = _problem()
    with pytest.raises(RuntimeError, match="is_available"):
        pt.solve_masked(x, w, h, mask, pt.SolveConfig(max_iter=1))


def test_public_names():
    for name in ("solve_masked", "solve_masked_h_only"):
        assert getattr(pt, name) is getattr(tm, name) and name in pt.__all__
