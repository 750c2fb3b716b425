"""The port's ``transform_out_of_core`` against ``nmf_tpu`` on the CPU.

X streams in column blocks (the last one ragged) from an array or a
``.bin`` file, as f32, bf16 or int8 X, each block solved in full by the
H-only solve, from an explicit ``h0`` or from the per-block seeded start
``RandomState(seed + i)``.  The same inputs, made from a seed with NumPy, go
through both packages (``torch.set_num_threads(1)``).

What must agree exactly: ``blocks``, ``iterations`` and ``converged``.
Tolerances, as tests/test_torch_nmf.py holds the in-memory H-only solve:
H rtol 1e-4 / atol 1e-6, ``block_costs`` and ``cost`` rel 1e-5 (measured:
H <= 3.9e-6 relative, costs <= 4.6e-7); HALS H by relative Frobenius norm
1e-4.
Against the port's own in-memory ``solve_h_only`` on the same ``h0`` the
blocks solve the same columns with the same step, so H agrees to the same
tolerance and the block costs sum to the in-memory cost within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict  # noqa: E402

COST_RTOL, RTOL, ATOL, FRO = 1e-5, 1e-4, 1e-6, 1e-4
M, K, N, BLOCK = 40, 4, 50, 16        # blocks of 16, 16, 16 and 2 columns


def _problem(seed=21):
    rng = np.random.RandomState(seed)
    return (rng.rand(M, N).astype(np.float32), rng.rand(M, K).astype(np.float32),
            rng.rand(K, N).astype(np.float32))


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _source(kind, x, tmp_path):
    if kind == "bin":
        path = tmp_path / "X.bin"
        jbin.write_matrix(x, path)
        return str(path)
    return x


def _assert_match(tj, tp, hals=False):
    assert tp.blocks == [tuple(b) for b in tj.blocks]
    np.testing.assert_array_equal(tp.iterations, tj.iterations)
    np.testing.assert_array_equal(tp.converged, tj.converged)
    assert tp.iterations.dtype == np.int32 and tp.converged.dtype == np.bool_
    assert isinstance(tp.h, np.ndarray) and tp.h.dtype == np.float32
    assert tp.h.shape == np.asarray(tj.h).shape
    if hals:
        assert np.linalg.norm(tp.h - tj.h) <= FRO * np.linalg.norm(tj.h)
    else:
        np.testing.assert_allclose(tp.h, tj.h, rtol=RTOL, atol=ATOL)
    assert tp.block_costs.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(tp.block_costs), np.isnan(tj.block_costs))
    np.testing.assert_allclose(tp.block_costs, tj.block_costs, rtol=COST_RTOL)
    if np.isnan(tj.cost):
        assert np.isnan(tp.cost)
    else:
        assert tp.cost == pytest.approx(tj.cost, rel=COST_RTOL)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "seeded"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["array", "bin"])
def test_transform_matches_jax(tmp_path, kind, x_dtype, with_h0):
    x, w, h = _problem()
    jcfg = jt.SolveConfig(max_iter=30, check_every=10, precision=jt.Precision(x_dtype=x_dtype))
    src = _source(kind, x, tmp_path)
    h0 = h if with_h0 else None
    tj = jt.transform_out_of_core(src, w, h0=h0, config=jcfg, block_n=BLOCK, seed=4)
    tp = pt.transform_out_of_core(src, w, h0=h0, config=_pcfg(jcfg), block_n=BLOCK, seed=4,
                                  device="cpu")
    assert tp.blocks == [(0, 16), (16, 32), (32, 48), (48, 50)]
    _assert_match(tj, tp)


FAMILIES = {
    "beta2": dict(beta=2.0),
    "beta0.5": dict(beta=0.5),
    "hals": dict(beta=2.0, algorithm="hals"),
    "kl_reg": dict(l1_h=0.2, l2_h=0.1),
    "accelerate": dict(accelerate=True),
    "bf16_state": dict(precision=jt.Precision(state_dtype="bfloat16")),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_transform_families_match_jax(family):
    x, w, _ = _problem()
    jcfg = jt.SolveConfig(max_iter=30, check_every=10, **FAMILIES[family])
    tj = jt.transform_out_of_core(x, w, config=jcfg, block_n=BLOCK)
    tp = pt.transform_out_of_core(x, w, config=_pcfg(jcfg), block_n=BLOCK, device="cpu")
    if family == "bf16_state":
        assert tp.blocks == [tuple(b) for b in tj.blocks]
        np.testing.assert_array_equal(tp.iterations, tj.iterations)
        assert np.linalg.norm(tp.h - tj.h) <= 5e-2 * np.linalg.norm(tj.h)
        assert tp.cost == pytest.approx(tj.cost, rel=1e-3)
    else:
        _assert_match(tj, tp, hals=family == "hals")


def test_transform_converges_per_block_like_jax():
    """A threshold stops each block on its own: the same iterations and
    convergence flags per block."""
    x, w, _ = _problem()
    jcfg = jt.SolveConfig(max_iter=400, check_every=5, thresh=1e-4)
    tj = jt.transform_out_of_core(x, w, config=jcfg, block_n=BLOCK)
    tp = pt.transform_out_of_core(x, w, config=_pcfg(jcfg), block_n=BLOCK, device="cpu")
    assert tp.converged.any() and (tp.iterations < 400).any()
    _assert_match(tj, tp)


def test_transform_without_cost_tracking_has_a_nan_cost():
    x, w, _ = _problem()
    jcfg = jt.SolveConfig(max_iter=10, track_cost=False)
    tj = jt.transform_out_of_core(x, w, config=jcfg, block_n=BLOCK)
    tp = pt.transform_out_of_core(x, w, config=_pcfg(jcfg), block_n=BLOCK, device="cpu")
    assert np.isnan(tp.cost) and np.isnan(tp.block_costs).all()
    _assert_match(tj, tp)


def test_transform_default_block_is_the_whole_matrix_here():
    """Without ``block_n`` the block is ~256 MiB of f32 (``pick_block_n``):
    one block at this size, as in JAX."""
    x, w, h = _problem()
    jcfg = jt.SolveConfig(max_iter=20, check_every=10)
    tj = jt.transform_out_of_core(x, w, h0=h, config=jcfg)
    tp = pt.transform_out_of_core(x, w, h0=h, config=_pcfg(jcfg), device="cpu")
    assert tp.blocks == [(0, N)]
    _assert_match(tj, tp)


@pytest.mark.parametrize("x_dtype", ["float32", "int8"])
def test_transform_equals_the_in_memory_h_only_solve(x_dtype):
    """Each block runs the in-memory H-only solve on its columns: with the
    same explicit ``h0``, H within the solve tolerances and the block costs
    summed within 1e-5 of the in-memory cost (per-column int8 scales are
    per block what they are whole)."""
    x, w, h = _problem()
    cfg = pt.SolveConfig(max_iter=40, check_every=10, precision=pt.Precision(x_dtype=x_dtype))
    tp = pt.transform_out_of_core(x, w, h0=h, config=cfg, block_n=BLOCK, device="cpu")
    rp = pt.solve_h_only(x, w, h, cfg, device="cpu")
    np.testing.assert_allclose(tp.h, rp.h.numpy(), rtol=RTOL, atol=ATOL)
    assert tp.cost == pytest.approx(float(rp.cost), rel=COST_RTOL)
    assert float(np.sum(tp.block_costs, dtype=np.float64)) == pytest.approx(tp.cost, rel=1e-7)


def test_transform_calls_k1_and_k3_per_block():
    """The KL transform: K1 once an iteration of each block, K3 once a check
    of each block (f32 recon), K2 never; a family calls none."""
    x, w, _ = _problem()
    names = ("update_h_fused", "update_w_fused", "kl_cost_fused")

    def counted(cfg):
        calls = dict.fromkeys(names, 0)
        originals = {name: getattr(tfm, name) for name in names}

        def counting(name):
            def call(*args, **kw):
                calls[name] += 1
                return originals[name](*args, **kw)
            return call

        for name in names:
            setattr(tfm, name, counting(name))
        try:
            pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK, device="cpu")
        finally:
            for name, f in originals.items():
                setattr(tfm, name, f)
        return calls

    assert counted(pt.SolveConfig(max_iter=50, check_every=25)) == {
        "update_h_fused": 4 * 50, "update_w_fused": 0, "kl_cost_fused": 4 * 2}
    assert counted(pt.SolveConfig(max_iter=50, check_every=25, beta=2.0)) == dict.fromkeys(names, 0)


def test_nmf_transform_out_of_core_matches_jax(tmp_path):
    """``NMF.transform(out_of_core=True)`` streams from a ``.bin`` path, its
    blocks seeded from ``random_state``; the regularization scales with the
    global dims."""
    x, _, _ = _problem()
    ej = jt.NMF(n_components=K, max_iter=30, alpha_W=0.01).fit(x)
    ep = pt.NMF(n_components=K, max_iter=30, alpha_W=0.01, device="cpu").fit(x)
    path = _source("bin", np.random.RandomState(9).rand(M, 37).astype(np.float32), tmp_path)
    hj = np.asarray(ej.transform(path, out_of_core=True))
    hp = ep.transform(path, out_of_core=True)
    assert hp.shape == (K, 37)
    np.testing.assert_allclose(hp, hj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "kw,err,match",
    [
        (dict(mask=np.ones((M, N), np.float32), config=pt.SolveConfig(beta=2.0)),
         NotImplementedError, "KL \\(beta=1\\) MU family"),
        (dict(mesh=object()), TypeError, "make_mesh"),
        (dict(config=pt.SolveConfig(backend="pallas",
                                    precision=pt.Precision(x_dtype="int8", x_quant_rows=8))),
         NotImplementedError, "per-row-block"),
        (dict(config=pt.SolveConfig(backend="autotune")), NotImplementedError, "autotune"),
        (dict(h0=np.ones((K, N + 1), np.float32)), ValueError, "h0"),
        (dict(block_n=0), ValueError, "block_n"),
        (dict(w=np.ones((M + 1, K), np.float32)), ValueError, "does not match"),
    ],
    ids=["mask", "mesh", "pallas_rows", "autotune", "h0_shape", "block_n", "w_shape"],
)
def test_transform_refusals(kw, err, match):
    """What the streamed transform refuses.  ``mask``, refused when this test
    was named, is ported: a masked transform of the Euclidean family is
    refused with ``nmf_tpu``'s message.  ``backend="autotune"``, refused
    when this test was named, runs: on the CPU each block width resolves to
    the wrappers' plain versions, the bits of ``auto``."""
    x, w, _ = _problem()
    if match == "autotune":
        cfg = dict(max_iter=20, check_every=10)
        res = pt.transform_out_of_core(x, w, config=pt.SolveConfig(**cfg, backend="autotune"),
                                       block_n=BLOCK, device="cpu")
        auto = pt.transform_out_of_core(x, w, config=pt.SolveConfig(**cfg), block_n=BLOCK,
                                        device="cpu")
        assert res.h.tobytes() == auto.h.tobytes() and res.cost == auto.cost
        return
    kw = {"w": w, **kw}
    with pytest.raises(err, match=match):
        pt.transform_out_of_core(x, kw.pop("w"), device="cpu", **kw)


def test_transform_drops_live_metrics_as_jax_does():
    """Per-block restarts of the counter are noise: ``live_metrics`` is
    dropped, not refused."""
    x, w, _ = _problem()
    tp = pt.transform_out_of_core(x, w, config=pt.SolveConfig(max_iter=5, live_metrics=True),
                                  block_n=BLOCK, device="cpu")
    assert tp.h.shape == (K, N)


def test_chip_smoke_lists_transform_launches():
    """Phase 12's runs give K1-K3 their ``transform_launches`` (K2's all
    0); phase 11 runs every family the card must hold to the CPU."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = {
        "float32": {"update_h": 200, "update_w": 200, "kl_cost": 8},
        "accel reference": {"update_h": 225, "update_w": 225, "kl_cost": 10},
        "transform h_only bfloat16": {"update_h": 200, "update_w": 0, "kl_cost": 8},
        "transform out_of_core int8": {"update_h": 500, "update_w": 0, "kl_cost": 20},
    }
    assert smoke._transform_launches(launches, "update_h") == {
        "h_only bfloat16": 200, "out_of_core int8": 500}
    assert smoke._transform_launches(launches, "update_w") == {
        "h_only bfloat16": 0, "out_of_core int8": 0}
    assert smoke._transform_launches(launches, "kl_cost") == {
        "h_only bfloat16": 8, "out_of_core int8": 20}
    runs = {tuple(sorted(f.items())) for f in smoke.FAMILY_RUNS.values()}
    for fields in (dict(beta=2.0), dict(beta=0.0), dict(beta=0.5), dict(beta=3.0),
                   dict(beta=2.0, algorithm="hals"), dict(l1_h=0.1, l2_w=0.1),
                   dict(beta=2.0, accelerate=True),
                   dict(beta=2.0, algorithm="hals", accelerate=True)):
        assert tuple(sorted(fields.items())) in runs
