"""The port's online learner (``nmf_tpu_torch.models.online``) against
``nmf_tpu.models.online`` on the CPU.

The same inputs, made from a seed with NumPy, go through both packages
(``torch.set_num_threads(1)``): a planted low-rank X (tests/test_online.py's,
at a smaller size), streamed in blocks with a ragged last one, from an
array or a ``.bin`` file, as f32, bf16 or int8 X.  The cases mirror
tests/test_online.py that need no mesh.

Tolerances between the two packages: W rtol 1e-5 / atol 1e-6, the learning
curve rel 1e-5; W rtol 1e-4 where 15 or more W steps compound the f32
rounding (three passes of 5 blocks: measured 1.8e-5; 36 blocks of 7
columns: 1.0e-5), the solve's of tests/test_torch_solver.py; bf16 GEMMs or
state: relative Frobenius norm 5e-2 and curve rel 1e-3, as
tests/test_torch_accel.py holds bf16 state.  Plain torch ops on
every device, as in JAX: the kernel wrappers are never called.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import online as to  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, result_to_numpy  # noqa: E402

RTOL, ATOL, CURVE_RTOL, LONG_RTOL = 1e-5, 1e-6, 1e-5, 1e-4
BF16_FRO, BF16_CURVE_RTOL = 5e-2, 1e-3
M, K, N, BLOCK = 48, 4, 250, 60        # blocks of 60 x 4 and one of 10


@pytest.fixture(scope="module")
def planted():
    rng = np.random.RandomState(5)
    wt = rng.rand(M, K).astype(np.float32)
    ht = rng.rand(K, N).astype(np.float32)
    x = (wt @ ht + 0.02 * rng.rand(M, N)).astype(np.float32)
    return x, rng.rand(M, K).astype(np.float32)


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _both(x, w0, jcfg, **kw):
    kw = {"block_n": BLOCK, "inner_iters": 10, **kw}
    oj = jt.solve_online(x, w0, jcfg, **kw)
    op = pt.solve_online(x, w0, _pcfg(jcfg), device="cpu", **kw)
    return op, oj


def _assert_match(op, oj, bf16=False, rtol=RTOL):
    rp, rj = result_to_numpy(op), result_to_numpy(oj)
    assert rp["blocks"] == rj["blocks"] and rp["passes"] == rj["passes"]
    assert [len(p) for p in rp["block_costs"]] == [len(p) for p in rj["block_costs"]]
    assert op.w.dtype == np.float32 and isinstance(op.w, np.ndarray)
    if bf16:
        assert np.linalg.norm(op.w - oj.w) <= BF16_FRO * np.linalg.norm(oj.w)
    else:
        np.testing.assert_allclose(op.w, oj.w, rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(rp["learning_curve"], rj["learning_curve"],
                               rtol=BF16_CURVE_RTOL if bf16 else CURVE_RTOL)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(passes=2), dict(rho=0.7), dict(passes=3, rho=0.9, seed=4),
     dict(inner_iters=1), dict(block_n=N), dict(block_n=7)],
    ids=["one_pass", "two_passes", "rho", "passes_rho_seed", "one_inner", "one_block", "ragged"],
)
def test_online_matches_jax(planted, kw):
    x, w0 = planted
    op, oj = _both(x, w0, jt.SolveConfig(), **kw)
    w_steps = len(op.blocks) * op.passes
    _assert_match(op, oj, rtol=LONG_RTOL if w_steps >= 15 else RTOL)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["array", "bin"])
def test_online_x_dtypes_and_sources_match_jax(planted, tmp_path, kind, x_dtype):
    x, w0 = planted
    src = x
    if kind == "bin":
        src = str(tmp_path / "X.bin")
        jbin.write_matrix(x, src)
    jcfg = jt.SolveConfig(precision=jt.Precision(x_dtype=x_dtype))
    _assert_match(*_both(src, w0, jcfg, passes=2))


@pytest.mark.parametrize(
    "prec",
    [dict(matmul_dtype="bfloat16"), dict(state_dtype="bfloat16"),
     dict(x_dtype="int8", x_quant_rows=16)],
    ids=["bf16_gemm", "bf16_state", "int8_rows"],
)
def test_online_policies_match_jax(planted, prec):
    x, w0 = planted
    jcfg = jt.SolveConfig(precision=jt.Precision(**prec))
    _assert_match(*_both(x, w0, jcfg), bf16="bfloat16" in prec.values())


def test_online_without_cost_tracking_matches_jax(planted):
    x, w0 = planted
    op, oj = _both(x, w0, jt.SolveConfig(track_cost=False), passes=2)
    assert op.block_costs == [[], []] == oj.block_costs
    assert op.learning_curve.shape == (0,)
    np.testing.assert_allclose(op.w, oj.w, rtol=RTOL, atol=ATOL)


def test_online_learning_curve_improves_across_passes(planted):
    x, w0 = planted
    res = pt.solve_online(x, w0, pt.SolveConfig(), block_n=BLOCK, inner_iters=15, passes=2,
                          device="cpu")
    assert res.passes == 2 and len(res.block_costs) == 2
    assert sum(res.block_costs[1]) < sum(res.block_costs[0])
    assert res.learning_curve.shape == (2 * len(res.blocks),)


def test_online_bin_source_is_the_array_bit_for_bit(planted, tmp_path):
    x, w0 = planted
    path = str(tmp_path / "X.bin")
    jbin.write_matrix(x, path)
    a = pt.solve_online(x, w0, block_n=BLOCK, inner_iters=5, seed=3, device="cpu")
    b = pt.solve_online(path, w0, block_n=BLOCK, inner_iters=5, seed=3, device="cpu")
    assert a.w.tobytes() == b.w.tobytes() and a.block_costs == b.block_costs


def test_online_learns_a_dictionary_close_to_batch():
    """The streamed dictionary closes most of the init-to-batch gap of the
    H-only refit cost (tests/test_online.py's quality check, on its
    problem: 96 x 1200, K=8)."""
    rng = np.random.RandomState(5)
    m, k, n = 96, 8, 1200
    x = (rng.rand(m, k).astype(np.float32) @ rng.rand(k, n).astype(np.float32)
         + 0.02 * rng.rand(m, n)).astype(np.float32)
    w0 = rng.rand(m, k).astype(np.float32)

    def refit(w):
        h0 = np.random.RandomState(9).rand(k, n).astype(np.float32)
        return float(pt.solve_h_only(x, w, h0, pt.SolveConfig(max_iter=80, check_every=80),
                                     device="cpu").cost)

    res = pt.solve_online(x, w0, block_n=200, inner_iters=25, passes=3, seed=1, device="cpu")
    h0 = np.random.RandomState(2).rand(k, n).astype(np.float32)
    batch = pt.solve(x, w0, h0, pt.SolveConfig(max_iter=75, check_every=75), device="cpu")
    online_q, batch_q = refit(res.w), refit(batch.w.numpy())
    init_q = refit(np.maximum(w0, np.float32(2.2204e-16)))
    assert online_q < init_q
    assert (online_q - batch_q) / (init_q - batch_q) < 0.35


def test_online_runs_no_kernel_wrapper(planted, monkeypatch):
    for name in ("update_h_fused", "update_w_fused", "kl_cost_fused"):
        def refuse(*a, _n=name, **k):
            raise AssertionError(f"{_n} called by the online learner")
        monkeypatch.setattr(tfm, name, refuse)
    x, w0 = planted
    pt.solve_online(x, w0, block_n=BLOCK, inner_iters=2, device="cpu")


def _messages(ours, ref, exc):
    with pytest.raises(exc) as e_ours:
        ours()
    with pytest.raises(exc) as e_ref:
        ref()
    return str(e_ours.value), str(e_ref.value)


@pytest.mark.parametrize(
    "cfg,kw,exc",
    [(dict(beta=2.0), {}, NotImplementedError),
     (dict(l1_h=0.1), {}, NotImplementedError),
     (dict(backend="pallas"), {}, NotImplementedError),
     (dict(live_metrics=True), {}, NotImplementedError),
     (dict(accelerate=True), {}, NotImplementedError),
     ({}, dict(rho=0.0), ValueError),
     ({}, dict(rho=1.5), ValueError),
     ({}, dict(inner_iters=0), ValueError),
     ({}, dict(passes=0), ValueError),
     ({}, dict(w_rows=M - 1), ValueError)],
    ids=["beta", "penalty", "pallas", "live", "accelerate", "rho0", "rho_big", "inner0",
         "passes0", "w_shape"],
)
def test_refusals_match_jax(planted, cfg, kw, exc):
    x, w0 = planted
    kw = dict(kw)
    if "w_rows" in kw:
        w0 = w0[: kw.pop("w_rows")]
    jcfg = jt.SolveConfig(**cfg)
    ours, ref = _messages(lambda: pt.solve_online(x, w0, _pcfg(jcfg), device="cpu", **kw),
                          lambda: jt.solve_online(x, w0, jcfg, **kw), exc)
    assert ours == ref


def test_mesh_refused(planted):
    """A mesh is ported (tests/test_torch_mesh_paths.py): what is not a
    ``make_mesh`` DeviceMesh is refused."""
    x, w0 = planted
    with pytest.raises(TypeError, match="make_mesh"):
        pt.solve_online(x, w0, mesh=object(), device="cpu")


def test_cuda_request_without_a_card_raises(planted):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    x, w0 = planted
    with pytest.raises(RuntimeError, match="is_available"):
        pt.solve_online(x, w0, block_n=BLOCK)


def test_public_names():
    assert pt.solve_online is to.solve_online and pt.OnlineResult is to.OnlineResult
    assert {"solve_online", "OnlineResult"} <= set(pt.__all__)
