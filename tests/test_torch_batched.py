"""The port's batched solves against ``nmf_tpu``'s on the CPU.

``solve_batched`` (the cases of ``tests/test_sharded.py``,
``tests/test_accel.py``, ``tests/test_quant.py`` and
``tests/test_quant_rowblocks.py`` that need no mesh) and
``solve_sparse_tiled_batched``: the same seeded NumPy inputs through both
packages.  Tolerances, as the JAX tests hold their batched solve to their
single one: factors rtol 5e-5 / atol 1e-7 and costs rel 1e-5 in the f32
GEMM modes (HALS: rtol 5e-4, atol 1e-5 of the largest entry); bf16 GEMMs
and bf16 state rtol 2e-2 / cost 1e-4 (``tests/test_torch_precision.py``:
flipped bf16 roundings compound over iterations); the accelerated loop
rtol 1e-4 / atol 1e-6 (``tests/test_torch_accel.py``: the extrapolation
amplifies last-ulp differences of tiny entries) and the tile-sparse solve
rtol 1e-4 / atol 2e-6 (``tests/test_torch_tile_sparse.py``).  Each member
of the port's batched solve is also held to the port's own 2-D solve of
that member bit for bit, as the member-axis kernels give it on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import sparse_tiled as jst  # noqa: E402
from nmf_tpu.parallel import batched as jb  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402

from oracle import clamp  # noqa: E402

B, M, K, N = 3, 48, 6, 40
F32 = dict(rtol=5e-5, atol=1e-7)
BF16 = dict(rtol=2e-2, atol=1e-6)
ACCEL = dict(rtol=1e-4, atol=1e-6)
TILED = dict(rtol=1e-4, atol=2e-6)

# kind -> (config fields, factor tolerance, cost rel)
KINDS = {
    "float32": (dict(), F32, 1e-5),
    "thresh": (dict(thresh=1e-3, check_every=2), F32, 1e-5),
    "no_cost": (dict(track_cost=False), F32, None),
    "accelerate": (dict(accelerate=True), ACCEL, 1e-5),
    "beta2": (dict(beta=2.0), F32, 1e-5),
    "beta_half": (dict(beta=0.5), F32, 1e-5),
    "hals": (dict(beta=2.0, algorithm="hals"), "hals", 1e-5),
    "penalized": (dict(l1_h=0.02, l2_w=0.01), F32, 1e-5),
    "x_int8": (dict(precision=("float32", "float32", "int8")), F32, 1e-5),
    "x_int8_rows16": (dict(precision=("float32", "float32", "int8", 16)), F32, 1e-5),
    "x_bfloat16": (dict(precision=("float32", "float32", "bfloat16")), F32, 1e-5),
    "float32_fast": (dict(precision=("float32_fast", "float32", "float32")), F32, 1e-5),
    "bfloat16": (dict(precision=("bfloat16", "float32", "float32")), BF16, 1e-4),
    "bf16_state": (dict(precision=("bfloat16", "bfloat16", "bfloat16")), BF16, 1e-4),
    "jnp": (dict(backend="jnp"), F32, 1e-5),
}


def _configs(kind, **over):
    fields = dict(max_iter=12, check_every=4)
    fields.update(KINDS[kind][0])
    fields.update(over)
    prec = fields.pop("precision", None)
    tc, jc = pt.SolveConfig(**fields), jt.SolveConfig(**fields)
    if prec is not None:
        tc = dataclasses.replace(tc, precision=pt.Precision(*prec))
        jc = dataclasses.replace(jc, precision=jt.Precision(*prec))
    return tc, jc


def _stack(seed, b=B, m=M, k=K, n=N, row_varying=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, m, n).astype(np.float32)
    if row_varying:   # rows of very different scale: row-block scales matter
        x *= np.logspace(0, 3, m, dtype=np.float32)[None, :, None]
    return (clamp(x), clamp(rng.rand(b, m, k).astype(np.float32)),
            clamp(rng.rand(b, k, n).astype(np.float32)))


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close_w(ours, ref, tol):
    ref = np.asarray(ref).astype(np.float32)
    if tol == "hals":
        tol = dict(rtol=5e-4, atol=1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(ours), ref, **tol)


@pytest.fixture(autouse=True)
def _zero_counts():
    tfm.reset_counts()
    yield
    tfm.reset_counts()


@pytest.mark.parametrize("kind", list(KINDS))
def test_solve_batched_matches_nmf_tpu(kind):
    """Every family, precision policy and loop of the batched solve against
    ``nmf_tpu.solve_batched``: factors, costs, history, per-member counts."""
    xs, ws, hs = _stack(11, row_varying=kind.startswith("x_int8"))
    tc, jc = _configs(kind)
    ours = pt.solve_batched(xs, ws, hs, tc, device="cpu")
    ref = jb.solve_batched(xs, ws, hs, jc)
    _, tol, cost_rel = KINDS[kind]
    assert ours.w.shape == (B, M, K) and ours.h.shape == (B, K, N)
    _close_w(ours.w, ref.w, tol)
    _close_w(ours.h, ref.h, tol)
    np.testing.assert_array_equal(ours.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours.num_checks.numpy(), np.asarray(ref.num_checks))
    np.testing.assert_array_equal(ours.converged.numpy(), np.asarray(ref.converged))
    if cost_rel is None:
        assert np.isnan(ours.cost.numpy()).all() and np.isnan(np.asarray(ref.cost)).all()
    else:
        np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost), rtol=cost_rel)
        np.testing.assert_allclose(ours.cost_history.numpy(), np.asarray(ref.cost_history),
                                   rtol=cost_rel)
    if kind == "accelerate":
        np.testing.assert_allclose(ours.momentum.numpy(), np.asarray(ref.momentum), rtol=1e-6)


@pytest.mark.parametrize("kind", ["float32", "thresh", "accelerate", "x_int8", "bf16_state",
                                  "hals", "jnp"])
def test_member_is_the_2d_solve(kind):
    """Member i of the batched solve has the bits of the port's 2-D solve of
    member i (``jnp``: the batched GEMMs against the 2-D ones, within F32)."""
    xs, ws, hs = _stack(5)
    tc, _ = _configs(kind)
    res = pt.solve_batched(xs, ws, hs, tc, device="cpu")
    for i in range(B):
        one = pt.solve(xs[i], ws[i], hs[i], tc, device="cpu")
        if kind == "jnp":
            _close_w(res.w[i], one.w.numpy(), F32)
            continue
        assert torch.equal(res.w[i], one.w) and torch.equal(res.h[i], one.h)
        assert torch.equal(res.cost[i], one.cost)
        assert int(res.iterations[i]) == int(one.iterations)


def test_members_stop_at_their_own_check():
    """thresh > 0: the members stop at different checks, a stopped one
    holding its state while the other runs on; each stops where its own
    solve does, as in ``nmf_tpu``."""
    rng = np.random.RandomState(13)
    easy = np.outer(rng.rand(M), rng.rand(N)).astype(np.float32)
    xs = np.stack([clamp(easy), clamp(rng.rand(M, N).astype(np.float32))])
    ws = clamp(rng.rand(2, M, K).astype(np.float32))
    hs = clamp(rng.rand(2, K, N).astype(np.float32))
    tc, jc = _configs("float32", max_iter=400, thresh=1e-4, check_every=10)
    ours = pt.solve_batched(xs, ws, hs, tc, device="cpu")
    ref = jb.solve_batched(xs, ws, hs, jc)
    its = ours.iterations.numpy()
    np.testing.assert_array_equal(its, np.asarray(ref.iterations))
    assert its[0] != its[1] and ours.converged.any()
    for i in range(2):
        one = pt.solve(xs[i], ws[i], hs[i], tc, device="cpu")
        assert int(one.iterations) == its[i] and bool(one.converged) == bool(ours.converged[i])
        assert torch.equal(ours.w[i], one.w)
        hist = ours.cost_history[i].numpy()
        assert np.isnan(hist[int(ours.num_checks[i]):]).all()


def test_thresh_zero_runs_every_member_to_max_iter():
    xs, ws, hs = _stack(2)
    tc, _ = _configs("float32", max_iter=9, check_every=4)
    res = pt.solve_batched(xs, ws, hs, tc, device="cpu")
    assert res.iterations.tolist() == [9] * B and res.num_checks.tolist() == [3] * B
    assert not res.converged.any()


def test_accelerated_members_decide_apart():
    """Per-member accept/reject (``tests/test_accel.py``'s batched case): a
    pinned momentum of 0.999 with a check every iteration makes rejects,
    each member's history never rises, and member 0 is its accelerated
    solve's bits, momentum included."""
    xs, ws, hs = _stack(0, b=2)
    tc, jc = _configs("accelerate", max_iter=30, check_every=1, accel_momentum=0.999,
                      accel_momentum_max=0.999, accel_grow=1.0)
    ours = pt.solve_batched(xs, ws, hs, tc, device="cpu")
    ref = jb.solve_batched(xs, ws, hs, jc)
    for i in range(2):
        hist = ours.cost_history[i].numpy()[: int(ours.num_checks[i])]
        assert (np.diff(hist) <= 1e-6 * np.abs(hist[:-1])).all()
        one = pt.solve(xs[i], ws[i], hs[i], tc, device="cpu")
        assert torch.equal(ours.w[i], one.w) and torch.equal(ours.momentum[i], one.momentum)
    assert float(ours.momentum.min()) < 0.999   # a reject shrank the momentum
    np.testing.assert_allclose(ours.momentum.numpy(), np.asarray(ref.momentum), rtol=1e-6)
    np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)


@pytest.mark.parametrize("kind", ["float32", "penalized", "x_bfloat16", "x_int8"])
def test_masked_batched_matches_nmf_tpu(kind):
    """``mask=``: each member sees only its own observed entries
    (``tests/test_sharded.py``'s masked cases), and the masked solve of
    each member; no kernel runs."""
    xs, ws, hs = _stack(22)
    masks = (np.random.RandomState(1).rand(B, M, N) > 0.25).astype(np.float32)
    tc, jc = _configs(kind)
    ours = pt.solve_batched(xs, ws, hs, tc, mask=masks, device="cpu")
    ref = jb.solve_batched(xs, ws, hs, jc, mask=masks)
    _close_w(ours.w, ref.w, F32)
    np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
    one = pt.solve_masked(xs[1], ws[1], hs[1], masks[1], tc, device="cpu")
    assert torch.equal(ours.w[1], one.w)


def test_masked_batched_ignores_garbage_holes():
    """NaN in the unobserved entries: the same bits as zeros there."""
    xs, ws, hs = _stack(14)
    masks = (np.random.RandomState(2).rand(B, M, N) > 0.3).astype(np.float32)
    tc, _ = _configs("float32")
    holes = np.where(masks > 0, xs, np.float32(np.nan))
    a = pt.solve_batched(holes, ws, hs, tc, mask=masks, device="cpu")
    b = pt.solve_batched(np.where(masks > 0, xs, 0.0), ws, hs, tc, mask=masks, device="cpu")
    assert torch.isfinite(a.w).all() and torch.equal(a.w, b.w)


def _refusal(call):
    """(type, message) of what a call raises."""
    with pytest.raises(Exception) as e:
        call()
    return type(e.value), str(e.value)


@pytest.mark.parametrize(
    "case",
    ["mask_shape", "masked_beta", "masked_hals", "pair", "not_3d", "batch_sizes", "shapes"],
)
def test_solve_batched_refuses_as_nmf_tpu(case):
    """Each refusal of ``nmf_tpu.solve_batched``, with its type and words."""
    xs, ws, hs = _stack(3, b=2)
    masks = np.ones_like(xs)
    cfg = dict(max_iter=2)
    args = {
        "mask_shape": ((xs, ws, hs), dict(mask=masks[:, :-1]), {}),
        "masked_beta": ((xs, ws, hs), dict(mask=masks), dict(beta=2.0)),
        "masked_hals": ((xs, ws, hs), dict(mask=masks), dict(beta=2.0, algorithm="hals")),
        "pair": (((np.zeros((2, 8, 16), np.uint8), np.zeros((2, 16), np.float32)),
                  np.ones((2, 8, 4), np.float32), np.ones((2, 4, 16), np.float32)), {}, {}),
        "not_3d": ((xs[0], ws[0], hs[0]), {}, {}),
        "batch_sizes": ((xs, ws[:1], hs), {}, {}),
        "shapes": ((xs, ws[:, :-1], hs), {}, {}),
    }[case]
    (x, w, h), kw, fields = args
    ours = _refusal(lambda: pt.solve_batched(x, w, h, pt.SolveConfig(**cfg, **fields),
                                             device="cpu", **kw))
    ref = _refusal(lambda: jb.solve_batched(x, w, h, jt.SolveConfig(**cfg, **fields), **kw))
    assert ours == ref


def test_solve_batched_refuses_a_mesh():
    """A mesh is ported (tests/test_torch_mesh_paths.py): what is not a
    ``make_mesh`` DeviceMesh (or a FlatMesh of one) is refused."""
    xs, ws, hs = _stack(3, b=2)
    with pytest.raises(TypeError, match="make_mesh"):
        pt.solve_batched(xs, ws, hs, mesh=object(), device="cpu")


def test_live_metrics_is_turned_off_not_refused():
    xs, ws, hs = _stack(4, b=2)
    tc, _ = _configs("float32")
    a = pt.solve_batched(xs, ws, hs, dataclasses.replace(tc, live_metrics=True), device="cpu")
    b = pt.solve_batched(xs, ws, hs, tc, device="cpu")
    assert torch.equal(a.w, b.w)


def test_solve_batched_needs_a_card_by_default():
    """Every entry point defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    xs, ws, hs = _stack(4, b=2)
    with pytest.raises(RuntimeError):
        pt.solve_batched(xs, ws, hs)


def test_inputs_are_not_written():
    xs, ws, hs = _stack(6, b=2)
    copies = [a.copy() for a in (xs, ws, hs)]
    pt.solve_batched(xs, ws, hs, pt.SolveConfig(max_iter=3), device="cpu")
    assert all(np.array_equal(a, c) for a, c in zip((xs, ws, hs), copies))


# --- the batched tile-sparse solve -----------------------------------------

def _tiled_members(b=2, m=160, n=200, k=5, seed=0):
    """Members of one shape whose occupied 32 x 32 tiles differ (so their
    tile lists are padded to a common count), X zero elsewhere."""
    rng = np.random.RandomState(seed)
    xs = []
    for i in range(b):
        x = np.zeros((m, n), np.float32)
        for _ in range(3 + 2 * i):
            r, c = rng.randint(0, m // 32) * 32, rng.randint(0, n // 32) * 32
            x[r:r + 32, c:c + 32] = rng.rand(32, 32)
        xs.append(x)
    return (xs, rng.rand(b, m, k).astype(np.float32) + 0.1,
            rng.rand(b, k, n).astype(np.float32) + 0.1)


@pytest.mark.parametrize("kind", ["float32", "thresh", "x_int8", "x_bfloat16", "accelerate"])
def test_sparse_tiled_batched_matches_nmf_tpu(kind):
    xs, ws, hs = _tiled_members()
    tc, jc = _configs(kind, max_iter=10, check_every=5)
    ours = pt.solve_sparse_tiled_batched(xs, ws, hs, tc, chunk=4, tile=(32, 32), device="cpu")
    ref = jst.solve_sparse_tiled_batched(xs, ws, hs, jc, chunk=4, tile=(32, 32))
    assert ours.w.shape == (2, 160, 5) and ours.h.shape == (2, 5, 200)
    _close_w(ours.w, ref.w, TILED)
    np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
    np.testing.assert_array_equal(ours.iterations.numpy(), np.asarray(ref.iterations))


def test_sparse_tiled_batched_member_is_its_tiled_solve():
    """Each member within F32 of its own ``solve_sparse_tiled`` (the padding
    zero tiles only reorder the cost's sum); no kernel launches anywhere."""
    xs, ws, hs = _tiled_members(m=130, n=190)   # ragged: the padding is cropped
    tc, _ = _configs("float32", max_iter=10, check_every=5)
    res = pt.solve_sparse_tiled_batched(xs, ws, hs, tc, chunk=4, tile=(32, 32), device="cpu")
    for i in range(2):
        one = pt.solve_sparse_tiled(xs[i], ws[i], hs[i], tc, chunk=4, tile=(32, 32),
                                    device="cpu")
        _close_w(res.w[i], one.w.numpy(), TILED)
        np.testing.assert_allclose(float(res.cost[i]), float(one.cost), rtol=1e-6)
    assert not any(tfm.LAUNCHES.values())


@pytest.mark.parametrize("case", ["pallas", "beta", "empty", "shapes", "not_3d", "tile_shapes"])
def test_sparse_tiled_batched_refuses_as_nmf_tpu(case):
    xs, ws, hs = _tiled_members()
    fields = {"pallas": dict(backend="pallas"), "beta": dict(beta=2.0)}.get(case, {})
    if case == "empty":
        xs = []
    elif case == "shapes":
        ws = ws[:, :-1]
    elif case == "not_3d":
        ws = ws[0]
    elif case == "tile_shapes":
        xs = [jst.tiles_from_dense(xs[0], (32, 32)), jst.tiles_from_dense(xs[1], (16, 16))]
    kw = dict(chunk=4, tile=(32, 32))
    ours = _refusal(lambda: pt.solve_sparse_tiled_batched(
        xs if case != "tile_shapes" else [pt.tiles_from_dense(x, t) for x, t in
                                          zip(_tiled_members()[0], [(32, 32), (16, 16)])],
        ws, hs, pt.SolveConfig(max_iter=2, **fields), device="cpu", **kw))
    ref = _refusal(lambda: jst.solve_sparse_tiled_batched(
        xs, ws, hs, jt.SolveConfig(max_iter=2, **fields), **kw))
    assert ours == ref


def test_chip_smoke_lists_selection_launches():
    """Phase 14's runs in the kernels line: one launch a batched call,
    whatever its members, under each run's name."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = {"float32": {"update_h": 200, "kl_cost": 8},
                "selection batched float32": {"update_h": 100, "kl_cost": 0},
                "selection restarts": {"update_h": 100, "kl_cost": 4}}
    assert smoke._selection_launches(launches, "update_h") == {"batched float32": 100,
                                                                "restarts": 100}
    assert smoke._selection_launches(launches, "kl_cost") == {"batched float32": 0,
                                                               "restarts": 4}
    # phase 15 (utils) follows phase 14, and phases 16-19 (sparse, backend, mesh, serving) it
    assert smoke.PHASES[-6:] == ("selection", "utils", "sparse", "backend", "mesh", "serving")
    assert smoke.BATCH_SHAPE == (128, 513, 2000, 32)
