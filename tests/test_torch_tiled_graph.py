"""The captured tile-sparse loops of ``nmf_tpu_torch.models.sparse_tiled`` on the CPU.

JAX compiles a single-device tile-sparse solve into one program
(``_tiled_fns`` under ``jax.jit``; the batch as ``jit(vmap(run_checked_loop))``).
On the card the port replays CUDA graphs instead: every full check block
after a call's first is ``chunk`` replays of a step's graph (K5's two
sweeps, or the plain sweeps, and the epilogues) and one of the close's
(the cost's chunk loop), where the step's work, the occupied tiles' T x bm
x bn x K (B x that on the batch), is below ``solver.GRAPH_MAX_WORK``.  The
CPU has no graphs, so these tests hold the route with
tests/test_torch_graph.py's stand-in for the graph API (``_CpuGraphs``: a
capture runs the part's Python and undoes its work, a replay reruns it on
the capture's buffers and takes back what its wrappers counted), at 96 x
160 (three occupied 32^2 tiles of fifteen, one padding tile at chunk 2,
K=4) and at tests/test_torch_tile_sparse.py's 160 x 200 problem (K=8,
32^2 tiles, the last column of tiles ragged; the ``bfloat16`` runs, whose
bar was measured there):

(a) with ``thresh == 0`` a graphed tiled loop reads nothing back (a
    dispatch mode raises on ``aten._local_scalar_dense``), on both sweep
    routes;
(b) the graphed 2-D tiled solve gives the eager loop's bits (w, h, cost,
    history, iterations, checks, converged, momentum) and its K5 launches
    (counted on the CPU by wrapping the sweeps, as the card counts them),
    on K5's route in ``float32``, ``bfloat16`` and ``float32_fast``, on the
    plain route (its ``SweepLayout``), with int8 tiles (their scales), ragged,
    under ``thresh > 0`` (the stop on the device) and accelerated (the
    redo replayed under the device's reject flag), and
    ``nmf_tpu.solve_sparse_tiled``'s
    values within tests/test_torch_tile_sparse.py's tolerances (factors
    rtol 1e-4 / atol 2e-6, costs 1e-5; ``float32_fast`` rtol 2e-3;
    ``bfloat16`` rtol 5e-2, costs 1e-4; the rejecting run's history 1e-5,
    as tests/test_torch_accel.py holds it);
(c) each segment of a checkpointed tile-sparse solve replays, and the
    checkpointed run gives the eager one's bits and the straight solve's;
(d) the tile-sparse batch (plain, ``thresh > 0``, int8 tiles,
    accelerated) gives the eager loop's bits and ``nmf_tpu``'s values;
(e) the work rule: at T x bm x bn x K (B x that on the batch) no graph,
    one unit of work less and the call replays; a tiled solve on a 1x1
    mesh captures nothing;
(f) ``fused_mu.count_snapshot`` and ``add_counts`` carry K5's
    ``tile_sparse.LAUNCHES`` and ``PLAIN_CALLS``, and the library's adder of
    K5's per-Mode counts is declared and defined.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import sparse_tiled as jst  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import solver as ps  # noqa: E402
from nmf_tpu_torch.models import sparse_tiled as pst  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.ops.kernels import tile_sparse as tts  # noqa: E402
from nmf_tpu_torch.utils import solve_with_checkpoints  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, result_to_numpy  # noqa: E402

from test_torch_graph import _CpuGraphs, _NoHostRead, _Replayed  # noqa: E402
from test_torch_tile_sparse import (  # noqa: E402
    SOLVE_BF16_TOL,
    SOLVE_SPLIT3_TOL,
    SOLVE_TOL,
    _tiled_problem,
)

FIELDS = ("w", "h", "cost", "cost_history", "iterations", "num_checks", "converged", "momentum")
TILE, CHUNK = (32, 32), 2
ITERS, EVERY = 30, 5        # six full blocks: the first eager, five replayed
# an accelerated run that rejects after its second block: a pinned momentum
# of 0.999, a check every iteration (tests/test_torch_accel.py's REJECTING)
REJECTING = dict(max_iter=120, check_every=1, accelerate=True, accel_momentum=0.999,
                 accel_momentum_max=0.999, accel_grow=1.0, accel_shrink=1.0)


def _small():
    """96 x 160, K=4: three occupied 32^2 tiles of the fifteen (padded to
    four at chunk 2), half their entries zero."""
    rng = np.random.RandomState(25)
    x = np.zeros((96, 160), np.float32)
    for i, j in ((0, 0), (0, 3), (2, 1)):
        blk = rng.rand(32, 32).astype(np.float32)
        blk[rng.rand(32, 32) < 0.5] = 0
        x[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32] = blk
    return x, rng.rand(96, 4).astype(np.float32), rng.rand(4, 160).astype(np.float32)


def _members(b=3):
    """``b`` members of 96 x 160 (K=3), each with its own occupied tiles
    (2 + i of them), so the batch pads each list to a common count."""
    rng = np.random.RandomState(26)
    xs = []
    for i in range(b):
        x = np.zeros((96, 160), np.float32)
        for _ in range(2 + i):
            r, c = rng.randint(0, 3) * 32, rng.randint(0, 5) * 32
            x[r:r + 32, c:c + 32] = rng.rand(32, 32)
        xs.append(x)
    return (xs, rng.rand(b, 96, 3).astype(np.float32) + 0.1,
            rng.rand(b, 3, 160).astype(np.float32) + 0.1)


@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(ps, "_GRAPHS", _CpuGraphs())
    _Replayed.MADE = []
    ps.reset_graph_counts()


@pytest.fixture
def counted(monkeypatch):
    """K5 counted as the card counts it: one launch a sweep wrapper call
    (``tile_sparse.LAUNCHES``), one plain call a plain sweep of the plain
    route (``PLAIN_CALLS``) and one extrapolation launch a call of
    ``extrapolate_into``, in the counts a capture takes back and a replay
    adds."""
    for name in ("h_numerator", "w_numerator"):
        original = getattr(tts, name)

        def call(*args, _name=name, _original=original, **kw):
            tts.LAUNCHES[_name] += 1
            return _original(*args, **kw)
        monkeypatch.setattr(tts, name, call)
    plain = tts.sweep_plain

    def sweep_plain(w, h, tiles, layout, eps, precision, target, scales=None):
        tts.PLAIN_CALLS[f"{target}_numerator"] += 1
        return plain(w, h, tiles, layout, eps, precision, target, scales)
    monkeypatch.setattr(tts, "sweep_plain", sweep_plain)
    extrapolate_into = tfm.extrapolate_into

    def extrapolate(*args, **kw):
        tfm.EXTRAP_LAUNCHES["extrapolate"] += 1
        return extrapolate_into(*args, **kw)
    monkeypatch.setattr(tfm, "extrapolate_into", extrapolate)
    tfm.reset_counts()
    tts.reset_counts()
    yield
    tfm.reset_counts()        # no count outlives the test
    tts.reset_counts()


def _counts():
    """The block counts (the stop's skipped blocks and waits:
    tests/test_torch_stop_graph.py), and the accelerated loop's."""
    return ({k: ps.GRAPH_COUNTS[k] for k in ("warm_ups", "captures", "replays")},
            dict(ps.ACCEL_COUNTS))


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_bits(a, b, where=""):
    for f in FIELDS:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, (where, f)
        assert _bits(ta).numpy().tobytes() == _bits(tb).numpy().tobytes(), (where, f)


def _k5(snapshot):
    """The K5 entries of a count snapshot."""
    return {key: n for key, n in snapshot.items() if key[0].startswith("tile_sparse.")}


def _graphed_and_eager(fn):
    """(graphed result, its counts, its graph counts, eager result, its
    counts): ``fn`` on the captured route, then inside ``eager_loop``."""
    tfm.reset_counts()
    tts.reset_counts()
    got = fn()
    counts, graphs = tfm.count_snapshot(), _counts()
    tfm.reset_counts()
    tts.reset_counts()
    with ps.eager_loop():
        eager = fn()
    return got, counts, graphs, eager, tfm.count_snapshot()


def _pcfg(jcfg, **kw):
    return dataclasses.replace(config_from_dict(dataclasses.asdict(jcfg)), **kw)


def _held_to_jax(rp, rj, tol, state=torch.float32):
    """tests/test_torch_tile_sparse.py's bar: counts and flags exact,
    the history within the cost rtol, the factors within rtol / atol."""
    out = result_to_numpy(rp)
    for f in ("iterations", "num_checks", "converged"):
        assert np.all(out[f] == np.asarray(getattr(rj, f))), f
    rtol, atol, cost_rtol = tol
    assert rp.w.dtype == state
    np.testing.assert_allclose(out["cost_history"], np.asarray(rj.cost_history), rtol=cost_rtol)
    for f in ("w", "h"):
        np.testing.assert_allclose(out[f], np.asarray(getattr(rj, f)).astype(np.float32),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("backend,x_dtype", [("auto", "float32"), ("jnp", "float32"),
                                             ("auto", "int8")], ids=["k5", "plain", "int8"])
def test_a_thresh_zero_reads_nothing_back(captured, backend, x_dtype):
    """A graphed tiled loop with ``thresh == 0``: no host read from its
    first block to its result (the payload and the plans are made once,
    before the loop)."""
    x, w, h = _small()
    cfg = pt.SolveConfig(max_iter=ITERS, check_every=EVERY, backend=backend,
                         precision=pt.Precision(x_dtype=x_dtype))
    xarg, wp, hp, info = pst._prepare_tiled(x, w, h, cfg, CHUNK, TILE, torch.device("cpu"))
    assert info["route"] == ("k5" if backend == "auto" and x_dtype == "float32" else "plain")
    with _NoHostRead():
        res = pst._run_tiled(xarg, wp, hp, cfg, info)
    assert int(res.iterations) == ITERS
    assert _counts()[0] == {"warm_ups": 1, "captures": 1, "replays": ITERS // EVERY - 1}


# ---------------------------------------------------------------- (b)

# name -> (problem, JAX config fields, the port's backend, the JAX bar)
CASES = {
    "float32": ("small", dict(), "auto", SOLVE_TOL),
    "bfloat16": ("ragged", dict(precision=jt.Precision("bfloat16")), "auto", SOLVE_BF16_TOL),
    "float32_fast": ("small", dict(precision=jt.Precision("float32_fast")), "auto",
                     SOLVE_SPLIT3_TOL),
    "bf16_state": ("ragged", dict(precision=jt.Precision("bfloat16", "bfloat16", "bfloat16")),
                   "auto", SOLVE_BF16_TOL),
    "plain": ("small", dict(), "jnp", SOLVE_TOL),
    "int8": ("small", dict(precision=jt.Precision(x_dtype="int8")), "auto", SOLVE_TOL),
    "ragged": ("ragged", dict(), "auto", SOLVE_TOL),
    "ragged int8": ("ragged", dict(precision=jt.Precision(x_dtype="int8")), "auto", SOLVE_TOL),
    "thresh": ("ragged", dict(max_iter=400, thresh=1e-3), "auto", SOLVE_TOL),
    "accelerated": ("ragged", dict(accelerate=True), "auto", SOLVE_TOL),
    "accelerated plain": ("ragged", dict(accelerate=True), "jnp", SOLVE_TOL),
    "accelerated bfloat16": ("ragged", dict(accelerate=True, precision=jt.Precision("bfloat16")),
                             "auto", SOLVE_BF16_TOL),
    "accelerated rejecting": ("ragged", REJECTING, "auto", None),
}


def _problem(name):
    return _small() if name == "small" else _tiled_problem()


@pytest.mark.parametrize("case", list(CASES))
def test_b_graphed_tiled_solve_gives_the_eager_bits_and_jax(captured, counted, case):
    which, fields, backend, bar = CASES[case]
    x, w, h = _problem(which)
    jcfg = jt.SolveConfig(**{"max_iter": ITERS, "check_every": EVERY, **fields})
    pcfg = _pcfg(jcfg, backend=backend)
    got, counts, graphs, eager, eager_counts = _graphed_and_eager(
        lambda: pt.solve_sparse_tiled(x, w, h, pcfg, chunk=CHUNK, tile=TILE, device="cpu"))
    _same_bits(got, eager, case)
    # the K5 launches (or plain sweeps) of the eager loop, replays included
    assert _k5(counts) == _k5(eager_counts)
    route = pst.sweep_route(pcfg, w.shape[1], TILE)
    key = "tile_sparse.LAUNCHES" if route == "k5" else "tile_sparse.PLAIN_CALLS"
    sweeps = counts[key, "h_numerator"]
    assert counts[key, "w_numerator"] == sweeps and sweeps >= int(got.iterations)
    blocks = int(got.iterations) // jcfg.check_every
    # accelerated: the accelerated part and the redo, both captured after
    # the first block
    assert graphs[0] == {"warm_ups": 1, "captures": 1 + bool(jcfg.accelerate),
                         "replays": blocks - 1}
    if jcfg.accelerate:
        rejects = (sweeps - int(got.iterations)) // jcfg.check_every
        assert sweeps == int(got.iterations) + jcfg.check_every * rejects
        assert graphs[1]["redo_eager"] == 0 and graphs[1]["redo_replays"] == rejects
        # the extrapolation kernel once an iteration (the eager loop: plain ops)
        assert counts["EXTRAP_LAUNCHES", "extrapolate"] == int(got.iterations)
        assert eager_counts["EXTRAP_LAUNCHES", "extrapolate"] == 0
        if case == "accelerated rejecting":
            assert graphs[1]["redo_replays"] > 0
    else:
        assert sweeps == int(got.iterations)
    if case == "thresh":
        assert bool(got.converged) and int(got.iterations) < jcfg.max_iter
    rj = jst.solve_sparse_tiled(x, w, h, jcfg, chunk=CHUNK, tile=TILE)
    if bar is None:         # the rejecting run: its checks and history
        n = int(got.num_checks)
        assert n == int(rj.num_checks) == REJECTING["max_iter"]
        np.testing.assert_allclose(got.cost_history.numpy()[:n],
                                   np.asarray(rj.cost_history)[:n], rtol=1e-5)
    else:
        state = torch.bfloat16 if case == "bf16_state" else torch.float32
        _held_to_jax(got, rj, bar, state)


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("accelerate", [False, True], ids=["plain", "accelerated"])
def test_c_checkpointed_segments_replay(tmp_path, captured, counted, accelerate):
    """``solve_with_checkpoints`` on a TileSparseX in two segments of four
    blocks: each segment replays three, the run gives the eager run's bits
    and the straight graphed solve's, and the K5 launches of both."""
    x, w, h = _tiled_problem()
    tx = pt.tiles_from_dense(x, TILE)
    cfg = pt.SolveConfig(max_iter=8 * EVERY, check_every=EVERY, accelerate=accelerate)
    runs = {}
    for tag in ("graphed", "eager"):
        tts.reset_counts()
        ps.reset_graph_counts()
        if tag == "eager":
            with ps.eager_loop():
                st = solve_with_checkpoints(tx, w, h, cfg, str(tmp_path / tag), every=4 * EVERY,
                                            device="cpu")
        else:
            st = solve_with_checkpoints(tx, w, h, cfg, str(tmp_path / tag), every=4 * EVERY,
                                        device="cpu")
        runs[tag] = st, dict(tts.LAUNCHES), _counts()[0]
    (got, launches, graphs), (eager, eager_launches, _) = runs["graphed"], runs["eager"]
    # a part a segment (accelerated: the accelerated part and the redo)
    assert graphs == {"warm_ups": 2, "captures": 2 * (1 + accelerate), "replays": 6}
    assert launches == eager_launches and launches["h_numerator"] >= cfg.max_iter
    for f in ("w", "h"):
        assert getattr(got, f).tobytes() == getattr(eager, f).tobytes(), f
    assert np.asarray(got.cost_history, np.float32).tobytes() \
        == np.asarray(eager.cost_history, np.float32).tobytes()
    assert got.iteration == cfg.max_iter and np.float32(got.momentum).tobytes() \
        == np.float32(eager.momentum).tobytes()
    straight = pt.solve_sparse_tiled(tx, w, h, cfg, device="cpu")
    assert got.w.tobytes() == straight.w.numpy().tobytes()
    assert got.h.tobytes() == straight.h.numpy().tobytes()


# ---------------------------------------------------------------- (d)

# 10 iterations in five blocks (tests/test_torch_batched.py's depth)
BATCH_CASES = {
    "float32": dict(),
    "thresh": dict(max_iter=400, check_every=5, thresh=1e-3),
    "int8": dict(precision=jt.Precision(x_dtype="int8")),
    "accelerated": dict(accelerate=True),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_d_tiled_batch_gives_the_eager_bits_and_jax(captured, counted, case):
    xs, ws, hs = _members()
    jcfg = jt.SolveConfig(**{"max_iter": 10, "check_every": 2, **BATCH_CASES[case]})
    pcfg = _pcfg(jcfg)
    got, counts, graphs, eager, eager_counts = _graphed_and_eager(
        lambda: pt.solve_sparse_tiled_batched(xs, ws, hs, pcfg, chunk=CHUNK, tile=TILE,
                                              device="cpu"))
    _same_bits(got, eager, case)
    assert _k5(counts) == _k5(eager_counts)
    assert not any(n for key, n in counts.items() if key[0] == "tile_sparse.LAUNCHES")
    # the accelerated part's capture, and the redo's beside it
    assert graphs[0]["captures"] == 1 + (case == "accelerated")
    assert graphs[0]["replays"] >= 1
    assert graphs[0]["warm_ups"] + graphs[0]["replays"] \
        == int(max(got.iterations)) // jcfg.check_every
    rj = jst.solve_sparse_tiled_batched(xs, ws, hs, jcfg, chunk=CHUNK, tile=TILE)
    _held_to_jax(got, rj, SOLVE_TOL)
    if case == "thresh":
        assert len(set(got.iterations.tolist())) > 1     # the members stop apart


# ---------------------------------------------------------------- (e)

@pytest.mark.parametrize("route", ["2-D", "accelerated", "batch"])
def test_e_the_work_rule_reads_the_occupied_tiles(captured, monkeypatch, route):
    """A step's work is the occupied (chunk-padded) tiles' T x bm x bn x K,
    times B on the batch, not the dense M x N x K: at the limit no graph,
    one unit less and the call replays."""
    cfg = pt.SolveConfig(max_iter=ITERS, check_every=EVERY, accelerate=route == "accelerated")
    if route == "batch":
        xs, ws, hs = _members()
        t = max(pt.tiles_from_dense(x, TILE).tiles.shape[0] for x in xs)
        work = len(xs) * -(-t // CHUNK) * CHUNK * TILE[0] * TILE[1] * ws.shape[2]
        dense = len(xs) * ws.shape[1] * hs.shape[2] * ws.shape[2]

        def solve():
            pt.solve_sparse_tiled_batched(xs, ws, hs, cfg, chunk=CHUNK, tile=TILE, device="cpu")
    else:
        x, w, h = _small()
        work = 4 * TILE[0] * TILE[1] * w.shape[1]    # three tiles padded to four
        dense = x.size * w.shape[1]

        def solve():
            pt.solve_sparse_tiled(x, w, h, cfg, chunk=CHUNK, tile=TILE, device="cpu")
    assert work != dense
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", work)
    solve()
    assert _counts()[0] == {"warm_ups": 0, "captures": 0, "replays": 0}
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", work + 1)
    solve()
    assert _counts()[0] == {"warm_ups": 1, "captures": 1 + (route == "accelerated"),
                            "replays": ITERS // EVERY - 1}


@pytest.mark.parametrize("accelerate", [False, True], ids=["plain", "accelerated"])
def test_e_mesh_tiled_solve_captures_nothing(captured, accelerate):
    """On a mesh the tiled loop's sums cross ranks inside the step: every
    block runs eagerly, and the 1x1 mesh gives the single-device bits."""
    from nmf_tpu_torch.parallel.mesh import shutdown

    x, w, h = _small()
    cfg = pt.SolveConfig(max_iter=ITERS, check_every=EVERY, accelerate=accelerate)
    mesh = pt.make_mesh((1, 1), device="cpu")
    try:
        res = pt.solve_sparse_tiled(x, w, h, cfg, chunk=CHUNK, tile=TILE, mesh=mesh)
    finally:
        shutdown()
    assert _counts() == ({"warm_ups": 0, "captures": 0, "replays": 0},
                         {"redo_eager": 0, "redo_replays": 0, "reads": 0})
    one = pt.solve_sparse_tiled(x, w, h, cfg, chunk=CHUNK, tile=TILE, device="cpu")
    assert _counts()[0]["replays"] == ITERS // EVERY - 1
    for f in ("w", "h", "cost_history"):
        assert _bits(getattr(res, f)).numpy().tobytes() \
            == _bits(getattr(one, f)).numpy().tobytes(), f


# ---------------------------------------------------------------- (f)

def test_f_counts_carry_the_tile_sparse_counters():
    """``count_snapshot`` holds K5's launches and plain calls; a delta of
    them (a capture's) is added back ``times`` over by ``add_counts``, as
    a replay adds it, and taken back by ``times=-1``."""
    tts.reset_counts()
    tfm.reset_counts()
    before = tfm.count_snapshot()
    assert before["tile_sparse.LAUNCHES", "h_numerator"] == 0
    assert before["tile_sparse.PLAIN_CALLS", "w_numerator"] == 0
    tts.LAUNCHES["h_numerator"] += 2          # a stubbed capture's launches
    tts.LAUNCHES["w_numerator"] += 2
    tts.PLAIN_CALLS["h_numerator"] += 1
    delta = tfm.count_delta(before)
    assert delta == {("tile_sparse.LAUNCHES", "h_numerator"): 2,
                     ("tile_sparse.LAUNCHES", "w_numerator"): 2,
                     ("tile_sparse.PLAIN_CALLS", "h_numerator"): 1}
    tfm.add_counts(delta, -1)                 # the capture taken back
    assert not any(tts.LAUNCHES.values()) and not any(tts.PLAIN_CALLS.values())
    tfm.add_counts(delta, 5)                  # five replays
    assert tts.LAUNCHES == {"h_numerator": 10, "w_numerator": 10}
    assert tts.PLAIN_CALLS == {"h_numerator": 5, "w_numerator": 0}
    assert not any(tfm.LAUNCHES.values())
    tts.reset_counts()


def test_f_library_adds_k5_launches_per_mode():
    """The library's ``nmf_add_sweep_launches(h, mode, n)`` is declared with
    its C signature and adds to K5's per-Mode counter; the snapshot reads
    those counters under ``"sweep"`` once the library is loaded (nothing
    is built for it here)."""
    import pathlib
    import re

    from nmf_tpu_torch.ops.kernels import _build

    assert _build._SIGNATURES["nmf_add_sweep_launches"] == ([_build._I] * 3, _build._I)
    src = (pathlib.Path(_build.__file__).parents[2] / "csrc" / "tile_sparse.cu").read_text()
    body = src[src.index("int nmf_add_sweep_launches(int h, int mode, int n) {"):]
    body = body[: body.index("\n}\n")]
    assert "sweep_launches[h ? 0 : 1][mode] += n" in body and "mode >= MODES" in body
    assert re.search(r'extern "C" \{.*int nmf_add_sweep_launches\(', src, re.S)
    if not tfm._lib.cache_info().currsize:
        assert all(key[0] not in ("lib", "sweep") for key in tfm.count_snapshot())
