"""The stop and the accept test on the device, in the captured loops, on the CPU.

JAX decides a solve's stop on the device (``lax.while_loop``'s cond,
``nmf_tpu/models/solver.py:454-493``) and the accelerated loop's accept
test too (``lax.cond``, ``:586``); a batched solve is ``vmap`` of that loop,
running until every member is done.  On the card the port's graphed loops
do the same with CUDA IF conditional nodes (``solver._CudaGraphs.when``,
``csrc/graph_if.cu``): under ``thresh > 0`` each block's graphs replay under
the device's ``running`` flag, the accelerated redo under its ``reject``
flag, the host enqueues blocks without reading the card, pacing itself on
the events of the blocks two back (``solver._Pace``), and reads the card
once, at the end.  The CPU has no graphs, so these tests hold the routes
with tests/test_torch_graph.py's stand-in for the graph API
(``_CpuGraphs``: a capture runs the part's Python and undoes its work, a
replay reruns it on the capture's buffers, under a flag only where the
flag holds, and takes back what its wrappers counted), under a dispatch
mode that raises on every host read but the counted ones
(``ACCEL_COUNTS["reads"]``).  Every case gives the eager loop's bits
(``solver.eager_loop()``: w, h, cost, history, iterations, checks,
converged, momentum) and launches, and ``nmf_tpu``'s values: iterations,
checks and converged exactly, the history's NaN slots exactly, the
history within rel 1e-5 and the factors within rtol 1e-4 / atol 1e-6
(tests/test_torch_graph.py's bar, which its 400-iteration stops meet;
the batches at it too, member i being the 2-D solve of member i bit for
bit; the accelerated runs at tests/test_torch_accel.py's, the tile-sparse
runs at tests/test_torch_tile_sparse.py's):

(a) the plain loop stopping mid-run, at the last full block and the one
    before, at a ragged tail's check, never (a ragged tail too), and at the
    first check of a resumed segment (``initial_cost``): one read, at the
    end; ``min(2, blocks left)`` blocks enqueued after the stop, skipped;
    replays after the stop change no buffer (a deeper lookahead gives the
    same bits); the lookahead's waits; live metrics still read once a
    check;
(b) the accelerated loop with rejects at ``thresh == 0`` (no read before
    the end) and at ``thresh > 0``, its redos counted on the device;
(c) the batched loop with members stopping at different checks, and the
    batched accelerated loop;
(d) the routes built on these classes: the tile-sparse solve, its
    checkpointed segments and its batch, the streamed transform
    (``StreamGraphs``) and a served program (``GraphCache``), each at
    ``thresh > 0``;
(e) the conditional node itself: a capture under a flag goes through
    ``when``, a library that cannot make the node raises (no loop reads
    the card instead), and ``csrc/graph_if.cu``'s entry points are declared
    for ctypes as the source defines them.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import sparse_tiled as jst  # noqa: E402
from nmf_tpu.parallel import batched as jb  # noqa: E402
from nmf_tpu.utils import metrics as jmetrics  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import solver as ps  # noqa: E402
from nmf_tpu_torch.ops.kernels import _build  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils import metrics as pmetrics  # noqa: E402
from nmf_tpu_torch.utils import solve_with_checkpoints  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, result_to_numpy  # noqa: E402

from oracle import clamp  # noqa: E402
from test_torch_accel import REJECTING, _assert_match, _wide  # noqa: E402
from test_torch_graph import _CpuGraphs, _NoHostRead, _Replayed  # noqa: E402
from test_torch_tile_sparse import SOLVE_TOL  # noqa: E402

M, K, N = 64, 6, 80
EVERY = 5
FIELDS = ("w", "h", "cost", "cost_history", "iterations", "num_checks", "converged", "momentum")
COST_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(27)
    return tuple(clamp(rng.rand(*s).astype(np.float32)) for s in ((M, N), (M, K), (K, N)))


@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(ps, "_GRAPHS", _CpuGraphs())
    _Replayed.MADE = []
    ps.reset_graph_counts()


@pytest.fixture
def counted(monkeypatch):
    """K1-K3 and the extrapolation counted as the card counts them: one
    launch a wrapper call, in the counts a capture takes back and a replay
    adds (a replay under a flag: at the end, from the device's counts)."""
    def counting(name, key, counts):
        original = getattr(tfm, name)

        def call(*args, **kw):
            counts[key] += 1
            return original(*args, **kw)
        monkeypatch.setattr(tfm, name, call)

    for name, key in (("update_h_fused", "update_h"), ("update_w_fused", "update_w"),
                      ("kl_cost_fused", "kl_cost")):
        counting(name, key, tfm.LAUNCHES)
    counting("extrapolate_into", "extrapolate", tfm.EXTRAP_LAUNCHES)
    tfm.reset_counts()
    yield
    tfm.reset_counts()        # no count outlives the test


def _graphs():
    return dict(ps.GRAPH_COUNTS, capture_s=0)


def _k123(counts):
    """The counts without the extrapolation's (the eager loop extrapolates
    with plain ops)."""
    return {key: n for key, n in counts.items() if key[0] != "EXTRAP_LAUNCHES"}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_bits(a, b, where=""):
    for f in FIELDS:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, (where, f)
        assert _bits(ta).numpy().tobytes() == _bits(tb).numpy().tobytes(), (where, f)


def _run(fn):
    """(the graphed run under ``_NoHostRead``, its launches, its graph and
    accelerated counts, the eager run, its launches)."""
    ps.reset_graph_counts()
    tfm.reset_counts()
    with _NoHostRead():
        got = fn()
    counts, graphs, accel = tfm.count_snapshot(), _graphs(), dict(ps.ACCEL_COUNTS)
    tfm.reset_counts()
    with ps.eager_loop():
        eager = fn()
    return got, counts, graphs, accel, eager, tfm.count_snapshot()


def _held_to_jax(rp, rj, rtol=RTOL, atol=ATOL, cost_rtol=COST_RTOL):
    out = result_to_numpy(rp)
    for f in ("iterations", "num_checks", "converged"):
        assert np.all(out[f] == np.asarray(getattr(rj, f))), f
    hj = np.asarray(rj.cost_history)
    np.testing.assert_array_equal(np.isnan(out["cost_history"]), np.isnan(hj))
    np.testing.assert_allclose(out["cost_history"], hj, rtol=cost_rtol)
    for f in ("w", "h"):
        np.testing.assert_allclose(out[f], np.asarray(getattr(rj, f)), rtol=rtol, atol=atol)


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _thresh_stopping_at(x, w, h, check: int, max_iter: int) -> float:
    """A threshold that stops the solve at ``check`` (1-based, >= 2): the
    geometric mean of that check's relative change and the smallest one
    before it, from the eager run that never stops (each changes by about
    a tenth a check here, far past the two packages' last-bit spread)."""
    with ps.eager_loop():
        res = pt.solve(x, w, h, pt.SolveConfig(max_iter=max_iter, check_every=EVERY),
                       device="cpu")
    hist = res.cost_history.numpy()
    rel = np.abs(hist[:-1] - hist[1:]) / np.abs(hist[1:])   # rel[i]: check i + 2's
    at, before = rel[check - 2], rel[:check - 2].min(initial=np.inf)
    assert at < before
    return float(np.sqrt(at * min(before, 4 * at)))


# ---------------------------------------------------------------- (a)

# name: (max_iter, the check it stops at (None: never), initial_cost)
PLAIN = {
    "mid-run": (100, 8, False),
    "last full block": (40, 8, False),
    "next to last block": (40, 7, False),
    "ragged tail's check": (43, 9, False),
    "never": (40, None, False),
    "never, ragged tail": (43, None, False),
    "resumed segment's first check": (40, 1, True),
}


def _plain_case(problem, name):
    x, w, h = problem
    max_iter, stop, seeded = PLAIN[name]
    kw = {}
    if seeded:        # a baseline by the first check's cost: it stops at once
        with ps.eager_loop():
            first = pt.solve(x, w, h, pt.SolveConfig(max_iter=EVERY, check_every=EVERY),
                             device="cpu")
        kw["initial_cost"] = float(first.cost) * (1 + 1e-6)
        thresh = 1e-4
    elif stop is None:
        thresh = 1e-12
    else:
        thresh = _thresh_stopping_at(x, w, h, stop, max_iter)
    return jt.SolveConfig(max_iter=max_iter, check_every=EVERY, thresh=thresh), kw


@pytest.mark.parametrize("name", list(PLAIN))
def test_a_plain_loop_stops_on_the_device(problem, name, captured, counted):
    """One read at the end; the blocks after the stop enqueued (at most
    two) and skipped; the eager loop's bits and launches; JAX's values."""
    x, w, h = problem
    jcfg, kw = _plain_case(problem, name)
    max_iter, stop, _ = PLAIN[name]
    got, counts, graphs, accel, eager, eager_counts = _run(
        lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu", **kw))
    _same_bits(got, eager, name)
    assert counts == eager_counts
    blocks = -(-max_iter // EVERY)
    checks = blocks if stop is None else stop
    assert int(got.num_checks) == checks and bool(got.converged) == (stop is not None)
    assert int(got.iterations) == min(checks * EVERY, max_iter)
    skipped = min(2, blocks - checks)
    assert accel == {"redo_eager": 0, "redo_replays": 0, "reads": 1}
    assert graphs == {"warm_ups": 1, "captures": int(checks + skipped > 1),
                      "replays": checks - 1, "skipped": skipped,
                      "waits": max(0, checks + skipped - ps._Pace.DEPTH), "capture_s": 0}
    _held_to_jax(got, jt.solve(x, w, h, jcfg, **kw))


def test_a_replays_after_the_stop_change_nothing(problem, captured, monkeypatch):
    """Six blocks enqueued after the stop (a lookahead of six) replay
    nothing: every buffer keeps the stop's values, so the result is the
    two-block lookahead's and the eager loop's, bit for bit."""
    x, w, h = problem
    cfg = pt.SolveConfig(max_iter=200, check_every=EVERY,
                         thresh=_thresh_stopping_at(x, w, h, 6, 200))
    near = pt.solve(x, w, h, cfg, device="cpu")
    monkeypatch.setattr(ps._Pace, "DEPTH", 6)
    ps.reset_graph_counts()
    far = pt.solve(x, w, h, cfg, device="cpu")
    assert ps.GRAPH_COUNTS["skipped"] == 6 and int(far.num_checks) == 6
    _same_bits(far, near)
    with ps.eager_loop():
        _same_bits(far, pt.solve(x, w, h, cfg, device="cpu"))


def test_a_the_lookahead_waits_on_the_block_two_back():
    """``_Pace``: the flag's copy after each block, the wait on the event of
    the block ``DEPTH`` back, the stop seen ``DEPTH`` blocks after it, and
    one wait a block past the first ``DEPTH``."""
    events = []

    class _Api:
        def event(self):
            e = type("E", (), {})()
            e.record = lambda: events.append(("record", e))
            e.synchronize = lambda: events.append(("wait", e))
            return e

    saved = ps._GRAPHS
    ps._GRAPHS = _Api()
    try:
        ps.reset_graph_counts()
        flag = torch.ones((), dtype=torch.bool)
        pace = ps._Pace(flag)
        seen = []
        for block in range(6):
            if block == 2:
                flag.fill_(False)         # block 2's close stops the loop
            seen.append(pace.stopped())
    finally:
        ps._GRAPHS = saved
    assert seen == [False, False, False, False, True, True]
    records = [e for kind, e in events if kind == "record"]
    waits = [e for kind, e in events if kind == "wait"]
    assert waits == records[:4] and ps.GRAPH_COUNTS["waits"] == 4


@pytest.mark.parametrize("accelerate", [False, True], ids=["plain", "accelerated"])
def test_a_live_metrics_read_once_a_check(problem, captured, accelerate):
    """``live_metrics`` under ``thresh > 0`` emits ``(it, cost, rel)`` once a
    check, the eager loop's triples, from one read a check (the
    accelerated loop: and its read at the end); JAX's within its bar."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=100, check_every=EVERY, live_metrics=True,
                          accelerate=accelerate,
                          thresh=_thresh_stopping_at(x, w, h, 8, 100) if not accelerate
                          else 1e-3)

    def emissions(fn, metrics):
        events = []
        metrics.set_live_handler(lambda *e: events.append(e))
        try:
            res = fn()
            jax.effects_barrier()
        finally:
            metrics.set_live_handler(None)
        return res, events

    with _NoHostRead():
        got, ours = emissions(lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu"), pmetrics)
    reads = ps.ACCEL_COUNTS["reads"]
    with ps.eager_loop():
        eager, ours_eager = emissions(lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu"),
                                      pmetrics)
    _same_bits(got, eager)
    checks = int(got.num_checks)
    assert np.array(ours).tobytes() == np.array(ours_eager).tobytes()
    assert [e[0] for e in ours] == list(range(EVERY, checks * EVERY + 1, EVERY))
    assert reads == checks + accelerate and bool(got.converged)
    _, theirs = emissions(lambda: jt.solve(x, w, h, jcfg), jmetrics)
    assert [e[0] for e in theirs] == [e[0] for e in ours]
    np.testing.assert_allclose([e[1] for e in ours], [e[1] for e in theirs], rtol=COST_RTOL)


# ---------------------------------------------------------------- (b)

# the rejecting run; at a check every 2 of 13 iterations its ragged last
# block (one iteration) is rejected too, and its redo counts its one step
ACCEL_REJECTS = {"thresh 0": {}, "thresh": {"thresh": 1e-3},
                 "ragged tail rejected": {"check_every": 2, "max_iter": 13}}


@pytest.mark.parametrize("case", list(ACCEL_REJECTS))
def test_b_accelerated_rejects_read_nothing_before_the_end(captured, counted, case):
    """The rejecting run (a pinned momentum, a check every iteration): its
    redos replay under the device's reject flag and are counted there, so
    the solve reads the card once, at its end, at ``thresh == 0``, under a
    stop, and with a rejected ragged tail (the eager loop's redos, bits and
    launches; JAX's values)."""
    x, w, h = _wide()
    jcfg = jt.SolveConfig(**{**REJECTING, **ACCEL_REJECTS[case]})
    thresh = jcfg.thresh
    got, counts, graphs, accel, eager, eager_counts = _run(
        lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu"))
    _same_bits(got, eager)
    assert _k123(counts) == _k123(eager_counts)
    redos = ps.ACCEL_COUNTS["redo_eager"]          # the eager twin's
    assert redos > 0 and accel == {"redo_eager": 0, "redo_replays": redos, "reads": 1}
    assert counts["EXTRAP_LAUNCHES", "extrapolate"] == int(got.iterations)
    assert graphs["captures"] == 2 and graphs["warm_ups"] == 1
    assert graphs["replays"] == int(got.num_checks) - 1
    if thresh:
        assert bool(got.converged) and int(got.iterations) < REJECTING["max_iter"]
        assert graphs["skipped"] <= 2
    if case == "ragged tail rejected":     # K1 ran the tail's one redone step
        assert (counts["LAUNCHES", "update_h"] - 13) % 2 == 1
    _assert_match(jt.solve(x, w, h, jcfg), got, entrywise=False)


def test_b_accelerated_first_block_reject_and_stop(problem, captured, counted):
    """``initial_cost=0`` rejects the first block (its redo replays at once,
    captured with the accelerated part) and a threshold stops the run
    mid-way, with a ragged tail left unrun: the eager loop's bits and
    launches, one read, and JAX's values."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=203, check_every=EVERY, thresh=1e-3, accelerate=True)
    got, counts, graphs, accel, eager, eager_counts = _run(
        lambda: pt.solve(x, w, h, _pcfg(jcfg), initial_cost=0.0, device="cpu"))
    _same_bits(got, eager)
    assert _k123(counts) == _k123(eager_counts)
    assert accel == {"redo_eager": 0, "redo_replays": 1, "reads": 1}
    assert bool(got.converged) and int(got.iterations) < 200 and graphs["skipped"] == 2
    _assert_match(jt.solve(x, w, h, jcfg, initial_cost=0.0), got)


# ---------------------------------------------------------------- (c)

@pytest.fixture(scope="module")
def stack():
    rng = np.random.RandomState(24)
    return tuple(clamp(rng.rand(*s).astype(np.float32))
                 for s in ((4, 24, 40), (4, 24, 5), (4, 5, 40)))


# the members stop at 110, 170, 150 and 280 iterations (accelerated: 200,
# 310, 300 and 220); the ragged tail's run never stops
BATCHES = {
    "thresh": dict(max_iter=400, check_every=10, thresh=1e-3),
    "thresh, ragged tail": dict(max_iter=45, check_every=10, thresh=1e-9),
    "accelerated": dict(max_iter=50, check_every=10, accelerate=True),
    "accelerated thresh": dict(max_iter=400, check_every=10, thresh=2e-4, accelerate=True),
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_c_batched_members_stop_apart_on_the_device(stack, name, captured, counted):
    """The vmapped ``while_loop``: members stop at their own checks, the
    blocks replay while any member runs and the host reads once, at the
    end (each member's checks and stop, the redos); the eager loop's bits
    and launches, each member its own check count, and JAX's batch."""
    x, w, h = stack
    jcfg = jt.SolveConfig(**BATCHES[name])
    got, counts, graphs, accel, eager, eager_counts = _run(
        lambda: pt.solve_batched(x, w, h, _pcfg(jcfg), device="cpu"))
    _same_bits(got, eager, name)
    assert _k123(counts) == _k123(eager_counts)
    assert accel["reads"] == 1 and accel["redo_eager"] == 0
    checks = got.num_checks.numpy()
    assert graphs["replays"] == int(checks.max()) - 1 and graphs["skipped"] <= 2
    np.testing.assert_array_equal(got.iterations.numpy(), np.minimum(checks * 10, jcfg.max_iter))
    if jcfg.thresh > 1e-6:
        assert len(set(got.iterations.tolist())) == 4 and bool(got.converged.all())
    ref = jb.solve_batched(x, w, h, jcfg)
    for f in ("iterations", "num_checks", "converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(got.cost_history.numpy(), np.asarray(ref.cost_history),
                               rtol=COST_RTOL)
    for f in ("w", "h"):     # member i is the 2-D solve: its bar at these depths
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- (d)

def _guard_blocks(monkeypatch):
    """Every graphed stop loop's blocks enqueued under ``_NoHostRead`` (the
    stream's and the server's own reads of a block's finished result lie
    outside the loop)."""
    enqueue = ps._enqueue_blocks

    def guarded(*args, **kw):
        with _NoHostRead():
            return enqueue(*args, **kw)
    monkeypatch.setattr(ps, "_enqueue_blocks", guarded)


def _tiled(seed=25):
    rng = np.random.RandomState(seed)
    x = np.zeros((96, 160), np.float32)
    for i, j in ((0, 0), (0, 3), (2, 1)):
        x[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32] = rng.rand(32, 32)
    return x, rng.rand(96, 4).astype(np.float32), rng.rand(4, 160).astype(np.float32)


TILED_CFG = dict(max_iter=400, check_every=EVERY, thresh=1e-4)


def test_d_tiled_solve_stops_on_the_device(captured, counted):
    x, w, h = _tiled()
    jcfg = jt.SolveConfig(**TILED_CFG)
    got, counts, graphs, accel, eager, eager_counts = _run(
        lambda: pt.solve_sparse_tiled(x, w, h, _pcfg(jcfg), chunk=2, tile=(32, 32),
                                      device="cpu"))
    _same_bits(got, eager)
    assert counts == eager_counts and accel["reads"] == 1
    assert bool(got.converged) and graphs["skipped"] == 2
    rtol, atol, cost_rtol = SOLVE_TOL
    _held_to_jax(got, jst.solve_sparse_tiled(x, w, h, jcfg, chunk=2, tile=(32, 32)),
                 rtol, atol, cost_rtol)


def test_d_checkpointed_tiled_segments_stop_on_the_device(tmp_path, captured):
    """``solve_with_checkpoints`` on a TileSparseX under ``thresh > 0``:
    each segment stops on the device and reads the card once; the run
    stops where the eager run does, with its bits."""
    x, w, h = _tiled()
    tx = pt.tiles_from_dense(x, (32, 32))
    cfg = pt.SolveConfig(**TILED_CFG)
    got = solve_with_checkpoints(tx, w, h, cfg, str(tmp_path / "g"), every=8 * EVERY,
                                 device="cpu")
    reads, skipped = ps.ACCEL_COUNTS["reads"], ps.GRAPH_COUNTS["skipped"]
    with ps.eager_loop():
        eager = solve_with_checkpoints(tx, w, h, cfg, str(tmp_path / "e"), every=8 * EVERY,
                                       device="cpu")
    segments = -(-got.iteration // (8 * EVERY))
    assert reads == segments > 1 and skipped == 2 and got.iteration < cfg.max_iter
    assert got.iteration == eager.iteration
    for f in ("w", "h"):
        assert getattr(got, f).tobytes() == getattr(eager, f).tobytes(), f
    assert np.asarray(got.cost_history, np.float32).tobytes() == \
        np.asarray(eager.cost_history, np.float32).tobytes()


def test_d_tiled_batch_stops_on_the_device(captured, counted):
    rng = np.random.RandomState(26)
    xs = []
    for i in range(3):
        x = np.zeros((96, 160), np.float32)
        for _ in range(2 + i):
            r, c = rng.randint(0, 3) * 32, rng.randint(0, 5) * 32
            x[r:r + 32, c:c + 32] = rng.rand(32, 32)
        xs.append(x)
    ws, hs = rng.rand(3, 96, 3).astype(np.float32) + 0.1, rng.rand(3, 3, 160).astype(np.float32) + 0.1
    jcfg = jt.SolveConfig(**TILED_CFG)
    got, counts, graphs, accel, eager, eager_counts = _run(
        lambda: pt.solve_sparse_tiled_batched(xs, ws, hs, _pcfg(jcfg), chunk=2, tile=(32, 32),
                                              device="cpu"))
    _same_bits(got, eager)
    assert counts == eager_counts and accel["reads"] == 1 and graphs["skipped"] <= 2
    ref = jst.solve_sparse_tiled_batched(xs, ws, hs, jcfg, chunk=2, tile=(32, 32))
    rtol, atol, cost_rtol = SOLVE_TOL
    _held_to_jax(got, ref, rtol, atol, cost_rtol)


def test_d_streamed_transform_stops_on_the_device(problem, captured, monkeypatch):
    """``transform_out_of_core`` under ``thresh > 0``: every block's call
    replays the stream's graphs (``StreamGraphs``) under the stop and reads
    the card once; the eager loop's H, costs and counts; JAX's values."""
    x, w, _ = problem
    jcfg = jt.SolveConfig(max_iter=200, check_every=EVERY, thresh=1e-4)
    kw = {"block_n": 16, "seed": 3}

    def run():
        return pt.transform_out_of_core(x, w, config=_pcfg(jcfg), device="cpu", **kw)

    _guard_blocks(monkeypatch)
    got = run()
    reads, graphs = ps.ACCEL_COUNTS["reads"], _graphs()
    with ps.eager_loop():
        eager = run()
    assert len(got.blocks) == N // 16 and reads == len(got.blocks)
    assert graphs["replays"] > 0 and graphs["skipped"] > 0 and bool(np.all(got.converged))
    for f in ("h", "block_costs", "iterations", "converged"):
        assert getattr(got, f).tobytes() == getattr(eager, f).tobytes(), f
    ref = jt.transform_out_of_core(x, w, config=jcfg, **kw)
    np.testing.assert_array_equal(got.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(got.h, np.asarray(ref.h), rtol=RTOL, atol=ATOL)


def test_d_served_program_stops_on_the_device(problem, captured, tmp_path, monkeypatch):
    """A served program's ``GraphCache`` under ``thresh > 0``: its blocks
    replay the cached graphs under the stop, one read a block's call, the
    eager loop's H and costs (tests/test_torch_serving.py holds the served
    values to ``nmf_tpu``'s)."""
    x, w, _ = problem
    path = str(tmp_path / "m.nmfz")
    pt.save_transform(path, w, 40, pt.SolveConfig(max_iter=200, check_every=EVERY, thresh=1e-4),
                      platforms=("cpu",))
    t = pt.load_transform(path, device="cpu")
    _guard_blocks(monkeypatch)
    got = [t(x, seed=1), t(x[:, :40], seed=2)]
    reads, graphs = ps.ACCEL_COUNTS["reads"], _graphs()
    with ps.eager_loop():
        eager = [t(x, seed=1), t(x[:, :40], seed=2)]
    assert reads == 3 and graphs["captures"] == 1 and graphs["skipped"] > 0
    for g, e in zip(got, eager):
        assert g.h.tobytes() == e.h.tobytes()
        assert g.block_costs.tobytes() == e.block_costs.tobytes()
        np.testing.assert_array_equal(g.block_iterations, e.block_iterations)


# ---------------------------------------------------------------- (e)

def test_e_a_capture_under_a_flag_goes_through_when(monkeypatch):
    """``_CudaGraphs.capture(..., pred)`` captures with ``keep_graph=True``
    and hands the graph to ``when``, which wraps it in an ``_IfGraph``; a
    library that cannot make the IF node raises, naming what it needs."""
    made = []

    class _Graph:
        def __init__(self, keep_graph=False):
            made.append(keep_graph)

        def capture_begin(self, pool=None):
            pass

        def capture_end(self):
            pass

        def raw_cuda_graph(self):
            return 1

    class _Stream:
        device = torch.device("cpu")

        def wait_stream(self, other):
            pass

    class _Lib:
        def nmf_if_graph(self, *args):
            return 801          # cudaErrorNotSupported

        def nmf_error_string(self, rc):
            return b"operation not supported"

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: __import__("contextlib").nullcontext())
    monkeypatch.setattr(tfm, "_lib", lambda: _Lib())
    monkeypatch.setattr(tfm, "_index", lambda t: 0)
    api = ps._CudaGraphs()
    with pytest.raises(RuntimeError, match="CUDA 12.4 or later"):
        api.capture(_Stream(), lambda: None, pred=torch.ones((), dtype=torch.bool))
    assert made == [True]
    api.capture(_Stream(), lambda: None)
    assert made == [True, False]


def test_e_the_library_declares_the_conditional_graph():
    """``csrc/graph_if.cu`` is built into the library and its three entry
    points are declared for ctypes as it defines them: the IF node's
    kernel sets the handle from the device flag."""
    src = pathlib.Path(_build._CSRC / "graph_if.cu")
    assert src in _build._SOURCES
    text = src.read_text()
    for name, n_args in (("nmf_if_graph", 5), ("nmf_graph_launch", 2),
                         ("nmf_if_graph_destroy", 2)):
        sig = re.search(rf"int {name}\(([^)]*)\)", text).group(1)
        assert len(sig.split(",")) == n_args == len(_build._SIGNATURES[name][0]), name
        assert _build._SIGNATURES[name][1] == _build._I
    assert "cudaGraphSetConditional(handle, *pred" in text
    assert "cudaGraphCondTypeIf" in text and "cudaGraphAddChildGraphNode" in text
    assert re.search(r'extern "C" \{.*int nmf_if_graph\(', text, re.S)
