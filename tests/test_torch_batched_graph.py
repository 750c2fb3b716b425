"""The captured batched loop of ``nmf_tpu_torch.parallel.batched`` on the CPU.

On the card the full check blocks of a batched solve run as replays of
captured CUDA graphs over stacked static state (``run_batched_loop``,
``_BatchGraph``, ``_BatchAccelGraph``), the counterpart of JAX's one
program ``jit(vmap(run_checked_loop))``: each member's cost, history,
check count, stop and (accelerated) momentum and accept test stay on the
device.  The CPU has no graphs, so these tests hold the route with
tests/test_torch_graph.py's stand-in for the graph API (``_CpuGraphs``: a
capture runs the part's Python and undoes its work, a replay reruns it on
the capture's buffers and takes back what its wrappers counted):

(a) host reads: with ``thresh == 0`` a graphed batched solve reads nothing
    back (a dispatch mode raises on ``aten._local_scalar_dense``), under
    ``thresh > 0`` (the stop on the device) and accelerated (the redo under
    the device's reject flag) one counted read at the end
    (``ACCEL_COUNTS["reads"]``);
(b) on each route (the member-axis kernels' wrappers, ``backend="jnp"``,
    the beta and HALS families member by member, masked batches, restarts
    with frozen columns, the rank sweep, accelerated batches) the graphed
    loop gives the eager loop's bits: w, h, cost, history, iterations,
    checks, converged, momentum, and the launches (the extrapolation
    kernel's aside: the eager loop extrapolates with plain ops); and one
    case against ``nmf_tpu.parallel.batched.solve_batched`` at
    tests/test_torch_batched.py's tolerance (factors rtol 5e-5 / atol
    1e-7, costs rel 1e-5);
(c) where no graph is made (``eager_loop()``; ``MIN_REPLAYS`` blocks;
    B x M x N x K at ``GRAPH_MAX_WORK``), the tile-sparse batch
    replaying, a call's graphs freed on return;
(d) the kernels' side: the extrapolation's plain version with a ``[B]``
    momentum gives member i the bits of the 2-D ``extrapolate`` at
    ``m[i]``; ``fused_mu._sums`` inside a capture runs its member sums
    into the capture, making and replaying no graph of its own.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.parallel import batched as jb  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import solver as ps  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.parallel import batched as pb  # noqa: E402

from oracle import clamp  # noqa: E402
from test_torch_graph import _CpuGraphs, _NoHostRead, _Replayed  # noqa: E402

B, M, K, N = 4, 24, 5, 40
FIELDS = ("w", "h", "cost", "cost_history", "iterations", "num_checks", "converged", "momentum")
F32 = dict(rtol=5e-5, atol=1e-7)
# accelerated runs that reject: a pinned momentum of 0.999, a check every
# iteration (tests/test_torch_batched.py::test_accelerated_members_decide_apart)
REJECTING = dict(max_iter=30, check_every=1, accelerate=True, accel_momentum=0.999,
                 accel_momentum_max=0.999, accel_grow=1.0)


@pytest.fixture(scope="module")
def stack():
    rng = np.random.RandomState(24)
    x = clamp(rng.rand(B, M, N).astype(np.float32))
    # member 0 is nearly rank one: under a threshold it stops first
    x[0] = clamp(np.outer(rng.rand(M), rng.rand(N)).astype(np.float32))
    w = clamp(rng.rand(B, M, K).astype(np.float32))
    h = clamp(rng.rand(B, K, N).astype(np.float32))
    mask = (rng.rand(B, M, N) >= 0.2).astype(np.float32)
    return x, w, h, mask


@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(ps, "_GRAPHS", _CpuGraphs())
    _Replayed.MADE = []
    ps.reset_graph_counts()


@pytest.fixture
def counted(monkeypatch):
    """K1-K3 and the extrapolation counted as the card counts them: one
    launch a wrapper call (a batched call once), in the counts a capture
    takes back and a replay adds."""
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


def _counts():
    """The block counts (the stop's skipped blocks and waits:
    tests/test_torch_stop_graph.py), and the accelerated loop's (its host
    reads the batched loop's too)."""
    return ({k: ps.GRAPH_COUNTS[k] for k in ("warm_ups", "captures", "replays")},
            dict(ps.ACCEL_COUNTS))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_bits(a, b, where=""):
    for f in FIELDS:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, (where, f)
        assert _bits(ta).numpy().tobytes() == _bits(tb).numpy().tobytes(), (where, f)


def _k123(counts):
    return {key: n for key, n in counts.items() if key[0] != "EXTRAP_LAUNCHES"}


def _cfg(**kw):
    fields = dict(max_iter=50, check_every=10)
    fields.update(kw)
    return pt.SolveConfig(**fields)


def _graphed_and_eager(fn):
    """(graphed result, its launches and graph counts, eager result, its
    launches): ``fn`` on the captured route, then inside ``eager_loop``."""
    tfm.reset_counts()
    got = fn()
    counts, graphs = tfm.count_snapshot(), _counts()
    tfm.reset_counts()
    with ps.eager_loop():
        eager = fn()
    return got, counts, graphs, eager, tfm.count_snapshot()


def _routes(stack):
    """name -> (the call, its full blocks)."""
    x, w, h, mask = stack
    sweep_ranks = [3, 5, 5, 4]
    ws, hs = w.copy(), h.copy()
    ws[:, :, :2] = ws[0, :, :2]          # the frozen columns: one shared template
    return {
        "kernels": (lambda: pt.solve_batched(x, w, h, _cfg(), device="cpu"), 5),
        "kernels thresh 0 untracked": (
            lambda: pt.solve_batched(x, w, h, _cfg(track_cost=False), device="cpu"), 5),
        "tail": (lambda: pt.solve_batched(x, w, h, _cfg(max_iter=53), device="cpu"), 5),
        "thresh": (lambda: pt.solve_batched(
            x, w, h, _cfg(max_iter=400, thresh=2e-4), device="cpu"), None),
        "jnp": (lambda: pt.solve_batched(x, w, h, _cfg(backend="jnp"), device="cpu"), 5),
        "jnp thresh": (lambda: pt.solve_batched(
            x, w, h, _cfg(max_iter=400, thresh=2e-4, backend="jnp"), device="cpu"), None),
        "bfloat16": (lambda: pt.solve_batched(
            x, w, h, _cfg(precision=pt.Precision("bfloat16", "bfloat16", "bfloat16")),
            device="cpu"), 5),
        "int8": (lambda: pt.solve_batched(
            x, w, h, _cfg(precision=pt.Precision(x_dtype="int8")), device="cpu"), 5),
        "beta": (lambda: pt.solve_batched(x, w, h, _cfg(beta=2.0), device="cpu"), 5),
        "hals": (lambda: pt.solve_batched(
            x, w, h, _cfg(beta=2.0, algorithm="hals"), device="cpu"), 5),
        "penalized": (lambda: pt.solve_batched(x, w, h, _cfg(l1_h=0.02, l2_w=0.01),
                                               device="cpu"), 5),
        "masked": (lambda: pt.solve_batched(x, w, h, _cfg(), mask=mask, device="cpu"), 5),
        "masked thresh": (lambda: pt.solve_batched(
            x, w, h, _cfg(max_iter=400, thresh=2e-4), mask=mask, device="cpu"), None),
        "restarts n_frozen": (lambda: pt.solve_restarts(
            x[1], w0s=ws, h0s=hs, config=_cfg(), n_frozen=2, device="cpu").results, 5),
        "rank sweep": (lambda: pt.solve_rank_sweep(
            x[1], sweep_ranks, _cfg(), seed=3, device="cpu").results, 5),
        "stability": (lambda: pt.rank_stability(
            x[1], [2, 4], n_restarts=2, config=_cfg(), seed=0, device="cpu").sweep.results, 5),
        "accelerated": (lambda: pt.solve_batched(x, w, h, _cfg(accelerate=True), device="cpu"),
                        5),
        "accelerated thresh": (lambda: pt.solve_batched(
            x, w, h, _cfg(max_iter=400, thresh=2e-4, accelerate=True), device="cpu"), None),
        "accelerated rejecting": (lambda: pt.solve_batched(
            x, w, h, pt.SolveConfig(**REJECTING), device="cpu"), REJECTING["max_iter"]),
        "accelerated beta": (lambda: pt.solve_batched(
            x, w, h, _cfg(beta=2.0, accelerate=True), device="cpu"), 5),
        "accelerated sweep": (lambda: pt.solve_rank_sweep(
            x[1], sweep_ranks, _cfg(accelerate=True), seed=3, device="cpu").results, 5),
    }


ROUTES = ("kernels", "kernels thresh 0 untracked", "tail", "thresh", "jnp", "jnp thresh",
          "bfloat16", "int8", "beta", "hals", "penalized", "masked", "masked thresh",
          "restarts n_frozen", "rank sweep", "stability", "accelerated", "accelerated thresh",
          "accelerated rejecting", "accelerated beta", "accelerated sweep")


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("route", ["kernels", "jnp", "masked", "hals", "rank sweep",
                                   "kernels thresh 0 untracked"])
def test_a_thresh_zero_reads_nothing_back(stack, route, captured):
    """The whole graphed solve at ``thresh == 0`` runs under ``_NoHostRead``:
    its prep, its blocks, the result's counts (made on the device) read
    nothing back, and no read is counted."""
    fn, blocks = _routes(stack)[route]
    with _NoHostRead():
        res = fn()
    assert _counts() == ({"warm_ups": 1, "captures": 1, "replays": blocks - 1},
                         {"redo_eager": 0, "redo_replays": 0, "reads": 0})
    assert int(res.iterations[0]) == 50


@pytest.mark.parametrize("route", ["thresh", "masked thresh", "accelerated",
                                   "accelerated thresh", "accelerated rejecting"])
def test_a_one_counted_read_a_check(stack, route, captured):
    """Under ``thresh > 0`` and under ``accelerate`` one counted read, at the
    end (each member's checks and stop, the redos): the stop and the
    accept test are the device's, and every read of the solve is a
    counted one."""
    fn = _routes(stack)[route][0]
    with _NoHostRead():
        fn()
    graphs, accel = _counts()
    assert accel["reads"] == 1 and accel["redo_eager"] == 0
    if route == "accelerated rejecting":
        assert accel["redo_replays"] > 0
    assert graphs["replays"] > 0


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("route", ROUTES)
def test_b_graphed_gives_the_eager_bits(stack, route, captured, counted):
    fn, blocks = _routes(stack)[route]
    got, counts, graphs, eager, eager_counts = _graphed_and_eager(fn)
    _same_bits(got, eager, route)
    accel = "accelerated" in route
    assert _k123(counts) == _k123(eager_counts)
    if accel:
        assert counts["EXTRAP_LAUNCHES", "extrapolate"] == int(got.iterations.max())
        assert eager_counts["EXTRAP_LAUNCHES", "extrapolate"] == 0
    if route in ("kernels", "tail", "thresh", "accelerated"):
        assert counts["LAUNCHES", "update_h"] >= int(got.iterations.max()) > 0
    full = int(got.iterations.max()) // (1 if route == "accelerated rejecting" else 10)
    if blocks is not None:
        assert full == blocks
    assert graphs[0]["warm_ups"] == 1 and graphs[0]["replays"] == full - 1
    assert graphs[0]["captures"] == 1 + int(accel)    # the redo's beside the accelerated part
    assert not _Replayed.alive()


def test_b_members_stop_apart_on_the_device(stack, captured):
    """``thresh > 0``: the members stop at different checks, each held at
    its state while the others run on; the counts come from the device."""
    got = _routes(stack)["thresh"][0]()
    its = got.iterations.numpy()
    assert len(set(its.tolist())) > 1 and got.converged.any()
    assert got.iterations.dtype == torch.int32 and got.num_checks.dtype == torch.int32
    assert got.converged.dtype == torch.bool
    np.testing.assert_array_equal(got.num_checks.numpy(), its // 10)
    for i in range(B):
        hist = got.cost_history[i].numpy()
        assert np.isnan(hist[int(got.num_checks[i]):]).all()
        assert not np.isnan(hist[:int(got.num_checks[i])]).any()


def test_b_a_block_one_member_rejects(stack, captured, monkeypatch):
    """The rejecting run has a replayed block in which some members reject
    and the others accept: the redo runs for all and is kept for the
    rejecting ones only, the eager loop's bits."""
    seen = []
    close = pb._BatchAccelGraph._redo_close

    def recording(self):
        seen.append(int(self.rej.sum()))
        close(self)

    monkeypatch.setattr(pb._BatchAccelGraph, "_redo_close", recording)
    fn = _routes(stack)["accelerated rejecting"][0]
    got = fn()
    assert any(0 < k < B for k in seen), seen
    assert ps.ACCEL_COUNTS["redo_replays"] > 0
    with ps.eager_loop():
        eager = fn()
    _same_bits(got, eager)
    assert float(got.momentum.min()) < 0.999     # a reject shrank a momentum


def test_b_graphed_route_held_to_jax(stack, captured):
    """The graphed route against ``nmf_tpu.parallel.batched.solve_batched``
    from the same NumPy inputs, at tests/test_torch_batched.py's tolerance
    and its ``thresh`` case's config (12 iterations, a check every 2)."""
    x, w, h, _ = stack
    fields = dict(max_iter=12, check_every=2, thresh=1e-3)
    got = pt.solve_batched(x, w, h, pt.SolveConfig(**fields), device="cpu")
    assert ps.GRAPH_COUNTS["replays"] > 0
    ref = jb.solve_batched(x, w, h, jt.SolveConfig(**fields))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.num_checks.numpy(), np.asarray(ref.num_checks))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), **F32)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h), **F32)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
    np.testing.assert_allclose(got.cost_history.numpy(), np.asarray(ref.cost_history),
                               rtol=1e-5)


def test_b_member_is_its_2d_solve(stack, captured):
    """Member i of the graphed batch is the 2-D solve of member i, bit for
    bit (the eager 2-D loop here: its own graphs are
    tests/test_torch_graph.py's)."""
    x, w, h, _ = stack
    cfg = _cfg(max_iter=400, thresh=2e-4)
    got = pt.solve_batched(x, w, h, cfg, device="cpu")
    with ps.eager_loop():
        ones = [pt.solve(x[i], w[i], h[i], cfg, device="cpu") for i in range(B)]
    for i, one in enumerate(ones):
        assert torch.equal(got.w[i], one.w) and torch.equal(got.h[i], one.h)
        assert torch.equal(got.cost[i], one.cost)
        assert int(got.iterations[i]) == int(one.iterations)
        assert bool(got.converged[i]) == bool(one.converged)


# ---------------------------------------------------------------- (c)

def test_c_no_graph_where_the_loop_stays_eager(stack, captured, monkeypatch):
    """``eager_loop()``, ``MIN_REPLAYS`` full blocks and B x M x N x K at
    ``GRAPH_MAX_WORK`` run eagerly; one block more, or one unit of work
    less, and the call replays."""
    x, w, h, _ = stack
    cfg = _cfg()
    with ps.eager_loop():
        pt.solve_batched(x, w, h, cfg, device="cpu")
    few = _cfg(max_iter=10 * ps.MIN_REPLAYS + 4)
    pt.solve_batched(x, w, h, few, device="cpu")
    pt.solve_batched(x, w, h, dataclasses.replace(few, accelerate=True), device="cpu")
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", B * M * N * K)
    pt.solve_batched(x, w, h, cfg, device="cpu")
    pt.solve_batched(x, w, h, dataclasses.replace(cfg, accelerate=True), device="cpu")
    assert _counts() == ({"warm_ups": 0, "captures": 0, "replays": 0},
                         {"redo_eager": 0, "redo_replays": 0, "reads": 0})
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", B * M * N * K + 1)
    pt.solve_batched(x, w, h, _cfg(max_iter=10 * (ps.MIN_REPLAYS + 1)), device="cpu")
    assert _counts()[0] == {"warm_ups": 1, "captures": 1, "replays": ps.MIN_REPLAYS}


def test_c_tiled_batch_replays(captured):
    """The tile-sparse batch does not stay eager: its full blocks replay
    (``jax.jit(jax.vmap(run_checked_loop))``'s counterpart, the plain
    sweeps member by member in the step's graph) and give the eager
    loop's bits, the first block eager and the other four replayed
    (tests/test_torch_tiled_graph.py holds the batch to ``nmf_tpu``)."""
    rng = np.random.RandomState(2)
    xs = [np.zeros((64, 64), np.float32) for _ in range(2)]
    for x in xs:
        x[:32, :32] = rng.rand(32, 32)
    ws, hs = rng.rand(2, 64, 3).astype(np.float32), rng.rand(2, 3, 64).astype(np.float32)
    got, _, graphs, eager, _ = _graphed_and_eager(lambda: pt.solve_sparse_tiled_batched(
        xs, ws, hs, _cfg(), chunk=2, tile=(32, 32), device="cpu"))
    assert int(got.iterations[0]) == 50
    assert graphs[0] == {"warm_ups": 1, "captures": 1, "replays": 4}
    _same_bits(got, eager)


def test_c_graphs_live_for_their_call_only(stack, captured):
    """A batched solve's graphs and buffers are freed when it returns, and
    nothing it returned aliases one."""
    x, w, h, _ = stack
    for cfg in (_cfg(max_iter=400, thresh=2e-4), _cfg(accelerate=True)):
        _Replayed.MADE = []
        res = pt.solve_batched(x, w, h, cfg, device="cpu")
        # a step and a close a part (accelerated: and the redo's)
        assert len(_Replayed.MADE) == 2 * (1 + cfg.accelerate) and not _Replayed.alive()
        again = pt.solve_batched(x, w, h, cfg, device="cpu")
        _same_bits(res, again)


# ---------------------------------------------------------------- (d)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d_member_momentum_gives_each_member_its_2d_bits(dtype):
    """``extrapolate_plain`` with a ``[B]`` momentum gives member i the bits
    of the 2-D ``extrapolate`` at ``m[i]``, and so does the wrapper's CPU
    route for both factors, the iterate copied."""
    rng = np.random.RandomState(7)
    moms = np.array([0.8144469857215881, 0.5, 0.999, 0.0, 0.3], np.float32)
    b = moms.size
    new_w, old_w = (torch.from_numpy(rng.rand(b, 9, 4).astype(np.float32)).to(dtype)
                    for _ in range(2))
    new_h, old_h = (torch.from_numpy(rng.rand(b, 4, 7).astype(np.float32)).to(dtype)
                    for _ in range(2))
    new_w[0, 0, :2] = torch.tensor([1e-30, 3e-16]).to(dtype)     # the clamp's cases
    m = torch.from_numpy(moms)
    got = tfm.extrapolate_plain(new_w, old_w, m, 2.2204e-16)
    for i in range(b):
        want = ps.extrapolate(new_w[i], old_w[i], float(moms[i]), 2.2204e-16)
        assert torch.equal(_bits(got[i]), _bits(want)), i
    prev_w, prev_h = old_w.clone(), old_h.clone()
    ex_w, ex_h = torch.empty_like(new_w), torch.empty_like(new_h)
    tfm.extrapolate_into(((new_w, prev_w, ex_w), (new_h, prev_h, ex_h)), m, 2.2204e-16)
    assert torch.equal(prev_w, new_w) and torch.equal(prev_h, new_h)
    for i in range(b):
        assert torch.equal(_bits(ex_h[i]), _bits(ps.extrapolate(new_h[i], old_h[i],
                                                                float(moms[i]), 2.2204e-16)))
        assert torch.equal(_bits(ex_w[i]), _bits(got[i]))


def test_d_sums_inside_a_capture_make_no_graph(monkeypatch):
    """Inside a capture ``fused_mu._sums`` runs the member sums themselves
    (``_member_sums``, the same ops, so the same bits), into the capture:
    no graph of its own is made, nested or replayed, and its cache of
    graphs for eager calls is left as it was."""
    rng = np.random.RandomState(3)
    t = torch.from_numpy(rng.rand(3, 6, 5).astype(np.float32))
    before = dict(tfm._SUM_GRAPHS)

    def no_graph(*a, **k):
        raise AssertionError("a graph made inside a capture")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    for dim in (-2, -1):
        got = tfm._sums(t, dim)
        want = torch.stack([torch.sum(t[i], dim=dim, dtype=torch.float32) for i in range(3)])
        assert torch.equal(got, want)
    assert dict(tfm._SUM_GRAPHS) == before


def test_d_the_library_takes_a_member_momentum():
    """``nmf_extrapolate`` takes the members' count after the momentum's
    pointer, as ``csrc/extrapolate.cu`` defines it, and reads member i's
    momentum for its slice."""
    import pathlib
    import re

    from nmf_tpu_torch.ops.kernels import _build

    text = pathlib.Path(_build._CSRC / "extrapolate.cu").read_text()
    sig = re.search(r"int nmf_extrapolate\(([^)]*)\)", text).group(1)
    assert "const void* momentum, int members" in " ".join(sig.split())
    assert "momentum + uj / per" in text and "n0 % members" in text
