"""The captured check-block loop of ``nmf_tpu_torch.models.solver`` on the CPU.

On the card the full-length check blocks of the plain loop run as
replays of captured CUDA graphs, one of a step and one of the check's
close (``run_checked_loop``, ``_BlockGraph``), the counterpart of the JAX
loop's inner ``fori_loop`` under ``jit``.  The CPU
has no graphs, so these tests hold the route's parts:

(a) the block (``check_block``) makes no host read, for each route's step
    and cost, under a dispatch mode that raises on
    ``aten._local_scalar_dense`` (what ``.item()``, ``bool()`` and
    ``float()`` reach);
(b) the captured loop, with a stand-in for the graph API (``_CpuGraphs``):
    at capture the captured part's Python runs and its work is undone, as
    a capture runs no kernel; at a replay the part reruns on the capture's
    own buffers (their addresses checked) and the counts its Python added
    are taken back, as a replay runs no wrapper.  Its results equal the eager
    loop's bit for bit, and ``nmf_tpu``'s to the solve's parity bar
    (tests/test_torch_solver.py: cost history rel 1e-5, factors rtol 1e-4 /
    atol 1e-6, iteration counts and flags exact);
(c) graph lifetimes: a solve's graphs live for its call only and are
    made only where they replay ``MIN_REPLAYS`` blocks and a step's work
    is below ``GRAPH_MAX_WORK``; a ``GraphCache``
    (a served program's) keeps its graphs across calls, each call taking
    its own X, start and seed, freed with its owner; no returned tensor
    aliases a graph's buffer.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import jax  # noqa: E402
import nmf_tpu as jt  # noqa: E402
from nmf_tpu.utils import metrics as jmetrics  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import solver as ps  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.ops.quant import quantize_policy  # noqa: E402
from nmf_tpu_torch.utils import metrics as pmetrics  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, result_to_numpy  # noqa: E402

from oracle import clamp  # noqa: E402

COST_RTOL, RTOL, ATOL, REL_ATOL = 1e-5, 1e-4, 1e-6, 4e-5
FIELDS = ("w", "h", "cost", "cost_history", "iterations", "num_checks", "converged")
M, K, N = 64, 6, 80


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(22)
    x, w, h = (clamp(rng.rand(*s).astype(np.float32)) for s in ((M, N), (M, K), (K, N)))
    mask = (rng.rand(M, N) >= 0.2).astype(np.float32)
    return x, w, h, mask


class _NoHostRead(TorchDispatchMode):
    """Raises on every read of a tensor's value by the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a host read inside a check block")
        return func(*args, **(kwargs or {}))


class _Replayed:
    """A captured graph's stand-in for CPU tensors.  It holds its block
    graph weakly, as a CUDA graph holds nothing of Python; every one made
    is listed in ``MADE`` (weakly) to tell which still live.  Under a flag
    (``_CpuGraphs.when``) a replay runs only where the flag holds, read as
    a CPU tensor's memory (no dispatch: ``_NoHostRead`` lets it pass, as
    the card's IF node reads its flag with no host read)."""

    MADE = []

    def __init__(self, fn):
        # capture: the block's Python runs (the wrappers count), its work
        # does not (the buffers are put back)
        self.fn, self.runner = weakref.WeakMethod(fn), weakref.ref(fn.__self__)
        state = fn.__self__.state()
        saved = [t.clone() for t in state]
        fn()
        for t, s in zip(state, saved):
            t.copy_(s)
        self.ptrs = [t.data_ptr() for t in state]
        self.pred = None
        _Replayed.MADE.append(weakref.ref(self))

    def pool(self):
        return None

    def replay(self):
        # replay: the work runs on the capture's buffers, no wrapper counts
        if self.pred is not None and not self.pred.tolist():
            return
        before = tfm.count_snapshot()
        self.fn()()
        tfm.add_counts(tfm.count_delta(before), -1)
        assert [t.data_ptr() for t in self.runner().state()] == self.ptrs

    @classmethod
    def alive(cls):
        """The block graphs whose stand-in graph still lives."""
        return [g().runner() for g in cls.MADE if g() is not None]


class _CpuGraphs:
    """The graph API of ``solver._GRAPHS`` for CPU tensors."""

    def applies(self, dev):
        return dev.type == "cpu"

    def stream(self, dev):
        return None

    def run_on(self, stream, fn):
        fn()

    def capture(self, stream, fn, pool=None, pred=None):
        graph = _Replayed(fn)
        return graph if pred is None else self.when(pred, graph)

    def when(self, pred, graph):
        graph.pred = pred
        return graph

    def event(self):
        return _Event()


class _Event:
    """A CPU event: the work before it has run when it is recorded."""

    def record(self):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def captured(monkeypatch):
    api = _CpuGraphs()
    monkeypatch.setattr(ps, "_GRAPHS", api)
    _Replayed.MADE = []
    ps.reset_graph_counts()
    return api


def _counts():
    """The block counts (the stop's skipped blocks and waits:
    tests/test_torch_stop_graph.py)."""
    return {k: ps.GRAPH_COUNTS[k] for k in ("warm_ups", "captures", "replays")}


def _same_bits(a, b, where=""):
    for f in FIELDS:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, (where, f)
        assert ta.numpy().tobytes() == tb.numpy().tobytes(), (where, f)


def _held_to_jax(rp, rj):
    rp = result_to_numpy(rp)
    for f in ("iterations", "num_checks", "converged"):
        assert rp[f] == np.asarray(getattr(rj, f)), f
    hj = np.asarray(rj.cost_history)
    np.testing.assert_array_equal(np.isnan(rp["cost_history"]), np.isnan(hj))
    np.testing.assert_allclose(rp["cost_history"], hj, rtol=COST_RTOL)
    np.testing.assert_allclose(rp["cost"], np.asarray(rj.cost), rtol=COST_RTOL)
    np.testing.assert_allclose(rp["w"], np.asarray(rj.w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rp["h"], np.asarray(rj.h), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- (a)

def _routes(problem):
    x, w, h, mask = problem
    cfg = pt.SolveConfig(max_iter=6, check_every=3)
    fam = lambda **kw: dataclasses.replace(cfg, **kw)  # noqa: E731
    pair = quantize_policy(torch.clamp_min(torch.from_numpy(x), cfg.eps), cfg.eps, 0)
    int8 = fam(precision=pt.Precision(x_dtype="int8"))
    return {
        "kl": lambda: pt.solve(x, w, h, cfg, device="cpu"),
        "kl jnp": lambda: pt.solve(x, w, h, fam(backend="jnp"), device="cpu"),
        "bfloat16": lambda: pt.solve(x, w, h, fam(precision=pt.Precision("bfloat16")),
                                     device="cpu"),
        "float32_fast": lambda: pt.solve(x, w, h, fam(precision=pt.Precision("float32_fast")),
                                         device="cpu"),
        "beta": lambda: pt.solve(x, w, h, fam(beta=2.0), device="cpu"),
        "hals": lambda: pt.solve(x, w, h, fam(beta=2.0, algorithm="hals"), device="cpu"),
        "penalized": lambda: pt.solve(x, w, h, fam(l1_h=0.1, l2_w=0.1), device="cpu"),
        "h_only": lambda: pt.solve_h_only(x, w, h, cfg, device="cpu"),
        "h_only beta": lambda: pt.solve_h_only(x, w, h, fam(beta=0.5), device="cpu"),
        "w_only": lambda: pt.solve_w_only(x, w, h, cfg, device="cpu"),
        "semi": lambda: pt.solve_semi(x, w, h, cfg, n_frozen=2, device="cpu"),
        "masked": lambda: pt.solve_masked(x, w, h, mask, cfg, device="cpu"),
        "masked h_only": lambda: pt.solve_masked_h_only(x, w, h, mask, cfg, device="cpu"),
        "int8 pair": lambda: pt.solve(pair, w, h, int8, clamp_inputs=False, device="cpu"),
        "int8 rows": lambda: pt.solve(
            x, w, h, fam(precision=pt.Precision(x_dtype="int8", x_quant_rows=16)), device="cpu"),
    }


ROUTES = ("kl", "kl jnp", "bfloat16", "float32_fast", "beta", "hals", "penalized", "h_only",
          "h_only beta", "w_only", "semi", "masked", "masked h_only", "int8 pair", "int8 rows")


@pytest.mark.parametrize("route", ROUTES)
def test_a_check_block_reads_nothing_back(problem, route, monkeypatch):
    """Every block of each route's solve runs under ``_NoHostRead``: the
    step, the cost, the history write and the relative change read no
    value back, so a capture bakes in nothing of the host."""
    blocks = []
    block = ps.check_block

    def guarded(*a, **k):
        blocks.append(a[8])
        with _NoHostRead():
            return block(*a, **k)

    monkeypatch.setattr(ps, "check_block", guarded)
    res = _routes(problem)[route]()
    assert blocks == [3, 3] and int(res.num_checks) == 2


@pytest.mark.parametrize("read", ["item", "bool", "float"])
def test_a_the_mode_catches_each_host_read(read):
    """The check has teeth: each way of reading a scalar back raises (a
    CPU tensor's ``.tolist()`` reads its memory without a dispatch; on the
    card it copies to the host first, which a capture refuses)."""
    t = torch.ones(2)
    with pytest.raises(AssertionError, match="host read"):
        with _NoHostRead():
            {"item": lambda: t.sum().item(), "bool": lambda: bool(t.sum() > 0),
             "float": lambda: float(t.sum())}[read]()


# ---------------------------------------------------------------- (b)

CASES = {
    "multiple": dict(max_iter=50, check_every=10),
    "tail": dict(max_iter=53, check_every=10),
    "thresh": dict(max_iter=400, check_every=5, thresh=1e-3),
    "untracked": dict(max_iter=50, check_every=10, track_cost=False),
    "seeded": dict(max_iter=60, check_every=10, thresh=2e-3),
}


def _solves(problem, route, jcfg, seed_cost=None):
    """(port's solve, JAX's solve) of a route on the problem."""
    x, w, h, mask = problem
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    kw = {} if seed_cost is None else {"initial_cost": seed_cost}
    if route == "solve":
        return (lambda: pt.solve(x, w, h, pcfg, device="cpu", **kw),
                lambda: jt.solve(x, w, h, jcfg, **kw))
    if route == "h_only":
        return (lambda: pt.solve_h_only(x, w, h, pcfg, device="cpu"),
                lambda: jt.solve_h_only(x, w, h, jcfg))
    if route == "semi":
        return (lambda: pt.solve_semi(x, w, h, pcfg, n_frozen=2, device="cpu"),
                lambda: jt.solve_semi(x, w, h, jcfg, n_frozen=2))
    return (lambda: pt.solve_masked(x, w, h, mask, pcfg, device="cpu"),
            lambda: jt.solve_masked(x, w, h, mask, jcfg))


@pytest.mark.parametrize(
    "route,case", [(r, c) for r in ("solve", "h_only", "semi", "masked") for c in CASES
                   if r == "solve" or c != "seeded"])     # only solve takes a seed cost
def test_b_captured_loop_gives_the_eager_bits_and_jax(problem, route, case, captured):
    jcfg = jt.SolveConfig(**CASES[case])
    seed = None
    if case == "seeded":   # a baseline near the first check's cost: it stops at once
        with ps.eager_loop():
            seed = float(pt.solve(*problem[:3], pt.SolveConfig(max_iter=10, check_every=10),
                                  device="cpu").cost) * (1 + 1e-3)
    ours, theirs = _solves(problem, route, jcfg, seed)
    tfm.reset_counts()
    with ps.eager_loop():
        eager = ours()
    eager_counts = tfm.count_snapshot()
    ps.reset_graph_counts()
    tfm.reset_counts()
    got = ours()
    _same_bits(got, eager, f"{route} {case}")
    assert tfm.count_snapshot() == eager_counts
    full = int(eager.iterations) // jcfg.check_every
    # a stop at the first check still enqueues, and so captures, the blocks
    # after it, which run nothing (tests/test_torch_stop_graph.py)
    assert _counts() == {"warm_ups": 1, "captures": int(full > 1 or case == "seeded"),
                         "replays": full - 1}
    _held_to_jax(got, theirs())
    if case == "seeded":
        assert bool(got.converged) and int(got.iterations) == 10


def test_b_live_metrics_emit_the_eager_triples(problem, captured):
    """``live_metrics`` reads ``(it, cost, rel)`` once a check after each
    replay: the eager loop's triples, and JAX's within its bar."""
    x, w, h, _ = problem
    jcfg = jt.SolveConfig(max_iter=40, check_every=10, live_metrics=True)
    pcfg = config_from_dict(dataclasses.asdict(jcfg))

    def emissions(fn, metrics):
        events = []
        metrics.set_live_handler(lambda *e: events.append(e))
        try:
            res = fn()
            jax.effects_barrier()
        finally:
            metrics.set_live_handler(None)
        return res, events

    got, ours = emissions(lambda: pt.solve(x, w, h, pcfg, device="cpu"), pmetrics)
    assert ps.GRAPH_COUNTS["replays"] == 3
    with ps.eager_loop():
        eager, ours_eager = emissions(lambda: pt.solve(x, w, h, pcfg, device="cpu"), pmetrics)
    assert ps.GRAPH_COUNTS["replays"] == 3    # the eager run replayed nothing
    _same_bits(got, eager)
    assert np.array(ours).tobytes() == np.array(ours_eager).tobytes()
    assert [e[0] for e in ours] == [10, 20, 30, 40]
    _, theirs = emissions(lambda: jt.solve(x, w, h, jcfg), jmetrics)
    assert [e[0] for e in theirs] == [e[0] for e in ours]
    np.testing.assert_allclose([e[1] for e in ours], [e[1] for e in theirs], rtol=COST_RTOL)
    rel_o, rel_j = np.array([e[2] for e in ours]), np.array([e[2] for e in theirs])
    assert np.isnan(rel_o[0]) and np.isnan(rel_j[0])
    np.testing.assert_allclose(rel_o[1:], rel_j[1:], rtol=REL_ATOL, atol=REL_ATOL)


def test_b_replays_count_the_captured_launches(captured):
    """A replay runs no wrapper: the launches the capture recorded are
    added at each replay and taken back from the capture, so the counts
    equal the kernels that ran (here a step and a cost that count as the
    wrappers do on the card)."""
    def step(w, h, x):
        tfm.LAUNCHES["update_h"] += 1
        tfm.LAUNCHES["update_w"] += 1
        return w * 0.5 + x[:, :1], h

    def cost(x, w, h):
        tfm.LAUNCHES["kl_cost"] += 1
        return torch.sum(w)

    x, w, h = torch.ones(4, 3), torch.ones(4, 2), torch.ones(2, 3)
    cfg = pt.SolveConfig(max_iter=57, check_every=10)
    tfm.reset_counts()
    res = ps.run_checked_loop(x, w, h, cfg, step, cost)
    assert (tfm.LAUNCHES["update_h"], tfm.LAUNCHES["update_w"], tfm.LAUNCHES["kl_cost"]) \
        == (57, 57, 6)
    assert _counts() == {"warm_ups": 1, "captures": 1, "replays": 4}
    with ps.eager_loop():
        eager = ps.run_checked_loop(x, w, h, cfg, step, cost)
    _same_bits(res, eager)
    tfm.reset_counts()        # no count outlives the test


def test_b_no_graph_where_the_loop_stays_eager(problem, captured, monkeypatch):
    """A loop with a mesh's ``all_reduce``, ``graphs=False`` (streamed,
    COO, a sharded tile-sparse loop; the single-device tiled loops replay:
    tests/test_torch_tiled_graph.py), a run shorter than one block, a call
    that would replay fewer than ``MIN_REPLAYS`` blocks and a step whose
    work reaches ``GRAPH_MAX_WORK`` capture nothing; one block more, or one
    unit of work less, and the call replays.  (The accelerated loop's graphs:
    tests/test_torch_accel_graph.py.)"""
    x, w, h, _ = problem
    xt, wt, ht = (torch.from_numpy(a) for a in (x, w, h))
    cfg = pt.SolveConfig(max_iter=20, check_every=5)
    step, cost = ps.resolve_step_fn(cfg), ps._cost_fn(cfg)
    ps.run_checked_loop(xt, wt, ht, cfg, step, cost, all_reduce=lambda c: c)
    ps.run_checked_loop(xt, wt, ht, cfg, step, cost, graphs=False)
    pt.solve(x, w, h, pt.SolveConfig(max_iter=4, check_every=5), device="cpu")
    few = pt.SolveConfig(max_iter=5 * ps.MIN_REPLAYS + 4, check_every=5)
    pt.solve(x, w, h, few, device="cpu")
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", M * N * K)      # the device sets the pace
    pt.solve(x, w, h, cfg, device="cpu")
    assert _counts() == {"warm_ups": 0, "captures": 0, "replays": 0}
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", M * N * K + 1)
    ps.run_checked_loop(xt, wt, ht, dataclasses.replace(few, max_iter=5 * ps.MIN_REPLAYS + 5),
                        step, cost)
    assert _counts() == {"warm_ups": 1, "captures": 1, "replays": ps.MIN_REPLAYS}
    ps.reset_graph_counts()
    pt.solve(x, w, h, cfg, device="cpu")
    assert _counts() == {"warm_ups": 1, "captures": 1, "replays": 3}


# ---------------------------------------------------------------- (c)

def _not_aliased(res):
    """No tensor of a result shares storage with a live graph's buffer."""
    held = {t.untyped_storage().data_ptr() for r in _Replayed.alive() for t in r.state()}
    for f in ("w", "h", "cost", "cost_history"):
        assert getattr(res, f).untyped_storage().data_ptr() not in held, f


def test_c_semi_graphs_live_for_their_call_only(problem, captured):
    """``solve_semi``'s step closes over the call's frozen columns: two
    calls with different frozen columns each get a graph of their own,
    freed when the call returns, and each gives its eager bits."""
    x, w, h, _ = problem
    cfg = pt.SolveConfig(max_iter=40, check_every=10)
    got = [pt.solve_semi(x, w, h, cfg, n_frozen=f, device="cpu") for f in (1, 4)]
    assert len(_Replayed.MADE) == 2 * 2 and not _Replayed.alive()   # a step and a close each
    assert _counts() == {"warm_ups": 2, "captures": 2, "replays": 6}
    with ps.eager_loop():
        eager = [pt.solve_semi(x, w, h, cfg, n_frozen=f, device="cpu") for f in (1, 4)]
    for g, e in zip(got, eager):
        _same_bits(g, e)
    assert not torch.equal(got[0].w, got[1].w)


def test_c_cached_graph_takes_each_calls_start(problem, captured):
    """A ``GraphCache`` keeps one graph for a layout across calls: the
    first block of its first call runs eagerly, every later block replays.
    Each call's X (another tensor of the same layout too), W, H and seed
    cost go through the graph's own buffers, never baked in."""
    x, w, h, _ = problem
    cfg = pt.SolveConfig(max_iter=40, check_every=10, thresh=1e-6)
    dev = torch.device("cpu")
    xp, wp, hp = ps._prep(x, w, h, cfg, True, dev)
    x2, w2, h2 = ps._prep(x[::-1].copy(), np.roll(w, 1, axis=0), np.roll(h, 1, axis=1), cfg,
                          True, dev)
    step, cost = ps.resolve_step_fn(cfg), ps._cost_fn(cfg)
    cache = ps.GraphCache()
    runs = [(xp, wp, hp, None), (xp, w2, h2, None), (xp, wp, hp, 1e9), (x2, w2, h2, None)]
    got = [ps.run_checked_loop(a, b, c, cfg, step, cost, d, graphs=cache) for a, b, c, d in runs]
    assert len(cache.graphs) == 1 and len(_Replayed.MADE) == 2
    assert _counts() == {"warm_ups": 1, "captures": 1, "replays": 3 + 4 + 4 + 4}
    with ps.eager_loop():
        eager = [ps.run_checked_loop(a, b, c, cfg, step, cost, d, graphs=cache)
                 for a, b, c, d in runs]
    for g, e in zip(got, eager):
        _same_bits(g, e)
        _not_aliased(g)
    assert not np.isnan(float(got[0].cost_history[0]))
    assert not torch.equal(got[0].w, got[1].w) and not torch.equal(got[1].w, got[3].w)


def test_c_served_blocks_reuse_the_cached_program(problem, captured, tmp_path):
    """Blocks served through one ``ServingTransform`` run the program's
    cached graph: each call gives the eager loop's H and costs, and
    nothing returned aliases a graph's buffer."""
    x, w, _, _ = problem
    path = str(tmp_path / "m.nmfz")
    pt.save_transform(path, w, 40, pt.SolveConfig(max_iter=30, check_every=10),
                      platforms=("cpu",))
    t = pt.load_transform(path, device="cpu")
    calls = [t(x[:, :40], seed=3), t(x, seed=1), t(x[:, 20:], seed=2)]
    # five blocks of three checks: all but the first one's first replayed
    assert _counts() == {"warm_ups": 1, "captures": 1, "replays": 5 * 3 - 1}
    with ps.eager_loop():
        eager = [t(x[:, :40], seed=3), t(x, seed=1), t(x[:, 20:], seed=2)]
    for g, e in zip(calls, eager):
        assert g.h.tobytes() == e.h.tobytes()
        assert g.block_costs.tobytes() == e.block_costs.tobytes()
        np.testing.assert_array_equal(g.block_iterations, e.block_iterations)
    held = pt.solve_h_only(x, w, np.ones((K, N), np.float32), pt.SolveConfig(max_iter=30,
                           check_every=10), device="cpu")
    _not_aliased(held)


def test_c_one_block_calls_replay_from_the_second(problem, captured, tmp_path):
    """A stream of one-block served calls: the first block runs eagerly,
    the second is captured and replayed, the rest replay; the graphs go
    with the transform that holds them."""
    x, w, _, _ = problem
    path = str(tmp_path / "m.nmfz")
    pt.save_transform(path, w, 20, pt.SolveConfig(max_iter=10, check_every=10),
                      platforms=("cpu",))
    t = pt.load_transform(path, device="cpu")
    got = t(x)
    assert _counts() == {"warm_ups": 1, "captures": 1, "replays": 3}
    with ps.eager_loop():
        eager = t(x)
    assert got.h.tobytes() == eager.h.tobytes()
    assert got.block_costs.tobytes() == eager.block_costs.tobytes()
    assert len(_Replayed.alive()) == 2
    del t
    assert not _Replayed.alive()


def test_c_a_solve_holds_no_graph_after_it_returns(problem, captured):
    """A solve's graph and its buffers are freed when the call returns,
    without a collection: deleting X leaves no graph behind (on the card
    the graph's memory pool goes with it)."""
    x, w, h, _ = problem
    xt = torch.from_numpy(x.copy())
    cfg = pt.SolveConfig(max_iter=50, check_every=10)
    gc.disable()
    try:
        res = pt.solve(xt, w, h, cfg, device="cpu", clamp_inputs=False)
        assert _counts()["replays"] == 4 and len(_Replayed.MADE) == 2
        assert not _Replayed.alive()
        del xt
        assert not _Replayed.alive()
    finally:
        gc.enable()
    with ps.eager_loop():
        _same_bits(res, pt.solve(x, w, h, cfg, device="cpu", clamp_inputs=False))


def test_b_the_library_takes_a_replays_launches():
    """The library's per-Mode pass-1 counts of K1, K2 and K3 take a replay's
    launches through ``nmf_add_launches`` (counter, Mode, n), declared for
    ctypes as the C source defines it; before the library is loaded the
    snapshot holds the Python counts alone (nothing is built for it)."""
    import pathlib
    import re

    from nmf_tpu_torch.ops.kernels import _build

    assert _build._SIGNATURES["nmf_add_launches"] == ([_build._I] * 3, _build._I)
    src = (pathlib.Path(_build.__file__).parents[2] / "csrc" / "fused_mu.cu").read_text()
    body = src[src.index("int nmf_add_launches(int counter, int mode, int n) {"):]
    body = body[: body.index("\n}\n")]
    assert "kl_launches[mode] += n" in body and "partial_launches[counter][mode] += n" in body
    assert re.search(r'extern "C" \{.*int nmf_add_launches\(', src, re.S)
    if not tfm._lib.cache_info().currsize:
        assert all(key[0] != "lib" for key in tfm.count_snapshot())
