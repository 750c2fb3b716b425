"""The captured accelerated loop of ``nmf_tpu_torch.models.solver`` on the CPU.

On the card the full check blocks of the accelerated loop run as replays
of captured CUDA graphs over static state (``run_checked_loop``,
``_AccelGraph``), the counterpart of the JAX loop's one-program body: the
momentum, the accept test, the momentum's grow or shrink, the history
write, the relative change and the stop stay on the device, and the redo
replays under an IF node on the device's reject flag, so the host reads
the card once, at the end (``solver._host_read``).  The CPU has no graphs,
so these tests hold the route
with tests/test_torch_graph.py's stand-in for the graph API
(``_CpuGraphs``: a capture runs the part's Python and undoes its work, a
replay reruns it on the capture's buffers and takes back what its wrappers
counted; under a flag a replay runs only where the flag holds):

(a) a graphed accelerated solve makes no host read but the counted one
    at its end (``ACCEL_COUNTS["reads"]``), on accept and on reject alike,
    at ``thresh > 0`` too (and one a check more for live metrics), under
    a dispatch mode that raises on ``aten._local_scalar_dense``;
(b) on each route, the graphed loop gives the eager ``_run_accel_loop``'s
    bits (w, h, cost, history, counts, momentum; the carry of a segment;
    the live triples) and launches, the extrapolation kernel's aside (the
    eager loop extrapolates with plain ops), and ``nmf_tpu.solve(
    accelerate=True)``'s values: counts, accept sequence and momentum
    exactly, and the history and factors at the route's bar (``BARS``;
    measured on this problem after 40 iterations): f32 routes as
    tests/test_torch_accel.py holds f32 state (history rel 1e-5, factors
    rtol 1e-4 / atol 1e-6; measured 4.5e-7, 4.2e-5); ``float32_fast``,
    penalized, semi and masked as its long runs (factors by relative
    Frobenius norm 1e-3, where the extrapolation carries last-ulp
    differences past 1e-4 entrywise; measured 2.1e-5, 1.3e-6); bf16 state
    as it holds bf16 state (history 1e-3, Frobenius 5e-2); HALS as
    tests/test_torch_families.py (Frobenius 1e-4; measured 6.4e-6); the
    ``bfloat16`` GEMM policy as tests/test_torch_precision.py holds its
    solves (history 1e-4, factors 2e-2, here by Frobenius norm; measured
    1.3e-5, 4.1e-3);
(c) where no graph is made: a mesh's ``all_reduce``, ``graphs=False``,
    ``eager_loop()``, a step at ``GRAPH_MAX_WORK``, ``MIN_REPLAYS`` blocks or
    fewer; a solve's graphs live for its call, a ``GraphCache``'s (a served
    accelerated program's) across calls.

The extrapolation's device-momentum form (``fused_mu.extrapolate_plain``,
the kernel's plain version) gives ``extrapolate``'s bits, which are JAX's:
tests/test_torch_accel.py::test_extrapolate_bit_equal_to_jax.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import nmf_tpu as jt  # noqa: E402
from nmf_tpu.utils import metrics as jmetrics  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import solver as ps  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.ops.quant import quantize_policy  # noqa: E402
from nmf_tpu_torch.utils import metrics as pmetrics  # noqa: E402
from nmf_tpu_torch.utils.convert import accel_state_from, config_from_dict  # noqa: E402

from oracle import clamp  # noqa: E402
from test_torch_accel import REJECTING, _assert_match, _f32, _monotone, _trim, _wide  # noqa: E402
from test_torch_graph import _CpuGraphs, _NoHostRead, _Replayed  # noqa: E402

M, K, N = 64, 6, 80
ITERS, EVERY = 40, 5                    # 8 full blocks: the first eager, 7 replayed
FIELDS = ("w", "h", "cost", "cost_history", "iterations", "num_checks", "converged", "momentum")
# a route's bar against nmf_tpu: (history rel, factors ("entry", rtol,
# atol) or ("fro", relative Frobenius norm)); see the module docstring
BARS = {
    "f32": (1e-5, ("entry", 1e-4, 1e-6)),
    "drift": (1e-5, ("fro", 1e-3)),
    "bf16 gemm": (1e-4, ("fro", 2e-2)),
    "bf16 state": (1e-3, ("fro", 5e-2)),
    "hals": (1e-5, ("fro", 1e-4)),
}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(23)
    x, w, h = (clamp(rng.rand(*s).astype(np.float32)) for s in ((M, N), (M, K), (K, N)))
    mask = (rng.rand(M, N) >= 0.2).astype(np.float32)
    return x, w, h, mask


@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(ps, "_GRAPHS", _CpuGraphs())
    _Replayed.MADE = []
    ps.reset_graph_counts()


@pytest.fixture
def counted(monkeypatch):
    """K1-K3 and the extrapolation counted as the card counts them: one
    launch a wrapper call, in the counts a capture takes back and a replay
    adds (on the CPU the wrappers take their plain versions uncounted)."""
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
    tests/test_torch_stop_graph.py), and the accelerated loop's own."""
    return ({k: ps.GRAPH_COUNTS[k] for k in ("warm_ups", "captures", "replays")},
            dict(ps.ACCEL_COUNTS))


def _k123(counts):
    """The counts without the extrapolation's: the eager loop extrapolates
    with plain torch ops (``solver.extrapolate``), the graphed loop with
    the kernel, once an iteration."""
    return {key: n for key, n in counts.items() if key[0] != "EXTRAP_LAUNCHES"}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_bits(a, b, where="", fields=FIELDS):
    for f in fields:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, (where, f)
        assert _bits(ta).numpy().tobytes() == _bits(tb).numpy().tobytes(), (where, f)


def _accel(**kw):
    return jt.SolveConfig(max_iter=ITERS, check_every=EVERY, accelerate=True, **kw)


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _routes(problem):
    """name -> (the port's call, nmf_tpu's call, how they are held)."""
    x, w, h, mask = problem
    pair = quantize_policy(torch.clamp_min(torch.from_numpy(x), 2.2204e-16), 2.2204e-16, 0)

    def solve(jcfg, **kw):
        return (lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu", **kw),
                lambda: jt.solve(x, w, h, jcfg))

    routes = {
        "kl": (*solve(_accel()), "f32"),
        "kl jnp": (*solve(_accel(backend="jnp")), "f32"),
        "bfloat16": (*solve(_accel(precision=jt.Precision("bfloat16"))), "bf16 gemm"),
        "float32_fast": (*solve(_accel(precision=jt.Precision("float32_fast"))), "drift"),
        "bf16 state": (*solve(_accel(precision=jt.Precision(state_dtype="bfloat16"))),
                       "bf16 state"),
        "beta": (*solve(_accel(beta=2.0)), "f32"),
        "hals": (*solve(_accel(beta=2.0, algorithm="hals")), "hals"),
        "penalized": (*solve(_accel(l1_h=0.1, l2_w=0.1)), "drift"),
        "h_only": (lambda: pt.solve_h_only(x, w, h, _pcfg(_accel()), device="cpu"),
                   lambda: jt.solve_h_only(x, w, h, _accel()), "f32"),
        "semi": (lambda: pt.solve_semi(x, w, h, _pcfg(_accel()), n_frozen=2, device="cpu"),
                 lambda: jt.solve_semi(x, w, h, _accel(), n_frozen=2), "drift"),
        "masked": (lambda: pt.solve_masked(x, w, h, mask, _pcfg(_accel()), device="cpu"),
                   lambda: jt.solve_masked(x, w, h, mask, _accel()), "drift"),
        "int8 pair": (lambda: pt.solve(pair, w, h, _pcfg(_accel(precision=jt.Precision(
                          x_dtype="int8"))), clamp_inputs=False, device="cpu"),
                      lambda: jt.solve(x, w, h, _accel(precision=jt.Precision(x_dtype="int8"))),
                      "f32"),
    }
    return routes


ROUTES = ("kl", "kl jnp", "bfloat16", "float32_fast", "bf16 state", "beta", "hals", "penalized",
          "h_only", "semi", "masked", "int8 pair")


def _held_to_jax(rp, rj, bar):
    """Counts, momentum bits and the accept sequence exactly; the history
    and the factors at the route's bar (:data:`BARS`)."""
    for f in ("iterations", "num_checks", "converged"):
        assert int(getattr(rp, f)) == int(getattr(rj, f)), f
    assert _f32(rp.momentum).tobytes() == np.asarray(rj.momentum, np.float32).tobytes()
    hist_rtol, (kind, *tol) = BARS[bar]
    hj = np.asarray(rj.cost_history)
    np.testing.assert_array_equal(np.isnan(_f32(rp.cost_history)), np.isnan(hj))
    np.testing.assert_allclose(_f32(rp.cost_history), hj, rtol=hist_rtol)
    for f in ("w", "h"):
        ours, ref = _f32(getattr(rp, f)), _f32(getattr(rj, f))
        if kind == "fro":
            assert np.linalg.norm(ours - ref) <= tol[0] * np.linalg.norm(ref), f
        else:
            np.testing.assert_allclose(ours, ref, rtol=tol[0], atol=tol[1])


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("route", ROUTES)
def test_a_one_host_read_a_block(problem, route, captured):
    """The whole graphed solve runs under ``_NoHostRead``: its parts, the
    seed cost, the load and the result read nothing back but the one
    counted read at the end (the accelerated part and the redo captured
    after the first block)."""
    ours = _routes(problem)[route][0]
    with _NoHostRead():
        res = ours()
    blocks = ITERS // EVERY
    assert _counts() == ({"warm_ups": 1, "captures": 2, "replays": blocks - 1},
                         {"redo_eager": 0, "redo_replays": 0, "reads": 1})
    assert int(res.num_checks) == blocks


@pytest.mark.parametrize("when", ["warm-up", "replayed"])
def test_a_a_rejected_block_reads_once_too(problem, when, captured):
    """A reject makes no read at ``thresh == 0`` without live metrics: the
    first block's (``initial_cost=0``) and a replayed block's (the
    rejecting run), each redo replayed under the device's reject flag;
    the one read is the call's end."""
    if when == "warm-up":
        x, w, h, _ = problem
        fn = lambda: pt.solve(x, w, h, _pcfg(_accel()), initial_cost=0.0,  # noqa: E731
                              device="cpu")
        redo = {"redo_eager": 0, "redo_replays": 1}
    else:
        x, w, h = _wide()
        fn = lambda: pt.solve(x, w, h, pt.SolveConfig(**REJECTING), device="cpu")  # noqa: E731
        redo = {"redo_eager": 0, "redo_replays": 5}
    with _NoHostRead():
        fn()
    assert _counts()[1] == {**redo, "reads": 1}


@pytest.mark.parametrize("config", ["thresh", "live"])
def test_a_a_rejected_block_reads_its_redo_for_the_stop_or_live(problem, config, captured):
    """A rejected block reads nothing more where the stop test or live
    metrics need its redo's cost: the stop is the device's (one read, at
    the end), and live metrics read each check once after its redo."""
    x, w, h, _ = problem
    kw = dict(thresh=1e-9) if config == "thresh" else dict(live_metrics=True)
    pmetrics.set_live_handler(lambda *e: None)
    try:
        with _NoHostRead():
            res = pt.solve(x, w, h, _pcfg(_accel(**kw)), initial_cost=0.0, device="cpu")
    finally:
        pmetrics.set_live_handler(None)
    reads = 1 + (int(res.num_checks) if config == "live" else 0)
    assert _counts()[1] == {"redo_eager": 0, "redo_replays": 1, "reads": reads}


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("route", ROUTES)
def test_b_graphed_route_gives_the_eager_bits_and_jax(problem, route, captured, counted):
    ours, theirs, bar = _routes(problem)[route]
    got = ours()
    got_counts = tfm.count_snapshot()
    tfm.reset_counts()
    with ps.eager_loop():
        eager = ours()
    assert tfm.count_snapshot() == {**got_counts, ("EXTRAP_LAUNCHES", "extrapolate"): 0}
    assert got_counts["EXTRAP_LAUNCHES", "extrapolate"] == ITERS
    _same_bits(got, eager, route)
    blocks = ITERS // EVERY
    assert _counts()[0] == {"warm_ups": 1, "captures": 2, "replays": blocks - 1}
    assert got.w_ex is None and got.h_ex is None
    _held_to_jax(got, theirs(), bar)


def _rejects(counts, res, chunk, seeded=True):
    """Rejected blocks from the launches: K1/K2 ``iterations + chunk x
    rejects``, K3 ``seed + checks + rejects``, the extrapolation once an
    iteration (every block's accelerated steps run, kept or not)."""
    it, checks = int(res.iterations), int(res.num_checks)
    h = counts["LAUNCHES", "update_h"]
    assert (h - it) % chunk == 0 and counts["LAUNCHES", "update_w"] == h
    rejects = (h - it) // chunk
    assert counts["LAUNCHES", "kl_cost"] == int(seeded) + checks + rejects
    assert counts["EXTRAP_LAUNCHES", "extrapolate"] == it
    return rejects


CASES = {
    # name: (problem, config, solve keywords, bar)
    "rejecting": ("wide", REJECTING, {}, "long"),
    "initial_cost=0": ("problem", dict(max_iter=ITERS, check_every=EVERY, accelerate=True),
                       {"initial_cost": 0.0}, "f32"),
    "thresh": ("problem", dict(max_iter=2000, check_every=10, thresh=1e-4, accelerate=True), {},
               "long"),
    "max_iter=37": ("problem", dict(max_iter=37, check_every=EVERY, accelerate=True), {}, "f32"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_b_cases_give_the_eager_bits_and_jax(problem, case, captured, counted):
    """A run that rejects mid-run, a first block rejected (every redo
    replayed under the reject flag), a stop at ``thresh`` (on the device),
    and a tail block (replayed): each the eager loop's bits and launches,
    its redos the eager loop's, and JAX's values."""
    which, fields, kw, bar = CASES[case]
    x, w, h = _wide() if which == "wide" else problem[:3]
    jcfg = jt.SolveConfig(**fields)
    got = pt.solve(x, w, h, _pcfg(jcfg), device="cpu", **kw)
    counts, graphs = tfm.count_snapshot(), _counts()
    tfm.reset_counts()
    with ps.eager_loop():
        eager = pt.solve(x, w, h, _pcfg(jcfg), device="cpu", **kw)
    assert _k123(tfm.count_snapshot()) == _k123(counts)
    _same_bits(got, eager, case)
    rejects = _rejects(counts, got, jcfg.check_every, seeded="initial_cost" not in kw)
    want = {"rejecting": 5, "initial_cost=0": 1}.get(case, 0)
    assert rejects == want and ps.ACCEL_COUNTS["redo_eager"] == want
    assert graphs[0] == {"warm_ups": 1, "captures": 2, "replays": int(got.num_checks) - 1}
    assert graphs[1] == {"redo_eager": 0, "redo_replays": want, "reads": 1}
    assert _monotone(_trim(got))
    rj = jt.solve(x, w, h, jcfg, **kw)
    _assert_match(rj, got, entrywise=bar != "long")
    if case == "thresh":
        assert bool(got.converged) and int(got.iterations) < 2000
    if case == "max_iter=37":
        assert int(got.iterations) == 37 and int(got.num_checks) == 8


def test_b_a_resumed_segment_gives_the_eager_carry(problem, captured):
    """A segment resumed with ``initial_cost``, ``initial_momentum`` and
    ``initial_extrap``: the eager segment's bits, its carry ``w_ex``/
    ``h_ex`` among them; two graphed segments give the graphed straight
    run; the second segment against nmf_tpu's."""
    x, w, h, _ = problem
    jcfg = _accel()
    w0, h0 = w.astype(np.float32), h.astype(np.float32)
    first = pt.solve(x, w0, h0, _pcfg(jcfg), initial_extrap=(w0, h0), device="cpu")
    mom, extrap = accel_state_from(first, device="cpu")

    def second():
        return pt.solve(x, first.w, first.h, _pcfg(jcfg), clamp_inputs=False,
                        initial_cost=float(first.cost), initial_momentum=mom,
                        initial_extrap=extrap, device="cpu")

    got = second()
    with ps.eager_loop():
        eager = second()
    _same_bits(got, eager, "segment", FIELDS + ("w_ex", "h_ex"))
    assert not torch.equal(got.w_ex, got.w)
    straight = pt.solve(x, w0, h0, _pcfg(dataclasses.replace(jcfg, max_iter=2 * ITERS)),
                        device="cpu")
    assert torch.equal(got.w, straight.w) and torch.equal(got.h, straight.h)
    assert torch.equal(got.momentum, straight.momentum)
    j1 = jt.solve(x, w0, h0, jcfg, initial_extrap=(w0, h0))
    j1w, j1h = np.asarray(j1.w), np.asarray(j1.h)
    j2 = jt.solve(x, j1.w, j1.h, jcfg, clamp_inputs=False, initial_cost=float(j1.cost),
                  initial_momentum=float(j1.momentum), initial_extrap=(j1.w_ex, j1.h_ex))
    jm, jex = accel_state_from(j1, device="cpu")
    ours = pt.solve(x, j1w, j1h, _pcfg(jcfg), clamp_inputs=False, initial_cost=float(j1.cost),
                    initial_momentum=jm, initial_extrap=jex, device="cpu")
    _assert_match(j2, ours)


def test_b_live_metrics_emit_the_eager_triples(problem, captured):
    """``live_metrics`` emits ``(it, cost, rel)`` from the block's one read:
    the eager loop's triples bit for bit, a rejected first block's from its
    redo, and JAX's within its bar."""
    x, w, h, _ = problem
    jcfg = _accel(live_metrics=True)

    def emissions(fn, metrics):
        events = []
        metrics.set_live_handler(lambda *e: events.append(e))
        try:
            res = fn()
            jax.effects_barrier()
        finally:
            metrics.set_live_handler(None)
        return res, events

    for kw in ({}, {"initial_cost": 0.0}):
        run = lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu", **kw)  # noqa: E731
        got, ours = emissions(run, pmetrics)
        with ps.eager_loop():
            eager, ours_eager = emissions(run, pmetrics)
        _same_bits(got, eager)
        assert np.array(ours).tobytes() == np.array(ours_eager).tobytes()
        assert [e[0] for e in ours] == list(range(EVERY, ITERS + 1, EVERY))
        _, theirs = emissions(lambda: jt.solve(x, w, h, jcfg, **kw), jmetrics)
        np.testing.assert_allclose([e[1] for e in ours], [e[1] for e in theirs], rtol=1e-5)
        np.testing.assert_allclose([e[2] for e in ours], [e[2] for e in theirs],
                                   rtol=4e-5, atol=4e-5)


def test_b_replays_count_the_captured_launches(captured):
    """A step and a cost that count as the wrappers do on the card: a
    graphed run that rejects counts the eager run's launches (the redo's
    replays among them) and one extrapolation an iteration."""
    def step(w, h, x):
        tfm.LAUNCHES["update_h"] += 1
        tfm.LAUNCHES["update_w"] += 1
        return w * 0.5 + x[:, :1], h

    def cost(x, w, h):
        tfm.LAUNCHES["kl_cost"] += 1
        return torch.sum(w)

    extrap = tfm.extrapolate_into

    def counting(*a, **k):
        tfm.EXTRAP_LAUNCHES["extrapolate"] += 1
        return extrap(*a, **k)

    x, w, h = torch.ones(4, 3), torch.ones(4, 2), torch.ones(2, 3)
    cfg = pt.SolveConfig(max_iter=57, check_every=10, accelerate=True)
    runs = {}
    for eager in (False, True):
        tfm.reset_counts()
        tfm.extrapolate_into = counting
        try:
            if eager:
                with ps.eager_loop():
                    res = ps.run_checked_loop(x, w, h, cfg, step, cost)
            else:
                res = ps.run_checked_loop(x, w, h, cfg, step, cost)
        finally:
            tfm.extrapolate_into = extrap
        runs[eager] = res, {k: v for k, v in tfm.count_snapshot().items() if v}
    (got, counts), (eager, eager_counts) = runs[False], runs[True]
    _same_bits(got, eager)
    rejects = (counts["LAUNCHES", "update_h"] - 57) // 10
    assert rejects > 0 and _counts()[1]["redo_replays"] > 0
    assert counts == {**eager_counts, ("EXTRAP_LAUNCHES", "extrapolate"): 57}
    assert counts["LAUNCHES", "kl_cost"] == 1 + 6 + rejects
    tfm.reset_counts()        # no count outlives the test


# ---------------------------------------------------------------- (c)

def test_c_no_graph_where_the_loop_stays_eager(problem, captured, monkeypatch):
    """A mesh's ``all_reduce``, ``graphs=False`` (the streamed loops and a
    sharded tile-sparse one; the single-device accelerated tiled loop
    replays: tests/test_torch_tiled_graph.py), ``eager_loop()``,
    ``MIN_REPLAYS`` blocks and a step at
    ``GRAPH_MAX_WORK`` run the eager accelerated loop; one block more, or
    one unit of work less, and the call replays."""
    x, w, h, _ = problem
    xt, wt, ht = (torch.from_numpy(a) for a in (x, w, h))
    cfg = pt.SolveConfig(max_iter=ITERS, check_every=EVERY, accelerate=True)
    step, cost = ps.resolve_step_fn(cfg), ps._cost_fn(cfg)
    ps.run_checked_loop(xt, wt, ht, cfg, step, cost, all_reduce=lambda c: c)
    ps.run_checked_loop(xt, wt, ht, cfg, step, cost, graphs=False)
    with ps.eager_loop():
        pt.solve(x, w, h, cfg, device="cpu")
    few = dataclasses.replace(cfg, max_iter=EVERY * ps.MIN_REPLAYS + 4)
    pt.solve(x, w, h, few, device="cpu")
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", M * N * K)
    pt.solve(x, w, h, cfg, device="cpu")
    assert _counts() == ({"warm_ups": 0, "captures": 0, "replays": 0},
                         {"redo_eager": 0, "redo_replays": 0, "reads": 0})
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", M * N * K + 1)
    pt.solve(x, w, h, dataclasses.replace(few, max_iter=EVERY * (ps.MIN_REPLAYS + 1)),
             device="cpu")
    assert _counts()[0] == {"warm_ups": 1, "captures": 2, "replays": ps.MIN_REPLAYS}


def test_c_graphs_live_for_their_call_only(problem, captured):
    """An accelerated solve's graphs and buffers are freed when it returns,
    and nothing it returned aliases one."""
    x, w, h, _ = problem
    res = pt.solve(x, w, h, _pcfg(_accel()), device="cpu")
    assert len(_Replayed.MADE) == 4 and not _Replayed.alive()    # a step and a close a part
    again = pt.solve(x, w, h, _pcfg(_accel()), device="cpu")
    _same_bits(res, again)


def test_c_served_accelerated_blocks_reuse_the_cached_program(problem, captured, tmp_path):
    """An accelerated artifact's blocks run its program's cached graphs
    across calls (the first block of its first call eagerly), each call
    the eager loop's H and costs, nothing returned aliasing a buffer."""
    x, w, _, _ = problem
    path = str(tmp_path / "m.nmfz")
    pt.save_transform(path, w, 40, pt.SolveConfig(max_iter=30, check_every=10, accelerate=True),
                      platforms=("cpu",))
    t = pt.load_transform(path, device="cpu")
    calls = [t(x[:, :40], seed=3), t(x, seed=1)]
    # three blocks of three checks: all but the first one's first replayed
    assert _counts()[0] == {"warm_ups": 1, "captures": 2, "replays": 3 * 3 - 1}
    assert len(_Replayed.alive()) == 4
    with ps.eager_loop():
        eager = [t(x[:, :40], seed=3), t(x, seed=1)]
    for g, e in zip(calls, eager):
        assert g.h.tobytes() == e.h.tobytes()
        assert g.block_costs.tobytes() == e.block_costs.tobytes()
    held = {s.untyped_storage().data_ptr() for r in _Replayed.alive() for s in r.state()}
    res = pt.solve_h_only(x, w, np.ones((K, N), np.float32),
                          pt.SolveConfig(max_iter=30, check_every=10, accelerate=True),
                          device="cpu")
    for f in ("w", "h", "cost", "cost_history", "momentum"):
        assert getattr(res, f).untyped_storage().data_ptr() not in held, f
    del t
    assert not _Replayed.alive()


# ---------------------------------------------------------------- the kernel's wrapper

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_extrapolate_into_writes_the_carry_and_the_iterate(dtype):
    """The wrapper's CPU route: ``ex`` <- ``extrapolate``'s bits, ``prev``
    <- ``next``, for both pairs, ``next`` aliasing ``ex`` too (an H-only
    step's W); it counts nothing on the CPU."""
    rng = np.random.RandomState(5)
    a, b, c, d = (torch.from_numpy(rng.rand(*s).astype(np.float32)).to(dtype)
                  for s in ((9, 4), (9, 4), (4, 7), (4, 7)))
    m = torch.tensor(0.8144469857215881, dtype=torch.float32)
    mf = float(np.float32(0.8144469857215881))
    want = (ps.extrapolate(a, b, mf, 2.2204e-16), ps.extrapolate(c, d, mf, 2.2204e-16))
    prev_w, prev_h, ex_w, ex_h = b.clone(), d.clone(), torch.empty_like(a), torch.empty_like(c)
    tfm.reset_counts()
    tfm.extrapolate_into(((a, prev_w, ex_w), (c, prev_h, ex_h)), m, 2.2204e-16)
    assert torch.equal(_bits(ex_w), _bits(want[0])) and torch.equal(_bits(ex_h), _bits(want[1]))
    assert torch.equal(prev_w, a) and torch.equal(prev_h, c)
    assert tfm.EXTRAP_LAUNCHES["extrapolate"] == 0
    shared, prev = a.clone(), b.clone()
    tfm.extrapolate_into(((shared, prev, shared),), m, 2.2204e-16)
    assert torch.equal(_bits(shared), _bits(want[0])) and torch.equal(prev, a)


def test_the_library_declares_the_extrapolation():
    """``nmf_extrapolate`` is declared for ctypes as ``csrc/extrapolate.cu``
    defines it (three pointers and a count a pair, the momentum's pointer,
    eps, the state dtype, the device, the stream), and that source is
    built into the library."""
    import pathlib
    import re

    from nmf_tpu_torch.ops.kernels import _build

    src = pathlib.Path(_build._CSRC / "extrapolate.cu")
    assert src in _build._SOURCES
    text = src.read_text()
    sig = re.search(r"int nmf_extrapolate\(([^)]*)\)", text).group(1)
    kinds = ["P" if "*" in a else ("F" if "float" in a else "I") for a in sig.split(",")]
    ctypes_kinds = {_build._P: "P", _build._I: "I", _build._F: "F"}
    args, res = _build._SIGNATURES["nmf_extrapolate"]
    assert [ctypes_kinds[a] for a in args] == kinds and res == _build._I
    assert re.search(r'extern "C" \{.*int nmf_extrapolate\(', text, re.S)
    assert "__fmaf_rn(d, m, n)" in text and "__float2bfloat16(v)" in text
