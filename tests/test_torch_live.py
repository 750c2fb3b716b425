"""Live metrics (``SolveConfig.live_metrics``) of the port against ``nmf_tpu``
on the CPU.

Each case runs one solve in both packages on the same seeded NumPy inputs
(one torch thread) with a handler collecting the ``(iteration, cost,
rel_change)`` emissions, and holds the port's to JAX's: the same
iterations, the costs within the solver parity bar of
tests/test_torch_solver.py (rel 1e-5), the relative changes NaN at the same
checks and elsewhere within 4e-5 (1 + rel) (each is a difference of two
costs over a cost, so a 1e-5 relative gap in each cost moves it by at most
about 2e-5 (1 + rel)).  The accelerated tile-sparse solve is held at costs
rel 1e-4 (relative changes 4e-4 (1 + rel)): over 30 iterations of that problem a
last-ulp difference grows some 500-fold (tests/test_torch_tile_sparse.py),
and each extrapolation scales it by up to 1 + momentum; measured 1.1e-5.
In the port, the emissions equal the solve's own history bit for bit, and
a solve with live metrics gives the bits of the same solve without them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import streaming as jstream  # noqa: E402
from nmf_tpu.utils import metrics as jmetrics  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.utils import metrics as pmetrics  # noqa: E402

COST_RTOL, REL_ATOL = 1e-5, 4e-5
# (solve, config) -> costs rtol where the drift is larger (module docstring)
DRIFT = {("tiled", "accelerate"): 1e-4}


def port_emissions(fn):
    """(fn(), the port's live emissions during it)."""
    events = []
    pmetrics.set_live_handler(lambda *e: events.append(e))
    try:
        res = fn()
    finally:
        pmetrics.set_live_handler(None)
    return res, events


def jax_emissions(fn):
    """(fn(), JAX's live emissions during it, its async callbacks flushed)."""
    events = []
    jmetrics.set_live_handler(lambda *e: events.append(e))
    try:
        res = fn()
        jax.effects_barrier()
    finally:
        jmetrics.set_live_handler(None)
    return res, events


def assert_emissions_match(ours, ref, cost_rtol=COST_RTOL, rel_atol=REL_ATOL):
    assert [e[0] for e in ours] == [e[0] for e in ref]
    np.testing.assert_allclose([e[1] for e in ours], [e[1] for e in ref], rtol=cost_rtol)
    rel_o, rel_r = np.array([e[2] for e in ours]), np.array([e[2] for e in ref])
    assert np.array_equal(np.isnan(rel_o), np.isnan(rel_r))
    np.testing.assert_allclose(rel_o, rel_r, rtol=rel_atol, atol=rel_atol, equal_nan=True)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality, NaN included."""
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return a.shape == b.shape and torch.equal(a, b)


def _problem(m=64, k=6, n=80, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(m, n).astype(np.float32), rng.rand(m, k).astype(np.float32),
            rng.rand(k, n).astype(np.float32))


def _tiled():
    """A clustered 160 x 200 problem in 32^2 tiles (the last column ragged)."""
    rng = np.random.RandomState(41)
    x = np.zeros((160, 200), np.float32)
    for bi, bj in [(0, 0), (1, 3), (2, 5), (4, 6), (3, 1)]:
        blk = rng.rand(32, 32).astype(np.float32)
        x[bi * 32:(bi + 1) * 32, bj * 32:min((bj + 1) * 32, 200)] = blk[:, : min(32, 200 - bj * 32)]
    return x, rng.rand(160, 8).astype(np.float32), rng.rand(8, 200).astype(np.float32)


# solve -> (port call, JAX call) on (x, w, h, port config, JAX config)
SOLVES = {
    "plain": (lambda x, w, h, c: pt.solve(x, w, h, c, device="cpu"),
              lambda x, w, h, c: jt.solve(x, w, h, c)),
    "tiled": (lambda x, w, h, c: pt.solve_sparse_tiled(
                  pt.tiles_from_dense(x, (32, 32)), w, h, c, device="cpu"),
              lambda x, w, h, c: jt.solve_sparse_tiled(jt.tiles_from_dense(x, (32, 32)), w, h, c)),
    "streamed": (lambda x, w, h, c: pt.solve_out_of_core(x, w, h, c, block_n=32, device="cpu"),
                 lambda x, w, h, c: jstream.solve_out_of_core(x, w, h, c, block_n=32)),
    "h_only": (lambda x, w, h, c: pt.solve_h_only(x, w, h, c, device="cpu"),
               lambda x, w, h, c: jt.solve_h_only(x, w, h, c)),
    "semi": (lambda x, w, h, c: pt.solve_semi(x, w, h, c, n_frozen=2, device="cpu"),
             lambda x, w, h, c: jt.solve_semi(x, w, h, c, n_frozen=2)),
    "masked": (lambda x, w, h, c: pt.solve_masked(x, w, h, (x > 0.2).astype(np.float32), c,
                                                  device="cpu"),
               lambda x, w, h, c: jt.solve_masked(x, w, h, (x > 0.2).astype(np.float32), c)),
}
CONFIGS = {
    "check10": dict(max_iter=30, check_every=10),
    "ragged": dict(max_iter=25, check_every=10),
    "accelerate": dict(max_iter=30, check_every=10, accelerate=True),
    "thresh": dict(max_iter=400, check_every=5, thresh=2e-3),
    "beta2": dict(max_iter=20, check_every=5, beta=2.0),
}
CASES = [(s, c) for s in SOLVES for c in CONFIGS
         if not (s == "tiled" and c == "beta2") and not (s == "masked" and c == "beta2")]


def _inputs(solve):
    return _tiled() if solve == "tiled" else _problem()


@pytest.mark.parametrize("solve,cfg", CASES, ids=[f"{s}-{c}" for s, c in CASES])
def test_emissions_match_jax(solve, cfg):
    """The port's emissions are JAX's on the same solve: the plain,
    accelerated, tiled and streamed solves, and the H-only, semi and masked
    solves that share the checked loop."""
    x, w, h = _inputs(solve)
    ours, ref = SOLVES[solve]
    kw = dict(CONFIGS[cfg], live_metrics=True)
    res_p, ev_p = port_emissions(lambda: ours(x, w, h, pt.SolveConfig(**kw)))
    res_j, ev_j = jax_emissions(lambda: ref(x, w, h, jt.SolveConfig(**kw)))
    assert len(ev_p) == int(res_p.num_checks) > 0
    rtol = DRIFT.get((solve, cfg), COST_RTOL)
    assert_emissions_match(ev_p, ev_j, rtol, 4 * rtol)
    assert int(res_p.iterations) == int(res_j.iterations)


@pytest.mark.parametrize("solve,cfg", CASES, ids=[f"{s}-{c}" for s, c in CASES])
def test_live_changes_no_bit(solve, cfg):
    """Live on gives the bits of live off, and the emitted costs are the
    solve's own history, bit for bit, at the labels of its checks."""
    x, w, h = _inputs(solve)
    ours = SOLVES[solve][0]
    off = ours(x, w, h, pt.SolveConfig(**CONFIGS[cfg]))
    on, events = port_emissions(
        lambda: ours(x, w, h, pt.SolveConfig(**CONFIGS[cfg], live_metrics=True)))
    for f in ("w", "h", "cost", "cost_history", "iterations", "converged"):
        assert same_bits(getattr(on, f), getattr(off, f)), f
    n = int(on.num_checks)
    hist = on.cost_history.cpu().numpy()[:n]
    assert np.array_equal(np.float32([e[1] for e in events]), hist)
    every, total = CONFIGS[cfg]["check_every"], int(on.iterations)
    assert [e[0] for e in events] == [min((i + 1) * every, total) for i in range(n)]


def test_first_check_has_no_baseline():
    """rel_change is NaN at the first check of a plain run (no baseline) and
    finite after, as in JAX; the accelerated loop's first check compares with
    its seed cost."""
    x, w, h = _problem()
    _, plain = port_emissions(lambda: pt.solve(
        x, w, h, pt.SolveConfig(max_iter=20, check_every=10, live_metrics=True), device="cpu"))
    assert np.isnan(plain[0][2]) and np.isfinite(plain[1][2]) and plain[1][2] > 0
    _, accel = port_emissions(lambda: pt.solve(
        x, w, h, pt.SolveConfig(max_iter=20, check_every=10, live_metrics=True, accelerate=True),
        device="cpu"))
    assert all(np.isfinite(e[2]) for e in accel)


def test_initial_cost_is_the_first_baseline():
    """A segment given ``initial_cost`` measures its first check against it."""
    x, w, h = _problem()
    _, ev = port_emissions(lambda: pt.solve(
        x, w, h, pt.SolveConfig(max_iter=10, check_every=10, live_metrics=True),
        initial_cost=1e4, device="cpu"))
    assert ev[0][2] == pytest.approx(abs(1e4 - ev[0][1]) / ev[0][1], rel=1e-6)


def test_default_handler_writes_jax_line(capsys):
    """The default sink is JAX's stderr line; None restores it."""
    pmetrics.set_live_handler(lambda *e: None)
    pmetrics.set_live_handler(None)
    pmetrics.emit_live(25, 96689.73, 1.5e-3)
    jmetrics.emit_live(25, 96689.73, 1.5e-3)
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1] == "[nmf] iter     25  cost 9.668973e+04  rel_change 1.500e-03  (live)"


def test_live_needs_cost_as_in_jax():
    """live_metrics without a cost to stream is refused with JAX's message."""
    with pytest.raises(ValueError) as ep:
        pt.SolveConfig(live_metrics=True, track_cost=False).validate()
    with pytest.raises(ValueError) as ej:
        jt.SolveConfig(live_metrics=True, track_cost=False).validate()
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("where", ["batched", "rank_sweep", "transform_out_of_core"])
def test_turned_off_where_jax_turns_it_off(where):
    """The batched solves, the selection sweeps and the streamed transform
    drop live_metrics, as JAX does: no emission, and the bits of live off."""
    x, w, h = _problem()
    on = pt.SolveConfig(max_iter=10, check_every=5, live_metrics=True)
    off = dataclasses.replace(on, live_metrics=False)
    if where == "batched":
        def run(c):
            return pt.solve_batched(np.stack([x, x]), np.stack([w, w]), np.stack([h, h]), c,
                                    device="cpu").w
    elif where == "rank_sweep":
        def run(c):
            return pt.solve_rank_sweep(x, [2, 4], config=c, seed=1, device="cpu").results.w
    else:
        def run(c):
            return torch.from_numpy(pt.transform_out_of_core(x, w, config=c, block_n=16,
                                                             device="cpu").h)
    a, events = port_emissions(lambda: run(on))
    assert events == [] and torch.equal(a, run(off))


def test_online_refuses_as_jax():
    x, w, _ = _problem()
    with pytest.raises(NotImplementedError) as ep:
        pt.solve_online(x, w, pt.SolveConfig(live_metrics=True), device="cpu")
    with pytest.raises(NotImplementedError) as ej:
        jt.solve_online(x, w, jt.SolveConfig(live_metrics=True))
    assert str(ep.value) == str(ej.value)


def test_public_names():
    from nmf_tpu_torch.utils import metrics

    assert {"emit_live", "set_live_handler"} <= set(metrics.__all__)
