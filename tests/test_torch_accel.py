"""The port's accelerated loop (``accelerate=True``) against ``nmf_tpu`` on
the CPU: the in-memory solve, its resume state, the tile-sparse solve and
the streamed solve.

The same inputs, made from a seed with NumPy, go through both packages.
What must agree exactly: iterations, ``num_checks``, ``converged`` and the
accept/reject sequence, so the in-memory ``momentum`` (an f32 scalar,
multiplied and capped in f32 in both) is equal bit for bit.  The calls of the
port's kernel wrappers (on the CPU, their plain versions) give the
rejections: K1/K2 run ``iterations + chunk x rejects`` times, K3 ``1
(seed) + checks + rejects``.

Tolerances, between two packages whose f32 sums run in other orders:

* f32 state (f32 or int8 X): cost history rel 1e-5, factors rtol 1e-4 /
  atol 1e-6, as tests/test_torch_solver.py holds the plain solve (measured
  here: history 4e-7, factors 7e-5 after 100 iterations; the
  extrapolation is XLA's fused multiply-add in both, ``torch.add(...,
  alpha=m)``, bit-equal on the same operands).
* bf16 state: cost history rel 1e-3, factors by relative Frobenius norm
  5e-2.  A last-ulp difference of an f32 GEMM flips the bf16 rounding of a
  state entry (at iteration 6 on this problem; the plain bf16-state solve
  stays bit-equal over the same 10 iterations) and the extrapolation
  carries the flip into every later point: measured history 1.6e-4,
  factors 2.5e-2 (Frobenius) after 100 iterations, with the same accept
  sequence and momentum.
* long or rejecting runs (extreme momentum, a thresh stop, the streamed
  solve, whose blocks sum in another order): factors by relative
  Frobenius norm 1e-3, the entries of a few (tiny) factor entries drifting
  past 1e-4 as the extrapolation amplifies last-ulp differences: measured
  up to 1.0e-4 (100 iterations at momentum 0.95), 2e-6 to 6e-5 streamed.
* tile-sparse: tests/test_torch_tile_sparse.py's solve tolerances (factors
  rtol 1e-4 / atol 2e-6, costs 1e-5) over 30 iterations.
* streamed: against ``nmf_tpu``'s streamed solve and the port's in-memory
  accelerated solve, history rel 1e-5, factors as long runs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import sparse_tiled as jst  # noqa: E402
from nmf_tpu.models import streaming as jstream  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models.solver import extrapolate  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.ops.kernels import tile_sparse as tts  # noqa: E402
from nmf_tpu_torch.utils.convert import (  # noqa: E402
    accel_state_from,
    config_from_dict,
    result_to_numpy,
)

from oracle import clamp  # noqa: E402

COST_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
BF16_COST_RTOL, BF16_FRO = 1e-3, 5e-2
F32_FRO = 1e-3
EPS = float(np.float32(2.2204e-16))

PRECISIONS = {
    "f32": jt.Precision(),
    "int8_x": jt.Precision(x_dtype="int8"),
    "bf16_state": jt.Precision(state_dtype="bfloat16"),
}


def _problem(m=96, k=12, n=130, seed=11):
    rng = np.random.RandomState(seed)
    return (clamp(rng.rand(m, n).astype(np.float32)), clamp(rng.rand(m, k).astype(np.float32)),
            clamp(rng.rand(k, n).astype(np.float32)))


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _pcfg(jcfg, **kw):
    return dataclasses.replace(config_from_dict(dataclasses.asdict(jcfg)), **kw)


def _monotone(hist, tol=1e-6):
    hist = np.asarray(hist, np.float64)
    return bool(np.all(np.diff(hist) <= tol * np.abs(hist[:-1])))


def _trim(res):
    hist = res.cost_history
    hist = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    return hist[: int(res.num_checks)]


def _f32(a):
    return a.detach().cpu().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _assert_match(rj, rp, bf16_state=False, momentum=True, entrywise=True):
    for f in ("iterations", "num_checks", "converged"):
        assert int(getattr(rp, f)) == int(getattr(rj, f)), f
    hj, hp = np.asarray(rj.cost_history), _f32(rp.cost_history)
    assert hp.shape == hj.shape
    np.testing.assert_array_equal(np.isnan(hp), np.isnan(hj))
    cost_rtol = BF16_COST_RTOL if bf16_state else COST_RTOL
    np.testing.assert_allclose(hp, hj, rtol=cost_rtol)
    np.testing.assert_allclose(_f32(rp.cost), np.asarray(rj.cost), rtol=cost_rtol)
    for f in ("w", "h"):
        ours, ref = _f32(getattr(rp, f)), _f32(getattr(rj, f))
        if bf16_state or not entrywise:
            fro = BF16_FRO if bf16_state else F32_FRO
            assert np.linalg.norm(ours - ref) <= fro * np.linalg.norm(ref), f
        else:
            np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    if momentum:
        assert _f32(rp.momentum).tobytes() == np.asarray(rj.momentum, np.float32).tobytes()


def _counted(fn, module=tfm, names=("update_h_fused", "kl_cost_fused")):
    """(fn(), calls of each wrapper in ``names``) while ``fn`` runs, counted
    by wrapping them (on the CPU they run their plain versions, which
    ``LAUNCHES`` does not count); by default K1's and K3's."""
    calls = dict.fromkeys(names, 0)
    originals = {name: getattr(module, name) for name in calls}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return call

    for name in calls:
        setattr(module, name, counting(name))
    try:
        res = fn()
    finally:
        for name, f in originals.items():
            setattr(module, name, f)
    return (res, *calls.values())


def _rejects(res, k1, k3, chunk, blocks=1, seeded=True):
    """Rejected blocks from the K1 and K3 counts, which must agree."""
    it, checks = int(res.iterations), int(res.num_checks)
    assert (k1 // blocks - it) % chunk == 0, (k1, it, chunk)
    rejects = (k1 // blocks - it) // chunk
    assert k3 // blocks == int(seeded) + checks + rejects, (k3, checks, rejects)
    assert k1 == blocks * (it + chunk * rejects)
    return rejects


# --- the extrapolation ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [0.5, 0.95, 0.8144469857215881])
def test_extrapolate_bit_equal_to_jax(dtype, m):
    """The port's ``extrapolate`` against the JAX loops' ``_extrap`` jitted
    on the same operands (entries near eps, below it after the step, and
    an old value above the new one): the same bits, NaN aside."""
    import jax
    import jax.numpy as jnp

    from nmf_tpu.models.streaming import _accel_jits

    rng = np.random.RandomState(3)
    new = rng.rand(4097).astype(np.float32)
    old = rng.rand(4097).astype(np.float32)
    new[:5], old[:5] = [1e-30, 3e-16, 0.0, 1.0, 2.0], [1.0, 1e-16, 0.0, 0.5, 9.0]
    jd = jnp.dtype(dtype)
    ref = jax.jit(_accel_jits()[0])(jnp.asarray(new, jd), jnp.asarray(old, jd),
                                    jnp.float32(m), jnp.float32(EPS))
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    new_t, old_t = torch.from_numpy(new).to(td), torch.from_numpy(old).to(td)
    keep = (new_t.clone(), old_t.clone())
    ours = extrapolate(new_t, old_t, np.float32(m), EPS)
    assert ours.dtype == td
    assert _f32(ours).tobytes() == np.asarray(ref, np.float32).tobytes()
    assert _f32(ours).min() >= np.float32(EPS)
    assert torch.equal(new_t, keep[0]) and torch.equal(old_t, keep[1])   # inputs untouched


# --- the in-memory loop --------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_accel_matches_jax(problem, prec, backend):
    """100 iterations, a check every 10: counts, momentum bits, history and
    factors against ``nmf_tpu.solve(accelerate=True)``."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=100, check_every=10, accelerate=True,
                          precision=PRECISIONS[prec])
    rj = jt.solve(x, w, h, jcfg)
    rp = pt.solve(x, w, h, _pcfg(jcfg, backend=backend), device="cpu")
    _assert_match(rj, rp, bf16_state=prec == "bf16_state")
    assert int(rp.iterations) == 100 and int(rp.num_checks) == 10
    assert _monotone(_trim(rp))
    assert rp.w.dtype == (torch.bfloat16 if prec == "bf16_state" else torch.float32)
    assert rp.w_ex is None and rp.h_ex is None   # no segment asked for the carry
    assert 0.5 < float(rp.momentum) <= 0.95


def test_launch_counts_without_rejects(problem):
    """The default schedule rejects nothing here: K1/K2 run once an
    iteration, K3 once for the seed and once a check."""
    x, w, h = problem
    cfg = pt.SolveConfig(max_iter=60, check_every=25, accelerate=True)
    res, k1, k3 = _counted(lambda: pt.solve(x, w, h, cfg, device="cpu"))
    assert _rejects(res, k1, k3, 25) == 0
    assert (k1, k3) == (60, 1 + 3)


def test_monotone_and_beats_plain_at_equal_budget():
    """tests/test_accel.py's case: a lower cost than plain MU at the same
    budget, the plain solve's final cost reached within 1/1.5 of it."""
    x, w, h = _problem(192, 12, 384, 0)
    budget = 800
    plain = pt.solve(x, w, h, pt.SolveConfig(max_iter=budget, check_every=25), device="cpu")
    jcfg = jt.SolveConfig(max_iter=budget, check_every=25, accelerate=True)
    accel = pt.solve(x, w, h, _pcfg(jcfg), device="cpu")
    hist = _trim(accel)
    assert _monotone(hist)
    assert float(accel.cost) <= float(plain.cost)
    reach = int(np.argmax(hist <= float(plain.cost)))
    assert hist[reach] <= float(plain.cost) and (reach + 1) * 25 <= budget / 1.5
    rj = jt.solve(x, w, h, jcfg)
    assert int(accel.num_checks) == int(rj.num_checks)
    np.testing.assert_allclose(hist, _trim(rj), rtol=COST_RTOL)
    assert _f32(accel.momentum).tobytes() == np.asarray(rj.momentum, np.float32).tobytes()


def test_first_block_seeds_the_baseline():
    """With no initial_cost one seed cost is taken up front, so the first
    block is guarded too: extreme momentum, no growth, monotone from the
    first check, and the same rejections and history as JAX."""
    x, w, h = _problem(192, 12, 384, 3)
    jcfg = jt.SolveConfig(max_iter=100, check_every=10, accelerate=True,
                          accel_momentum=0.95, accel_grow=1.0)
    rp, k1, k3 = _counted(lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu"))
    hist = _trim(rp)
    assert _monotone(hist) and np.all(np.isfinite(hist))
    rejects = _rejects(rp, k1, k3, 10)
    # every reject halves the momentum: 0.95 * 0.5**rejects, in f32
    m = np.float32(0.95)
    for _ in range(rejects):
        m = np.float32(m * np.float32(0.5))
    assert _f32(rp.momentum).tobytes() == np.asarray(m).tobytes()
    _assert_match(jt.solve(x, w, h, jcfg), rp, entrywise=False)


def test_forced_rejection_path():
    """tests/test_accel.py's case: momentum pinned at 0.9 with no shrink.
    The history never rises, and matches JAX's, whose history holds the
    redo's cost wherever a block was rejected."""
    x, w, h = _problem(192, 12, 384, 7)
    jcfg = jt.SolveConfig(max_iter=400, check_every=20, accelerate=True,
                          accel_momentum=0.9, accel_momentum_max=0.9,
                          accel_grow=1.0, accel_shrink=1.0)
    rp, k1, k3 = _counted(lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu"))
    hist = _trim(rp)
    assert _monotone(hist) and np.all(np.isfinite(hist)) and len(hist) == 20
    _rejects(rp, k1, k3, 20)
    rj = jt.solve(x, w, h, jcfg)
    assert int(rp.num_checks) == int(rj.num_checks)
    np.testing.assert_allclose(hist, _trim(rj), rtol=COST_RTOL)
    assert float(rp.momentum) == float(rj.momentum) == float(np.float32(0.9))


def _wide():
    """tests/test_streaming_accel.py's problem: 96 x 1000, K=12."""
    rng = np.random.RandomState(29)
    m, k, n = 96, 12, 1000
    return (rng.rand(m, n).astype(np.float32), rng.rand(m, k).astype(np.float32),
            rng.rand(k, n).astype(np.float32))


# momentum 0.999, pinned, a check every iteration: 5 blocks of 120 rejected
# in memory on _wide() (the default schedule rejects none on these problems)
REJECTING = dict(max_iter=120, check_every=1, accelerate=True, accel_momentum=0.999,
                 accel_momentum_max=0.999, accel_grow=1.0, accel_shrink=1.0)


def test_rejections_match_jax():
    """A run that rejects: the same checks, history and momentum as JAX,
    the rejected blocks' redo visible in the K1/K3 counts."""
    x, w, h = _wide()
    jcfg = jt.SolveConfig(**REJECTING)
    rp, k1, k3 = _counted(lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu"))
    assert _rejects(rp, k1, k3, 1) == 5
    hist = _trim(rp)
    assert _monotone(hist) and len(hist) == 120
    rj = jt.solve(x, w, h, jcfg)
    _assert_match(rj, rp, entrywise=False)


def test_rejected_block_is_redone_plain(problem):
    """A baseline below any reachable cost (``initial_cost=0``) rejects the
    first block: it is redone with plain steps from the block start, so its
    cost is the plain solve's at that iteration, bit for bit, and the
    momentum shrinks (0.5 * 0.5, then grows by 1.05 a block, in f32), as
    in JAX."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=50, check_every=10, accelerate=True)
    rp, k1, k3 = _counted(lambda: pt.solve(x, w, h, _pcfg(jcfg), initial_cost=0.0,
                                           device="cpu"))
    assert _rejects(rp, k1, k3, 10, seeded=False) == 1
    plain = pt.solve(x, w, h, pt.SolveConfig(max_iter=10, check_every=10), device="cpu")
    assert _trim(rp)[0].tobytes() == _trim(plain)[0].tobytes()
    m = np.float32(np.float32(0.5) * np.float32(0.5))
    for _ in range(4):
        m = min(np.float32(m * np.float32(1.05)), np.float32(0.95))
    assert _f32(rp.momentum).tobytes() == np.asarray(m).tobytes()
    _assert_match(jt.solve(x, w, h, jcfg, initial_cost=0.0), rp)


def test_thresh_stop_matches_jax(problem):
    """thresh > 0 stops at the same check as JAX (the relative change there
    is far from the threshold next to the history tolerance), earlier than
    the plain solve, at an equal or better cost."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=2000, check_every=10, thresh=1e-4, accelerate=True)
    rj = jt.solve(x, w, h, jcfg)
    rp = pt.solve(x, w, h, _pcfg(jcfg), device="cpu")
    _assert_match(rj, rp, entrywise=False)
    assert bool(rp.converged) and int(rp.iterations) < 2000
    plain = pt.solve(x, w, h, _pcfg(jcfg, accelerate=False), device="cpu")
    assert bool(plain.converged) and int(rp.iterations) <= int(plain.iterations)
    assert float(rp.cost) <= float(plain.cost) * (1 + 1e-5)
    hist = _trim(rp)
    rel = np.abs(np.diff(hist)) / np.abs(hist[1:])
    assert rel[-1] < 1e-4 <= rel[-2] and abs(rel[-1] - 1e-4) > 1e-2 * 1e-4


def test_max_iter_37_runs_exactly(problem):
    """thresh=0 still runs exactly max_iter, the last block short (7)."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=37, check_every=10, accelerate=True)
    rp, k1, k3 = _counted(lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu"))
    assert int(rp.iterations) == 37 and not bool(rp.converged) and int(rp.num_checks) == 4
    assert k1 == 37 and k3 == 5
    _assert_match(jt.solve(x, w, h, jcfg), rp)


def test_untracked_cost_still_checks(problem):
    """The accept test needs the cost: track_cost=False checks anyway, as in JAX."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=30, check_every=10, accelerate=True, track_cost=False)
    rp = pt.solve(x, w, h, _pcfg(jcfg), device="cpu")
    assert int(rp.num_checks) == 3 and np.all(np.isfinite(_trim(rp)))
    _assert_match(jt.solve(x, w, h, jcfg), rp)


def test_zero_iterations_takes_the_seed_cost(problem):
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=0, accelerate=True)
    rj = jt.solve(x, w, h, jcfg)
    rp = pt.solve(x, w, h, _pcfg(jcfg), device="cpu")
    assert int(rp.iterations) == 0 and int(rp.num_checks) == 0
    np.testing.assert_allclose(_f32(rp.cost), np.asarray(rj.cost), rtol=COST_RTOL)
    assert float(rp.momentum) == float(rj.momentum) == float(np.float32(0.5))


def test_initial_cost_seam(problem):
    """A given initial_cost is the first acceptance baseline (no seed cost
    is taken): the history stays monotone across the seam, as in JAX."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=100, check_every=25, accelerate=True)
    first = pt.solve(x, w, h, _pcfg(jcfg), device="cpu")
    second, k1, k3 = _counted(lambda: pt.solve(
        x, first.w, first.h, _pcfg(jcfg), initial_cost=float(first.cost), device="cpu"))
    assert k3 == 4 + _rejects(second, k1, k3, 25, seeded=False)
    assert _monotone(np.concatenate([_trim(first), _trim(second)]))
    jfirst = jt.solve(x, w, h, jcfg)
    jsecond = jt.solve(x, np.asarray(jfirst.w), np.asarray(jfirst.h), jcfg,
                       initial_cost=float(jfirst.cost))
    np.testing.assert_allclose(_trim(second), _trim(jsecond), rtol=COST_RTOL)


# --- resume: initial_momentum / initial_extrap ---------------------------------------


@pytest.mark.parametrize("prec", ["f32", "bf16_state"])
def test_resume_from_a_jax_segment(problem, prec):
    """100 + 100 iterations.  The port's second segment, resumed from
    nmf_tpu's first (factors, cost, ``momentum``, ``w_ex``/``h_ex`` carried
    by ``utils.convert``; bf16 bit for bit), against nmf_tpu's own second
    segment; and the port's two segments against its straight 200-iteration
    run, bit for bit."""
    x, w, h = problem
    jcfg = jt.SolveConfig(max_iter=100, check_every=25, accelerate=True,
                          precision=PRECISIONS[prec])
    pcfg = _pcfg(jcfg)
    sd = np.float32 if prec == "f32" else __import__("ml_dtypes").bfloat16
    w0, h0 = w.astype(sd), h.astype(sd)   # the clamped start in the state dtype

    j1 = jt.solve(x, w0, h0, jcfg, initial_extrap=(w0, h0))
    j1w, j1h = np.asarray(j1.w), np.asarray(j1.h)   # the second segment donates its W, H
    j2 = jt.solve(x, j1.w, j1.h, jcfg, clamp_inputs=False, initial_cost=float(j1.cost),
                  initial_momentum=float(j1.momentum), initial_extrap=(j1.w_ex, j1.h_ex))
    mom, extrap = accel_state_from(j1, device="cpu")
    assert mom == float(j1.momentum)
    assert extrap[0].dtype == (torch.float32 if prec == "f32" else torch.bfloat16)
    assert _f32(extrap[0]).tobytes() == np.asarray(j1.w_ex, np.float32).tobytes()
    p2 = pt.solve(x, j1w, j1h, pcfg, clamp_inputs=False,
                  initial_cost=float(j1.cost), initial_momentum=mom, initial_extrap=extrap,
                  device="cpu")
    _assert_match(j2, p2, bf16_state=prec == "bf16_state")
    assert p2.w_ex is not None and p2.w_ex.dtype == p2.w.dtype

    # the port's own segments against its straight run
    straight = pt.solve(x, w0, h0, _pcfg(jcfg, max_iter=200), device="cpu")
    s1 = pt.solve(x, w0, h0, pcfg, initial_extrap=(w0, h0), device="cpu")
    mom1, extrap1 = accel_state_from(s1, device="cpu")
    s2 = pt.solve(x, s1.w, s1.h, pcfg, clamp_inputs=False, initial_cost=float(s1.cost),
                  initial_momentum=mom1, initial_extrap=extrap1, device="cpu")
    assert torch.equal(s2.w, straight.w) and torch.equal(s2.h, straight.h)
    assert _f32(s2.momentum).tobytes() == _f32(straight.momentum).tobytes()
    both = np.concatenate([_trim(s1), _trim(s2)])
    assert both.tobytes() == _trim(straight).tobytes()


def test_nan_initial_momentum_starts_fresh(problem):
    x, w, h = problem
    cfg = pt.SolveConfig(max_iter=30, check_every=10, accelerate=True)
    a = pt.solve(x, w, h, cfg, device="cpu")
    b = pt.solve(x, w, h, cfg, initial_momentum=float("nan"), device="cpu")
    assert torch.equal(a.w, b.w) and torch.equal(a.momentum, b.momentum)
    c = pt.solve(x, w, h, cfg, initial_momentum=0.3, device="cpu")
    j = jt.solve(x, w, h, jt.SolveConfig(max_iter=30, check_every=10, accelerate=True),
                 initial_momentum=0.3)
    assert _f32(c.momentum).tobytes() == np.asarray(j.momentum, np.float32).tobytes()


def test_plain_solve_momentum_is_nan(problem):
    x, w, h = problem
    res = result_to_numpy(pt.solve(x, w, h, pt.SolveConfig(max_iter=10), device="cpu"))
    assert np.isnan(res["momentum"]) and res["w_ex"] is None and res["h_ex"] is None
    assert accel_state_from(pt.solve(x, w, h, pt.SolveConfig(max_iter=10), device="cpu"),
                            device="cpu")[1] is None


def test_reruns_are_bitwise(problem):
    x, w, h = problem
    cfg = pt.SolveConfig(max_iter=50, check_every=10, accelerate=True,
                         precision=pt.Precision(x_dtype="int8"))
    a, b = (pt.solve(x, w, h, cfg, device="cpu") for _ in range(2))
    assert torch.equal(a.w, b.w) and torch.equal(a.h, b.h)
    assert torch.equal(a.cost_history, b.cost_history)


# --- tile-sparse ---------------------------------------------------------------------


def _tiled_problem():
    """tests/test_torch_tile_sparse.py's clustered problem: 160 x 200, K=8,
    32^2 tiles, the last column of tiles ragged (200 = 6 x 32 + 8)."""
    from test_torch_tile_sparse import _tiled_problem as make

    return make()


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("cfg", [dict(max_iter=30, check_every=10, accelerate=True), REJECTING],
                         ids=["default", "rejecting"])
def test_tiled_accel_matches_jax(backend, cfg):
    """``solve_sparse_tiled(accelerate=True)`` on a shape that is not a tile
    multiple, the extrapolation on the PADDED factors as in nmf_tpu (its
    clamp lifts the padding of the extrapolated point to eps): counts,
    momentum bits, history and factors against nmf_tpu's (first case), and
    the accept sequence and history (the rejecting run)."""
    x, w, h = _tiled_problem()
    jcfg = jt.SolveConfig(**cfg)
    rj = jst.solve_sparse_tiled(x, w, h, jcfg, chunk=8, tile=(32, 32))
    rp, sweeps, w_sweeps = _counted(
        lambda: pt.solve_sparse_tiled(x, w, h, _pcfg(jcfg, backend=backend), chunk=8,
                                      tile=(32, 32), device="cpu"),
        tts, ("h_numerator", "w_numerator"))
    assert tuple(rp.w.shape) == (160, 8) and tuple(rp.h.shape) == (8, 200)
    if cfg["max_iter"] == 30:
        for f in ("iterations", "num_checks", "converged"):
            assert int(getattr(rp, f)) == int(getattr(rj, f)), f
        np.testing.assert_allclose(_f32(rp.cost_history), np.asarray(rj.cost_history), rtol=1e-5)
        for f in ("w", "h"):
            np.testing.assert_allclose(_f32(getattr(rp, f)), np.asarray(getattr(rj, f)),
                                       rtol=1e-4, atol=2e-6)
        assert _f32(rp.momentum).tobytes() == np.asarray(rj.momentum, np.float32).tobytes()
    else:
        assert int(rp.num_checks) == int(rj.num_checks) == 120
        np.testing.assert_allclose(_trim(rp), _trim(rj), rtol=1e-5)
        assert _monotone(_trim(rp))
    assert sweeps == w_sweeps
    if backend == "auto":   # the K5 wrappers' plain route on the CPU
        chunk = cfg["check_every"]
        rejects = (sweeps - int(rp.iterations)) // chunk
        assert sweeps == int(rp.iterations) + chunk * rejects
        assert (rejects > 0) == (cfg is REJECTING)
    else:
        assert sweeps == 0


def test_tiled_accel_iterate_padding_stays_zero():
    """The extrapolated point's padding is eps, the iterate's stays exactly 0."""
    from nmf_tpu_torch.models import sparse_tiled as pst

    x, w, h = _tiled_problem()
    cfg = pt.SolveConfig(max_iter=20, check_every=10, accelerate=True)
    xarg, wp, hp, info = pst._prepare_tiled(x, w, h, cfg, 8, (32, 32), torch.device("cpu"))
    step, cost = pst._tiled_fns(cfg, 8, info["route"])
    res = pt.models.run_checked_loop(xarg, wp, hp, cfg, step, cost, None, float("nan"),
                                     (wp, hp))
    assert info["np_"] == 224 and (res.h[:, 200:] == 0).all()
    assert (res.h_ex[:, 200:] == np.float32(EPS)).all()


# --- streamed ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide():
    return _wide()


@pytest.mark.parametrize("x_dtype", ["float32", "int8"])
@pytest.mark.parametrize("block_n", [256, 384, 1000])
def test_streamed_accel_matches_jax(wide, block_n, x_dtype):
    """60 iterations, a check every 10: counts, history and factors against
    ``nmf_tpu``'s streamed accelerated solve, and against the port's
    in-memory accelerated solve; the launches of a run without rejects."""
    x, w, h = wide
    jcfg = jt.SolveConfig(max_iter=60, check_every=10, accelerate=True,
                          precision=jt.Precision(x_dtype=x_dtype))
    rj = jstream.solve_out_of_core(x, w, h, jcfg, block_n=block_n)
    rp, k1, k3 = _counted(lambda: pt.solve_out_of_core(x, w, h, _pcfg(jcfg), block_n=block_n,
                                                       device="cpu"))
    blocks = -(-1000 // block_n)
    assert _rejects(rp, k1, k3, 10, blocks) == 0
    _assert_match(rj, rp, momentum=False, entrywise=False)
    # the streamed loop's momentum is a float64 on the host, rounded to f32
    # at the end, as in JAX
    assert float(rp.momentum) == float(rj.momentum)
    mem = pt.solve(x, w, h, _pcfg(jcfg), device="cpu")
    _assert_match(mem, rp, momentum=False, entrywise=False)
    assert float(mem.momentum) == pytest.approx(float(rp.momentum), rel=1e-6)


def test_streamed_accel_rejection_path(wide):
    """The rejecting run: each rejected block restores the snapshot and is
    redone plain (re-streaming X); the history stays monotone, and the
    port rejects where JAX's streamed loop does."""
    x, w, h = wide
    jcfg = jt.SolveConfig(**REJECTING)
    rj = jstream.solve_out_of_core(x, w, h, jcfg, block_n=256)
    rp, k1, k3 = _counted(lambda: pt.solve_out_of_core(x, w, h, _pcfg(jcfg), block_n=256,
                                                       device="cpu"))
    hist = _trim(rp)
    assert len(hist) == 120 and _monotone(hist) and np.all(np.isfinite(hist))
    assert _rejects(rp, k1, k3, 1, blocks=4) > 0
    _assert_match(rj, rp, momentum=False, entrywise=False)


def test_streamed_accel_thresh_stop(wide):
    x, w, h = wide
    jcfg = jt.SolveConfig(max_iter=3000, check_every=25, thresh=1e-4, accelerate=True)
    rj = jstream.solve_out_of_core(x, w, h, jcfg, block_n=1000)
    rp = pt.solve_out_of_core(x, w, h, _pcfg(jcfg), block_n=1000, device="cpu")
    assert bool(rp.converged) and int(rp.iterations) == int(rj.iterations) < 3000
    _assert_match(rj, rp, momentum=False, entrywise=False)
    plain = pt.solve_out_of_core(x, w, h, _pcfg(jcfg, accelerate=False), block_n=1000,
                                 device="cpu")
    assert bool(plain.converged) and int(rp.iterations) <= int(plain.iterations)


def test_streamed_accel_always_tracks_cost(wide):
    """The accept test needs every check's cost: track_cost=False records
    the history anyway, and the 37th iteration ends a short block."""
    x, w, h = wide
    jcfg = jt.SolveConfig(max_iter=37, check_every=10, accelerate=True, track_cost=False)
    rj = jstream.solve_out_of_core(x, w, h, jcfg, block_n=384)
    rp = pt.solve_out_of_core(x, w, h, _pcfg(jcfg), block_n=384, device="cpu")
    assert int(rp.iterations) == 37 and int(rp.num_checks) == 4
    _assert_match(rj, rp, momentum=False, entrywise=False)


def test_streamed_accel_reruns_bitwise(wide):
    x, w, h = wide
    cfg = pt.SolveConfig(max_iter=20, check_every=5, accelerate=True)
    a, b = (pt.solve_out_of_core(x, w, h, cfg, block_n=384, device="cpu") for _ in range(2))
    assert torch.equal(a.w, b.w) and torch.equal(a.h, b.h)
    assert torch.equal(a.cost_history, b.cost_history)


# --- chip_smoke.py's reading of the rejects ----------------------------------------


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_reads_the_plain_paths_rejects(wide):
    """Phase 10 counts the jnp path's step and cost calls (``_calls``) and
    reads the rejects from them (``_rejects``): on the rejecting run they
    give the kernel wrappers' count, and inconsistent counts fail."""
    from nmf_tpu_torch.models import solver

    smoke = _chip_smoke()
    x, w, h = wide
    cfg = pt.SolveConfig(**REJECTING)
    rk, k1, k3 = _counted(lambda: pt.solve(x, w, h, cfg, device="cpu"))
    rj, calls = smoke._calls(
        lambda: pt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"), device="cpu"),
        solver, ("mu_step", "kl_divergence"))
    assert solver.mu_step.__name__ == "mu_step"   # restored
    assert smoke._rejects(calls["mu_step"], calls["kl_divergence"], rj, 1, "jnp") \
        == smoke._rejects(k1, k3, rk, 1, "kernels") == 5
    with pytest.raises(RuntimeError, match="costs"):
        smoke._rejects(k1, k3 + 1, rk, 1, "off by one")
    with pytest.raises(RuntimeError, match="steps"):
        smoke._rejects(130, 10, rk, 3, "not a block multiple", blocks=1)


def test_chip_smoke_lists_accel_launches():
    smoke = _chip_smoke()
    launches = {
        "float32": {"update_h": 200, "update_w": 200, "kl_cost": 8},
        "accel reference": {"update_h": 225, "update_w": 225, "kl_cost": 10},
        "accel oocore int8": {"update_h": 100, "update_w": 0, "update_w_numerator": 100,
                              "kl_cost": 30},
        "accel tiled float32": {"h_numerator": 200, "w_numerator": 200},
    }
    assert smoke._accel_launches(launches, "update_w") == {
        "reference": 225, "oocore int8 numerator_only": 100}
    assert smoke._accel_launches(launches, "kl_cost") == {"reference": 10, "oocore int8": 30}
    assert smoke._accel_launches(launches, "h_numerator") == {"tiled float32": 200}
    # phase 15 (utils) follows phase 14; phases 16-20 (sparse, backend, mesh, serving,
    # examples) follow it
    assert smoke.PHASES[-11:] == ("accel", "families", "transform", "models", "selection",
                                  "utils", "sparse", "backend", "mesh", "serving", "examples")
    # phase 13's runs: K1-K3 under their own keys, K2's numerator_only beside
    models = {"models separate": {"update_h": 200, "update_w": 200, "kl_cost": 8},
              "models streamed n_frozen=8": {"update_h": 50, "update_w": 0,
                                             "update_w_numerator": 50, "kl_cost": 10},
              "models online": {"update_h": 0, "update_w": 0, "kl_cost": 0}}
    assert smoke._models_launches({**launches, **models}, "update_w") == {
        "separate": 200, "streamed n_frozen=8": 0, "streamed n_frozen=8 numerator_only": 50,
        "online": 0}
    assert smoke._models_launches(models, "kl_cost") == {
        "separate": 8, "streamed n_frozen=8": 10, "online": 0}
