"""Restarts and rank sweeps of the port against ``nmf_tpu`` on the CPU.

Each case of ``tests/test_selection.py`` that needs no mesh, run through
both packages on the same seeded NumPy inputs.  Tolerances: the JAX
tests' own where they hold a member to a single solve (cost rel 1e-6;
frozen columns and HALS rtol 5e-5; a rank-sweep member's W rtol 1e-5, see
the test: JAX's 2e-6 sits inside the spread of CPU BLAS summation orders
over a zero-padded K), and between the two
packages those of ``tests/test_torch_batched.py`` (factors rtol 5e-5 /
atol 1e-7, costs rel 1e-5; HALS rtol 5e-4, atol 1e-5 of the largest
entry).  ``_member_inits`` is held to JAX's byte for byte.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import selection as jsel  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import selection as tsel  # noqa: E402
from nmf_tpu_torch.models.init import random_init, scaled_random_init  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402

F32 = dict(rtol=5e-5, atol=1e-7)


@pytest.fixture(scope="module")
def problem():
    """A planted rank-8 structure and noise (``tests/test_selection.py``)."""
    rng = np.random.RandomState(11)
    w = rng.rand(64, 8).astype(np.float32)
    h = rng.rand(8, 80).astype(np.float32)
    return (w @ h + 0.01 * rng.rand(64, 80)).astype(np.float32)


def _cfg(**kw):
    fields = dict(max_iter=40, thresh=0.0, check_every=10)
    fields.update(kw)
    return pt.SolveConfig(**fields), jt.SolveConfig(**fields)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(autouse=True)
def _zero_counts():
    tfm.reset_counts()
    yield
    tfm.reset_counts()


def test_restart_members_match_individual_solves(problem):
    """Each member is its single solve from the same seeded init: bit for
    bit in the port, within F32 of nmf_tpu's members."""
    tc, jc = _cfg()
    res = pt.solve_restarts(problem, rank=8, n_restarts=3, config=tc, seed=5, device="cpu")
    ref = jt.solve_restarts(problem, rank=8, n_restarts=3, config=jc, seed=5)
    assert res.n_members == 3
    for i in range(3):
        w0, h0 = scaled_random_init(problem, 8, seed=5 + i)
        one = pt.solve(problem, w0, h0, tc, device="cpu")
        w_i, h_i = res.factors(i)
        assert torch.equal(w_i, one.w) and torch.equal(h_i, one.h)
        np.testing.assert_allclose(_np(w_i), np.asarray(ref.factors(i)[0]), **F32)
        np.testing.assert_allclose(res.costs[i], ref.costs[i], rtol=1e-5)


def test_restarts_pick_lowest_cost(problem):
    tc, jc = _cfg()
    res = pt.solve_restarts(problem, rank=4, n_restarts=4, config=tc, init="random",
                            device="cpu")
    ref = jt.solve_restarts(problem, rank=4, n_restarts=4, config=jc, init="random")
    assert res.best_index == int(np.argmin(res.costs)) == ref.best_index
    assert res.best_cost == pytest.approx(float(res.costs.min()))
    assert res.best_cost == pytest.approx(ref.best_cost, rel=1e-5)
    w, h = res.best
    assert w.shape == (64, 4) and h.shape == (4, 80)


def test_best_solve_result_indexes_every_field(problem):
    tc, _ = _cfg()
    res = pt.solve_restarts(problem, rank=4, n_restarts=3, config=tc, seed=1, device="cpu")
    best = res.best_solve_result()
    b = res.best_index
    for f in dataclasses.fields(pt.SolveResult):
        full, one = getattr(res.results, f.name), getattr(best, f.name)
        if full is None:
            assert one is None
        else:
            torch.testing.assert_close(one, full[b], rtol=0, atol=0, equal_nan=True)
    assert best.w.shape == (64, 4) and best.iterations.dim() == 0


def test_restarts_explicit_inits(problem):
    rng = np.random.RandomState(0)
    w0s = rng.rand(2, 64, 6).astype(np.float32)
    h0s = rng.rand(2, 6, 80).astype(np.float32)
    tc, jc = _cfg()
    res = pt.solve_restarts(problem, w0s=w0s, h0s=h0s, config=tc, device="cpu")
    ref = jt.solve_restarts(problem, w0s=w0s, h0s=h0s, config=jc)
    one = pt.solve(problem, w0s[1], h0s[1], tc, device="cpu")
    assert torch.equal(res.results.cost[1], one.cost)
    np.testing.assert_allclose(res.costs, ref.costs, rtol=1e-6)


def test_rank_sweep_member_equals_lower_rank_solve(problem):
    """Each member is the lower-rank problem: its embedding slots exact
    zeros, its factors and cost those of the rank-k solve."""
    ranks = [4, 8, 16]
    tc, jc = _cfg()
    res = pt.solve_rank_sweep(problem, ranks, config=tc, seed=3, device="cpu")
    ref = jt.solve_rank_sweep(problem, ranks, config=jc, seed=3)
    w0s, h0s = tsel._member_inits(problem, np.asarray(ranks), "scaled", 3)
    for i, k in enumerate(ranks):
        one = pt.solve(problem, w0s[i, :, :k], h0s[i, :k, :], tc, device="cpu")
        w_i, _ = res.factors(i)
        # Bound 1e-5: the member runs at the zero-padded K=16 (bmm), the
        # 2-D solve at K=4 (mm); the zeros add nothing, but CPU BLAS sums
        # the nonzero terms in another order.  Three valid f32 orders of
        # these 40 iterations spread by at most 3.1e-6 here (member vs 2-D
        # 2.54e-6 at rank 4, 2.71e-6 at rank 8, bitwise at 16; the port's
        # 2-D solve vs JAX's 3.1e-6): 1e-5 leaves 3x for another CPU's BLAS
        # and stays 5x inside the cross-package F32 bar.  The costs, and the
        # embedding's exact zeros below, are held as before.
        np.testing.assert_allclose(_np(w_i), _np(one.w), rtol=1e-5)
        np.testing.assert_allclose(res.costs[i], float(one.cost), rtol=1e-6)
        np.testing.assert_allclose(_np(w_i), np.asarray(ref.factors(i)[0]), **F32)
        assert np.all(_np(res.results.w[i])[:, k:] == 0.0)
        assert np.all(_np(res.results.h[i])[k:, :] == 0.0)
    np.testing.assert_allclose(res.costs, ref.costs, rtol=1e-5)


def test_rank_sweep_cost_curve_decreases_with_rank(problem):
    tc, _ = _cfg()
    c = pt.solve_rank_sweep(problem, [2, 8, 24], config=tc, seed=7, device="cpu").costs
    assert c[0] > c[1] > c[2]


def test_rank_sweep_hals_member_equals_lower_rank_solve(problem):
    """HALS keeps the embedding's zeros too (``tests/test_selection.py``)."""
    ranks = [3, 6]
    tc, jc = _cfg(max_iter=12, check_every=12, beta=2.0, algorithm="hals")
    res = pt.solve_rank_sweep(problem, ranks, config=tc, seed=3, device="cpu")
    ref = jt.solve_rank_sweep(problem, ranks, config=jc, seed=3)
    w0s, h0s = tsel._member_inits(problem, np.asarray(ranks), "scaled", 3)
    for i, k in enumerate(ranks):
        one = pt.solve(problem, w0s[i, :, :k], h0s[i, :k, :], tc, device="cpu")
        w_i, _ = res.factors(i)
        np.testing.assert_allclose(_np(w_i), _np(one.w), rtol=5e-5, atol=1e-6)
        np.testing.assert_allclose(res.costs[i], float(one.cost), rtol=1e-5)
        assert np.all(_np(res.results.w[i])[:, k:] == 0.0)
        assert np.all(_np(res.results.h[i])[k:, :] == 0.0)
        w_ref = np.asarray(ref.factors(i)[0])
        np.testing.assert_allclose(_np(w_i), w_ref, rtol=5e-4,
                                   atol=1e-5 * float(np.abs(w_ref).max()))
    rr = pt.solve_restarts(problem, rank=4, n_restarts=2, config=tc, device="cpu")
    assert np.all(np.isfinite(rr.costs))


def test_restarts_with_thresh_stop_per_member(problem):
    tc, jc = _cfg(max_iter=200, thresh=0.15, check_every=10)
    res = pt.solve_restarts(problem, rank=8, n_restarts=3, config=tc, init="random",
                            device="cpu")
    ref = jt.solve_restarts(problem, rank=8, n_restarts=3, config=jc, init="random")
    for i in range(3):
        w0, h0 = random_init(64, 8, 80, seed=i)
        one = pt.solve(problem, w0, h0, tc, device="cpu")
        assert int(res.iterations[i]) == int(one.iterations) == int(ref.iterations[i])
        assert bool(res.converged[i]) == bool(one.converged) == bool(ref.converged[i])
        assert torch.equal(res.results.cost[i], one.cost)
    assert np.any(res.converged)


@pytest.mark.parametrize("rows", [0, 16], ids=["columns", "row_blocks"])
def test_restarts_int8_x(problem, rows):
    """Members share one set of codes (``tests/test_selection.py``,
    ``tests/test_quant_rowblocks.py``); int8 X is lossy: costs within 5%
    of f32's, and within 1e-5 of nmf_tpu's int8 restarts."""
    prec = dict(x_dtype="int8", x_quant_rows=rows)
    tc, jc = _cfg(max_iter=10, check_every=5)
    tc8 = dataclasses.replace(tc, precision=pt.Precision(**prec))
    jc8 = dataclasses.replace(jc, precision=jt.Precision(**prec))
    res = pt.solve_restarts(problem, rank=4, n_restarts=2, config=tc8, device="cpu")
    ref = pt.solve_restarts(problem, rank=4, n_restarts=2, config=tc, device="cpu")
    np.testing.assert_allclose(res.costs, ref.costs, rtol=0.05)
    jres = jt.solve_restarts(problem, rank=4, n_restarts=2, config=jc8)
    np.testing.assert_allclose(res.costs, jres.costs, rtol=1e-5)
    np.testing.assert_allclose(_np(res.results.w), np.asarray(jres.results.w), **F32)


@pytest.mark.parametrize(
    "call",
    ["neither", "zero_restarts", "lone_stack", "empty_ranks", "zero_rank", "not_3d",
     "conflicting_rank", "conflicting_restarts", "frozen_too_many", "frozen_hals"],
)
def test_selection_refuses_as_nmf_tpu(problem, call):
    """Each argument check of ``nmf_tpu``'s restarts and rank sweep, with its
    type and words."""
    stack = np.ones((2, 64, 4), np.float32), np.ones((2, 4, 80), np.float32)
    hals = dict(beta=2.0, algorithm="hals")
    calls = {
        "neither": ("solve_restarts", (), {}),
        "zero_restarts": ("solve_restarts", (), dict(rank=4, n_restarts=0)),
        "lone_stack": ("solve_restarts", (), dict(w0s=stack[0], h0s=None)),
        "empty_ranks": ("solve_rank_sweep", ([],), {}),
        "zero_rank": ("solve_rank_sweep", ([0, 4],), {}),
        "not_3d": ("solve_restarts", (), dict(w0s=stack[0][0], h0s=stack[1][0])),
        "conflicting_rank": ("solve_restarts", (), dict(rank=6, w0s=stack[0], h0s=stack[1])),
        "conflicting_restarts": ("solve_restarts", (),
                                 dict(n_restarts=8, w0s=stack[0], h0s=stack[1])),
        "frozen_too_many": ("solve_restarts", (), dict(w0s=stack[0], h0s=stack[1], n_frozen=5)),
        "frozen_hals": ("solve_restarts", (),
                        dict(w0s=stack[0], h0s=stack[1], n_frozen=2, config=hals)),
    }
    name, args, kw = calls[call]

    def raised(mod, cfg_cls, extra):
        k = dict(kw)
        if "config" in k:
            k["config"] = cfg_cls(max_iter=2, **k["config"])
        with pytest.raises(Exception) as e:
            getattr(mod, name)(problem, *args, **k, **extra)
        return type(e.value), str(e.value)

    assert raised(pt, pt.SolveConfig, dict(device="cpu")) == raised(jt, jt.SolveConfig, {})


def test_selection_refuses_a_mesh(problem):
    """A mesh is ported (tests/test_torch_mesh_paths.py): what is not a
    ``make_mesh`` DeviceMesh (or a FlatMesh of one) is refused."""
    with pytest.raises(TypeError, match="make_mesh"):
        pt.solve_restarts(problem, rank=4, n_restarts=2, mesh=object(), device="cpu")


def test_restarts_with_frozen_template_columns(problem):
    """``n_frozen``: each member keeps its first columns at its initial
    (clamped) ones, bit for bit, and is ``solve_semi`` member by member."""
    rng = np.random.RandomState(9)
    r, k, f = 3, 6, 2
    template = rng.rand(64, f).astype(np.float32)
    w0s = np.stack([np.concatenate([template, rng.rand(64, k - f).astype(np.float32)], axis=1)
                    for _ in range(r)])
    h0s = rng.rand(r, k, 80).astype(np.float32)
    tc, jc = _cfg(max_iter=12, check_every=6)
    sel = pt.solve_restarts(problem, w0s=w0s, h0s=h0s, config=tc, n_frozen=f, device="cpu")
    ref = jt.solve_restarts(problem, w0s=w0s, h0s=h0s, config=jc, n_frozen=f)
    clamped = np.maximum(template, np.float32(2.2204e-16))
    for i in range(r):
        w_i = _np(sel.results.w[i])
        np.testing.assert_array_equal(w_i[:, :f], clamped)
        one = pt.solve_semi(problem, w0s[i], h0s[i], tc, n_frozen=f, device="cpu")
        assert torch.equal(sel.results.w[i], one.w)
        np.testing.assert_allclose(w_i, np.asarray(ref.results.w[i]), rtol=5e-5, atol=1e-7)
        np.testing.assert_allclose(sel.costs[i], ref.costs[i], rtol=1e-5)


@pytest.mark.parametrize("init", ["random", "scaled", "nndsvd", "nndsvda", "nndsvdar"])
def test_member_inits_are_nmf_tpus(init):
    """One SVD at Kmax for the SVD-based inits; every member's init byte for
    byte JAX's (``test_member_inits_shared_svd_bitwise``)."""
    x = np.random.RandomState(3).rand(48, 56).astype(np.float32)
    ranks = [3, 5, 5]
    ours = tsel._member_inits(x, ranks, init, seed=11)
    ref = jsel._member_inits(x, ranks, init, seed=11)
    for a, b in zip(ours, ref):
        assert a.tobytes() == b.tobytes()


def test_selection_live_metrics_normalized(problem):
    tc, _ = _cfg(track_cost=True)
    a = pt.solve_restarts(problem, rank=4, n_restarts=2, seed=3, device="cpu",
                          config=dataclasses.replace(tc, live_metrics=True))
    b = pt.solve_restarts(problem, rank=4, n_restarts=2, seed=3, device="cpu", config=tc)
    assert torch.equal(a.results.w, b.results.w)


def test_selection_tracks_cost_and_runs_every_step_through_the_wrappers(problem, monkeypatch):
    """The final cost is the selection signal: tracked even when the config
    says not; the step and cost of every member go through K1-K3's wrappers
    (their plain version on the CPU), once an iteration and a check for all
    members."""
    calls = {"update_h_fused": 0, "update_w_fused": 0, "kl_cost_fused": 0}
    for name in calls:
        def counting(*a, _n=name, _f=getattr(tfm, name), **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tfm, name, counting)
    tc, _ = _cfg(track_cost=False)
    res = pt.solve_restarts(problem, rank=4, n_restarts=3, config=tc, device="cpu")
    assert np.isfinite(res.costs).all()
    assert calls == {"update_h_fused": 40, "update_w_fused": 40, "kl_cost_fused": 4}
