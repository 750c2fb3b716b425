"""The port's consensus-clustering stability study against ``nmf_tpu``'s.

Each case of ``tests/test_stability.py``, run through both packages on the
same seeded NumPy inputs (a planted rank-3 block structure).  The host
consensus is the same code on both sides, fed each package's H: where
every member labels each column alike in both packages (the planted rank),
the consensus matrices are equal and the cophenetic coefficients agree to
1e-12; elsewhere (an overfit rank splits blocks by rounding-sized
differences) they agree in order, not value.  ``consensus_matrix`` on the
same H is JAX's byte for byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import stability as jstab  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import stability as tstab  # noqa: E402


@pytest.fixture(scope="module")
def planted():
    """X with a planted rank-3 block structure (``tests/test_stability.py``)."""
    rng = np.random.RandomState(7)
    m, n, ktrue = 60, 48, 3
    w = np.zeros((m, ktrue), np.float32)
    h = np.zeros((ktrue, n), np.float32)
    for j in range(ktrue):
        w[j * (m // ktrue):(j + 1) * (m // ktrue), j] = 1.0 + rng.rand(m // ktrue)
        h[j, j * (n // ktrue):(j + 1) * (n // ktrue)] = 1.0 + rng.rand(n // ktrue)
    return (w @ h + 0.01 * rng.rand(m, n).astype(np.float32)).astype(np.float32)


CFG = dict(max_iter=120, check_every=40)


def _both(planted, **kw):
    ours = pt.rank_stability(planted, config=pt.SolveConfig(**CFG), device="cpu", **kw)
    ref = jt.rank_stability(planted, config=jt.SolveConfig(**CFG), **kw)
    return ours, ref


def test_rank_stability_identifies_planted_rank(planted):
    ours, ref = _both(planted, ranks=[2, 3, 5], n_restarts=8, seed=1)
    assert ours.cophenetic.shape == (3,)
    r = list(ours.ranks)
    k3, k5 = ours.cophenetic[r.index(3)], ours.cophenetic[r.index(5)]
    assert k3 > 0.98 and k3 > k5
    assert 0.0 <= ours.dispersion.min() and ours.dispersion.max() <= 1.0 + 1e-9
    assert ours.dispersion[r.index(3)] >= ours.dispersion[r.index(5)]
    np.testing.assert_array_equal(ours.ranks, ref.ranks)
    assert ours.cophenetic[r.index(3)] == pytest.approx(ref.cophenetic[r.index(3)], abs=1e-12)
    assert ours.best_rank() == ref.best_rank()


def test_consensus_matrix_properties(planted):
    sweep = pt.solve_rank_sweep(planted, [3] * 6, config=pt.SolveConfig(**CFG), seed=2,
                                init="random", device="cpu")
    c = pt.consensus_matrix(sweep, 3)
    n = planted.shape[1]
    assert c.shape == (n, n) and c.dtype == np.float32
    np.testing.assert_allclose(c, c.T, atol=0)
    np.testing.assert_allclose(np.diag(c), np.ones(n))
    assert c.min() >= 0.0 and c.max() <= 1.0
    ref = jt.consensus_matrix(jt.solve_rank_sweep(planted, [3] * 6, config=jt.SolveConfig(**CFG),
                                                  seed=2, init="random"), 3)
    np.testing.assert_array_equal(c, ref)
    with pytest.raises(ValueError, match="no members with rank 4"):
        pt.consensus_matrix(sweep, 4)


def test_consensus_from_host_is_nmf_tpus():
    """The host assembly on the same H: byte for byte JAX's."""
    rng = np.random.RandomState(4)
    h_all = rng.rand(6, 5, 30).astype(np.float32)
    ranks = np.array([3, 3, 5, 5, 5, 3])
    for k in (3, 5):
        a = tstab._consensus_from_host(h_all, ranks, k)
        assert a.tobytes() == jstab._consensus_from_host(h_all, ranks, k).tobytes()


def test_rank_stability_keep_consensus_and_best_rank(planted):
    ours, ref = _both(planted, ranks=[3, 5], n_restarts=6, seed=0, keep_consensus=True)
    assert set(ours.consensus) == {3, 5}
    assert ours.best_rank() == 3 == ref.best_rank()
    np.testing.assert_array_equal(ours.consensus[3], ref.consensus[3])


@pytest.mark.parametrize("kw", [dict(ranks=[], n_restarts=4), dict(ranks=[3], n_restarts=1),
                                dict(ranks=[3], n_restarts=4, init="nndsvda")],
                         ids=["no_ranks", "one_restart", "deterministic_init"])
def test_rank_stability_validation(planted, kw):
    with pytest.raises(ValueError) as ours:
        pt.rank_stability(planted, device="cpu", **kw)
    with pytest.raises(ValueError) as ref:
        jt.rank_stability(planted, **kw)
    assert str(ours.value) == str(ref.value)


def test_rank_stability_sorts_and_dedupes_ranks(planted):
    a = pt.rank_stability(planted, ranks=[5, 3, 3], n_restarts=4,
                          config=pt.SolveConfig(**CFG), seed=1, device="cpu")
    b = pt.rank_stability(planted, ranks=[3, 5], n_restarts=4,
                          config=pt.SolveConfig(**CFG), seed=1, device="cpu")
    np.testing.assert_array_equal(a.ranks, [3, 5])
    np.testing.assert_allclose(a.cophenetic, b.cophenetic)
    assert a.sweep.n_members == 8


def test_cophenetic_degenerate_consensus_is_finite():
    c = np.full((4, 4), 0.5, np.float32)
    np.fill_diagonal(c, 1.0)
    v = tstab._cophenetic(c)
    assert np.isfinite(v) and v == 0.0 == jstab._cophenetic(c)
    assert tstab._cophenetic(np.ones((4, 4), np.float32)) == 1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_cophenetic_is_nmf_tpus(seed):
    """The coefficient of one consensus matrix, as nmf_tpu takes it."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 3, size=(5, 20))
    c = np.mean(labels[:, :, None] == labels[:, None, :], axis=0).astype(np.float32)
    assert tstab._cophenetic(c.copy()) == jstab._cophenetic(c.copy())
