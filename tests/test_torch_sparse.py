"""The COO sparse solve of the port (``models/sparse.py``) against
``nmf_tpu.solve_sparse`` on the CPU, mirroring ``tests/test_sparse.py``.

The same >= 99%-sparse problem (96 x 130, K=8, seed 31) goes through both
packages.  The port sums each chunk's contributions per run of a sorted
index and the chunks in order, JAX scatters them (``.at[].add``), so the
sums run in other orders.  Tolerances: factors rtol 1e-4 / atol 1e-7 and
cost histories rtol 1e-5, ``tests/test_sparse.py``'s own (measured: the
largest excess over rtol 1e-4 is 2.6e-10 on H, 1.6e-7 on the history);
chunk against chunk, as JAX's test, rtol 1e-5 / atol 1e-8 (measured 2.2e-6
on W).  Under a bf16 state both packages give the same bits here.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu.models import sparse as jsp  # noqa: E402
from nmf_tpu_torch.models import sparse as psp  # noqa: E402

# the COO path is deprecated in both packages; these tests are its oracle
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

RTOL, ATOL, COST_RTOL = 1e-4, 1e-7, 1e-5


@pytest.fixture(scope="module")
def sparse_problem():
    rng = np.random.RandomState(31)
    m, k, n = 96, 8, 130
    x = rng.rand(m, n).astype(np.float32)
    x[rng.rand(m, n) < 0.99] = 0.0  # >= 99% sparse
    # at least one nonzero per row and column, as tests/test_sparse.py
    x[np.arange(m), rng.randint(0, n, m)] = rng.rand(m).astype(np.float32) + 0.1
    x[rng.randint(0, m, n), np.arange(n)] = rng.rand(n).astype(np.float32) + 0.1
    w = rng.rand(m, k).astype(np.float32)
    h = rng.rand(k, n).astype(np.float32)
    return x, w, h


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(ours, ref, rtol=RTOL, atol=ATOL, cost_rtol=COST_RTOL):
    np.testing.assert_allclose(_np(ours.w), _np(ref.w), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(ours.h), _np(ref.h), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(ours.cost_history), _np(ref.cost_history), rtol=cost_rtol)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [512, 128])
def test_matches_jax(sparse_problem, chunk, state):
    """30 iterations, a check every 10, at two chunk sizes and both state
    dtypes: the port's factors and history against ``nmf_tpu``'s."""
    x, w, h = sparse_problem
    kw = dict(max_iter=30, check_every=10)
    ref = jsp.solve_sparse(x, w, h, jt.SolveConfig(**kw, precision=jt.Precision(state_dtype=state)),
                           chunk=chunk)
    ours = psp.solve_sparse(x, w, h, pt.SolveConfig(**kw, precision=pt.Precision(state_dtype=state)),
                            chunk=chunk, device="cpu")
    assert int(ours.iterations) == int(ref.iterations) == 30
    assert int(ours.num_checks) == int(ref.num_checks) == 3
    assert ours.w.dtype == (torch.bfloat16 if state == "bfloat16" else torch.float32)
    _close(ours, ref)


def test_matches_jax_accelerated(sparse_problem):
    """``accelerate=True`` runs through the port's loop, as JAX's: the
    history and factors at the file's tolerances, the momentum (an f32
    product of the same accept sequence) bit for bit."""
    x, w, h = sparse_problem
    kw = dict(max_iter=30, check_every=5, accelerate=True)
    ref = jsp.solve_sparse(x, w, h, jt.SolveConfig(**kw), chunk=512)
    ours = psp.solve_sparse(x, w, h, pt.SolveConfig(**kw), chunk=512, device="cpu")
    _close(ours, ref, rtol=1e-3)
    assert np.float32(ours.momentum).tobytes() == np.float32(ref.momentum).tobytes()


def test_matches_dense_unclamped(sparse_problem):
    """Exact zeros: the port's sparse solve equals its dense solve with
    ``clamp_inputs=False`` (W0 and H0 clamped by hand), across the history
    and the factors (``tests/test_sparse.py``'s bar)."""
    x, w, h = sparse_problem
    cfg = pt.SolveConfig(max_iter=30, check_every=10)
    eps = np.float32(cfg.eps)
    ref = pt.solve(x, np.maximum(w, eps), np.maximum(h, eps), cfg, clamp_inputs=False,
                   device="cpu")
    ours = pt.solve_sparse(x, w, h, cfg, chunk=512, device="cpu")
    assert int(ours.iterations) == 30
    _close(ours, ref)


def test_chunk_independent_and_bitwise_on_rerun(sparse_problem):
    """Padding entries are inert: chunk 512 and 128 agree (JAX's test's
    bar), and a rerun gives the same bits (no atomics in the reduction)."""
    x, w, h = sparse_problem
    cfg = pt.SolveConfig(max_iter=10, check_every=10)
    a = pt.solve_sparse(x, w, h, cfg, chunk=512, device="cpu")
    b = pt.solve_sparse(x, w, h, cfg, chunk=128, device="cpu")
    np.testing.assert_allclose(_np(a.w), _np(b.w), rtol=1e-5, atol=1e-8)
    again = pt.solve_sparse(x, w, h, cfg, chunk=512, device="cpu")
    for f in ("w", "h", "cost_history"):
        assert getattr(a, f).numpy().tobytes() == getattr(again, f).numpy().tobytes(), f


def test_sparse_x_input_matches_dense_input(sparse_problem):
    """A :class:`SparseX` of tensors in column-major order gives the bits
    of the dense input (row-major): the port sorts the nonzeros itself, and
    stably, so within a row or a column both inputs list the entries in
    the same order."""
    x, w, h = sparse_problem
    cfg = pt.SolveConfig(max_iter=10, check_every=5)
    sx = pt.sparse_from_dense(x)
    rev = np.argsort(sx.cols, kind="stable")     # column-major order
    sxt = pt.SparseX(data=torch.from_numpy(sx.data[rev]), rows=torch.from_numpy(sx.rows[rev]),
                     cols=torch.from_numpy(sx.cols[rev]), shape=sx.shape)
    a = pt.solve_sparse(x, w, h, cfg, chunk=128, device="cpu")
    b = pt.solve_sparse(sxt, w, h, cfg, chunk=128, device="cpu")
    for f in ("w", "h", "cost_history"):
        assert getattr(a, f).numpy().tobytes() == getattr(b, f).numpy().tobytes(), f


def test_sparse_memory_is_nnz_proportional(sparse_problem):
    """The solver's X is the COO triplet, nnz words and not M*N: the
    container, its chunk padding (a multiple of the chunk, inert: the same
    result from padded and raw input) and the two sorted orders on the
    device each hold the padded nnz, no more."""
    x, w, h = sparse_problem
    sx = pt.sparse_from_dense(x)
    nnz = int(sx.data.shape[0])
    assert nnz < 0.05 * x.size
    jsx = jsp.sparse_from_dense(x)
    for f in ("data", "rows", "cols"):
        assert getattr(sx, f).tobytes() == np.asarray(getattr(jsx, f)).tobytes(), f
    assert sx.shape == jsx.shape
    padded = psp._pad_chunks(sx, 512)
    assert padded.data.shape[0] % 512 == 0 and padded.data.shape[0] == 512
    jpad = jsp._pad_chunks(jsx, 512)
    assert padded.data.tobytes() == np.asarray(jpad.data).tobytes()
    assert padded.rows.tobytes() == np.asarray(jpad.rows).tobytes()
    tpad = psp._pad_chunks(pt.SparseX(*(torch.from_numpy(getattr(sx, f))
                                        for f in ("data", "rows", "cols")), sx.shape), 512)
    assert tpad.data.numpy().tobytes() == padded.data.tobytes()
    order = psp._order(padded.data, padded.rows.astype(np.int64), padded.cols.astype(np.int64),
                       padded.cols.astype(np.int64), 512, torch.device("cpu"))
    assert order.data.numel() == order.rows.numel() == order.cols.numel() == 512
    assert order.keys.numel() <= 512 and int(order.lengths.sum()) == 512
    cfg = pt.SolveConfig(max_iter=10, check_every=10)
    a = pt.solve_sparse(sx, w, h, cfg, chunk=512, device="cpu")
    b = pt.solve_sparse(padded, w, h, cfg, chunk=512, device="cpu")
    assert a.w.numpy().tobytes() == b.w.numpy().tobytes()


def test_threshold_convergence(sparse_problem):
    x, w, h = sparse_problem
    cfg = dict(max_iter=100_000, thresh=1e-3, check_every=10)
    ours = pt.solve_sparse(x, w, h, pt.SolveConfig(**cfg), chunk=512, device="cpu")
    ref = jsp.solve_sparse(x, w, h, jt.SolveConfig(**cfg), chunk=512)
    assert bool(ours.converged) and int(ours.iterations) < 100_000
    assert int(ours.iterations) == int(ref.iterations)


def _messages(ours, ref, exc):
    with pytest.raises(exc) as eo:
        ours()
    with pytest.raises(exc) as er:
        ref()
    return str(eo.value), str(er.value)


@pytest.mark.parametrize("kw", [dict(beta=2.0), dict(algorithm="hals", beta=2.0), dict(l1_w=0.1)],
                         ids=["beta", "hals", "penalized"])
def test_refuses_other_families_with_jaxs_message(sparse_problem, kw):
    x, w, h = sparse_problem
    ours, ref = _messages(
        lambda: pt.solve_sparse(x, w, h, pt.SolveConfig(max_iter=2, **kw), device="cpu"),
        lambda: jsp.solve_sparse(x, w, h, jt.SolveConfig(max_iter=2, **kw)),
        NotImplementedError)
    assert ours == ref == "sparse solve implements the KL (beta=1) MU family"


def test_shape_mismatch_with_jaxs_message(sparse_problem):
    x, w, h = sparse_problem
    ours, ref = _messages(
        lambda: pt.solve_sparse(x, w[:-1], h, pt.SolveConfig(max_iter=2), device="cpu"),
        lambda: jsp.solve_sparse(x, w[:-1], h, jt.SolveConfig(max_iter=2)),
        ValueError)
    assert ours == ref and "shape mismatch" in ours


@pytest.mark.parametrize("as_tensor", [False, True])
def test_negative_data_rejected(as_tensor):
    x = np.array([[1.0, -0.5], [0.0, 2.0]], np.float32)
    arg = torch.from_numpy(x) if as_tensor else x
    ours, ref = _messages(lambda: pt.sparse_from_dense(arg), lambda: jsp.sparse_from_dense(x),
                          ValueError)
    assert ours == ref and "nonnegative" in ours


def test_deprecation_warning_is_jaxs(sparse_problem):
    x, w, h = sparse_problem
    caught = {}
    for name, fn in (("ours", lambda: pt.solve_sparse(x, w, h, pt.SolveConfig(max_iter=1),
                                                      device="cpu")),
                     ("ref", lambda: jsp.solve_sparse(x, w, h, jt.SolveConfig(max_iter=1)))):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn()
        dep = [r for r in rec if issubclass(r.category, DeprecationWarning)]
        assert len(dep) >= 1, name
        caught[name] = (str(dep[0].message), dep[0].filename)
    assert caught["ours"][0] == caught["ref"][0]
    assert caught["ours"][1] == __file__          # stacklevel=2: the caller's line


def test_names_exported_as_in_jax():
    import nmf_tpu.models as jm
    import nmf_tpu_torch.models as pm

    for name in ("SparseX", "solve_sparse", "sparse_from_dense"):
        assert name in jt.__all__ and name in pt.__all__
        assert name in jm.__all__ and name in pm.__all__
    assert pt.SparseX is psp.SparseX and pt.solve_sparse is psp.solve_sparse
