"""The port's factor inits (``nmf_tpu_torch.models.init``) against
``nmf_tpu.models.init`` on the same NumPy inputs.

Both packages run the same NumPy code, so every init is held to the bytes:
``random_init``, ``scaled_random_init`` and the three NNDSVD variants, with
a precomputed ``svd=`` as well, and their errors word for word.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nmf_tpu.models import init as jinit  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import init as pinit  # noqa: E402


def _x(m, n, seed, sparse=False):
    x = np.random.RandomState(seed).rand(m, n).astype(np.float32)
    if sparse:   # exact zeros: nndsvd keeps them, the other variants fill them
        x[x < 0.6] = 0.0
    return x


def _same(a, b):
    for ours, ref in zip(a, b):
        assert ours.dtype == ref.dtype == np.float32
        assert ours.shape == ref.shape
        assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("m,k,n,seed", [(40, 4, 30, 3), (7, 1, 9, 0), (96, 12, 130, 11)])
def test_random_init_byte_equal(m, k, n, seed):
    _same(pinit.random_init(m, k, n, seed=seed), jinit.random_init(m, k, n, seed=seed))


@pytest.mark.parametrize("shape,k,seed", [((40, 30), 4, 3), ((96, 130), 12, 11), ((5, 5), 5, 0)])
def test_scaled_random_init_byte_equal(shape, k, seed):
    x = _x(*shape, seed)
    _same(pinit.scaled_random_init(x, k, seed=seed), jinit.scaled_random_init(x, k, seed=seed))


def test_scaled_random_init_on_all_zero_x():
    """mean(X) = 0 takes the f32 ``tiny`` floor in both."""
    x = np.zeros((8, 6), np.float32)
    _same(pinit.scaled_random_init(x, 3), jinit.scaled_random_init(x, 3))


@pytest.mark.parametrize("variant", ["nndsvd", "nndsvda", "nndsvdar"])
@pytest.mark.parametrize("shape,k,sparse", [((40, 30), 4, False), ((96, 130), 12, True),
                                            ((30, 40), 30, False)])
def test_nndsvd_variants_byte_equal(variant, shape, k, sparse):
    x = _x(*shape, 5, sparse)
    _same(pinit.nndsvd_init(x, k, variant=variant, seed=7),
          jinit.nndsvd_init(x, k, variant=variant, seed=7))


@pytest.mark.parametrize("variant", ["nndsvda", "nndsvdar"])
def test_nndsvd_with_precomputed_svd_byte_equal(variant):
    """``svd=`` (one SVD sliced per rank) gives the bytes of the SVD taken inside."""
    x = _x(50, 40, 9)
    svd = np.linalg.svd(x.astype(np.float64), full_matrices=False)
    for k in (3, 8):
        ours = pinit.nndsvd_init(x, k, variant=variant, seed=1, svd=svd)
        _same(ours, jinit.nndsvd_init(x, k, variant=variant, seed=1, svd=svd))
        _same(ours, jinit.nndsvd_init(x, k, variant=variant, seed=1))


def test_nndsvda_fills_no_zero():
    w, h = pinit.nndsvd_init(_x(60, 50, 2, sparse=True), 10, variant="nndsvda")
    assert (w > 0).all() and (h > 0).all()


@pytest.mark.parametrize(
    "kw",
    [{"k": 41}, {"k": 4, "variant": "nndsvdx"}, {"k": 4, "variant": "random"}],
    ids=["rank", "variant", "random"],
)
def test_nndsvd_errors_match_jax(kw):
    x = _x(40, 50, 1)
    with pytest.raises(ValueError) as ej:
        jinit.nndsvd_init(x, **kw)
    with pytest.raises(ValueError) as et:
        pinit.nndsvd_init(x, **kw)
    assert str(et.value) == str(ej.value)
    assert "unknown NNDSVD variant" in str(et.value) or "exceeds min(M, N) = 40" in str(et.value)


def test_public_names():
    for name in ("random_init", "scaled_random_init", "nndsvd_init"):
        assert getattr(pt, name) is getattr(pinit, name)
        assert name in pt.__all__ and name in pt.models.__all__
