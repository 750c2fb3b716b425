"""The port's strict reference-replication mode (``solve_strict``) against
``nmf_tpu.models.strict`` on the CPU.

``pad_to_mult`` is NumPy in both packages: byte-equal.  The solve pads X, W
and H to 32-multiples, clamps the padded buffers and runs the plain f32
step over them; between the two packages only the f32 summation order of
the GEMMs differs, so factors are held to rtol 1e-4 / atol 1e-6 and costs
to rel 1e-5, as tests/test_torch_solver.py holds the plain solve, and the
padded NumPy oracle of tests/test_strict.py to its rtol 2e-5 / atol 1e-7.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import strict as jstrict  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import strict as pstrict  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, result_to_numpy  # noqa: E402

RTOL, ATOL, COST_RTOL = 1e-4, 1e-6, 1e-5


def _problem(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(m, n).astype(np.float32), rng.rand(m, k).astype(np.float32),
            rng.rand(k, n).astype(np.float32))


@pytest.fixture(scope="module")
def unaligned():
    return _problem(96, 12, 130, 23)   # K and N both pad (12->32, 130->160)


@pytest.fixture(scope="module")
def aligned():
    return _problem(64, 32, 128, 5)


def _both(data, jcfg):
    x, w, h = data
    rj = jstrict.solve_strict(x, w, h, jcfg)
    rp = pt.solve_strict(x, w, h, config_from_dict(dataclasses.asdict(jcfg)), device="cpu")
    return rj, rp


def _assert_match(rj, rp):
    out = result_to_numpy(rp)
    for f in ("iterations", "num_checks", "converged"):
        assert out[f] == np.asarray(getattr(rj, f)), f
    for f in ("w", "h"):
        assert out[f].shape == np.shape(getattr(rj, f))
        assert getattr(rp, f).is_contiguous()
        np.testing.assert_allclose(out[f], np.asarray(getattr(rj, f)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["cost_history"], np.asarray(rj.cost_history), rtol=COST_RTOL)
    assert np.isnan(out["momentum"]) and out["w_ex"] is None


@pytest.mark.parametrize("cfg", [dict(max_iter=30, check_every=10), dict(max_iter=30, track_cost=False),
                                 dict(max_iter=200, check_every=25, thresh=1e-4)],
                         ids=["tracked", "untracked", "thresh"])
def test_unaligned_matches_jax(unaligned, cfg):
    rj, rp = _both(unaligned, jt.SolveConfig(**cfg))
    _assert_match(rj, rp)
    assert tuple(rp.w.shape) == (96, 12) and tuple(rp.h.shape) == (12, 130)


def test_aligned_matches_jax_and_equals_plain_solve(aligned):
    """No padding at 32-multiples: strict mode is the plain jnp f32 solve,
    bit for bit, in the port as in nmf_tpu."""
    x, w, h = aligned
    cfg = jt.SolveConfig(max_iter=20, backend="jnp")
    rj, rp = _both(aligned, cfg)
    _assert_match(rj, rp)
    plain = pt.solve(x, w, h, config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    assert torch.equal(rp.w, plain.w) and torch.equal(rp.h, plain.h)


def test_matches_padded_numpy_oracle(unaligned):
    """tests/test_strict.py's oracle: the reference algorithm with its padding."""
    from test_strict import _np_padded_reference

    x, w, h = unaligned
    res = pt.solve_strict(x, w, h, pt.SolveConfig(max_iter=30, track_cost=False), device="cpu")
    ow, oh = _np_padded_reference(x, w, h, 30)
    np.testing.assert_allclose(res.w.numpy(), ow, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(res.h.numpy(), oh, rtol=2e-5, atol=1e-7)


def test_differs_from_clean_solve_via_padding(unaligned):
    x, w, h = unaligned
    cfg = pt.SolveConfig(max_iter=30, check_every=30)
    strict = pt.solve_strict(x, w, h, cfg, device="cpu")
    clean = pt.solve(x, w, h, cfg, device="cpu")
    assert not torch.equal(strict.h, clean.h)
    assert float(strict.cost) == pytest.approx(float(clean.cost), rel=1e-4)


def test_rerun_bitwise(unaligned):
    x, w, h = unaligned
    cfg = pt.SolveConfig(max_iter=25, track_cost=False)
    a = pt.solve_strict(x, w, h, cfg, device="cpu")
    b = pt.solve_strict(x, w, h, cfg, device="cpu")
    assert torch.equal(a.w, b.w) and torch.equal(a.h, b.h)


@pytest.mark.parametrize("shape", [(5, 33), (32, 64), (1, 1), (64, 31)])
def test_pad_to_mult_byte_equal(shape):
    a = np.random.RandomState(0).rand(*shape).astype(np.float32)
    ours, ref = pstrict.pad_to_mult(a), jstrict.pad_to_mult(a)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape and ours.tobytes() == ref.tobytes()
    assert pstrict.pad_to_mult(a, 8).tobytes() == jstrict.pad_to_mult(a, 8).tobytes()
    assert pstrict.PAD_MULT == jstrict.PAD_MULT == 32


@pytest.mark.parametrize(
    "kw",
    [{"accelerate": True}, {"algorithm": "hals", "beta": 2.0}, {"beta": 2.0}, {"l1_h": 0.1}],
    ids=["accelerate", "hals", "beta", "penalty"],
)
def test_refuses_other_algorithms_like_jax(unaligned, kw):
    x, w, h = unaligned
    with pytest.raises(ValueError) as ej:
        jstrict.solve_strict(x, w, h, jt.SolveConfig(max_iter=5, **kw))
    with pytest.raises(ValueError) as et:
        pt.solve_strict(x, w, h, pt.SolveConfig(max_iter=5, **kw), device="cpu")
    assert str(et.value) == str(ej.value)
    assert "replicates" in str(et.value)


def test_shape_mismatch_like_jax(unaligned):
    x, w, h = unaligned
    with pytest.raises(ValueError) as ej:
        jstrict.solve_strict(x, w[:, :5], h)
    with pytest.raises(ValueError) as et:
        pt.solve_strict(x, w[:, :5], h, device="cpu")
    assert str(et.value) == str(ej.value)


def test_public_names():
    assert pt.solve_strict is pstrict.solve_strict and "solve_strict" in pt.__all__
    for name in ("PAD_MULT", "pad_to_mult", "solve_strict"):
        assert name in pt.models.__all__
