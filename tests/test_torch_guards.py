"""``nmf_tpu_torch.utils.guards`` against ``nmf_tpu.utils.guards``.

The same arrays go to both guards, as NumPy to JAX's and as NumPy or as
tensors to the port's: the same accept/reject decision, the same error
type (``GuardError``, a ``ValueError``) and the same message.
"""

import types

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nmf_tpu.utils import guards as jg  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.utils import guards as pg  # noqa: E402


def _outcome(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


def _arrays():
    rng = np.random.RandomState(0)
    base = rng.rand(6, 5).astype(np.float32)
    nan, inf, neg, ninf = base.copy(), base.copy(), base.copy(), base.copy()
    nan[2, 3] = np.nan
    nan[4, 0] = np.nan
    inf[0, 1] = np.inf
    ninf[5, 4] = -np.inf
    neg[1, 2], neg[3, 3] = -0.25, -7.5
    both = neg.copy()
    both[5, 0] = np.nan
    cube = rng.rand(3, 4, 2).astype(np.float32)
    cube[2, 1, 1] = -1e-30
    return {
        "finite": base, "zeros": np.zeros((3, 3), np.float32), "nan": nan, "inf": inf,
        "neg_inf": ninf, "negative": neg, "nan_and_negative": both, "cube": cube,
        "f64": base.astype(np.float64), "f16": base.astype(np.float16),
        "int32": (base * 10).astype(np.int32), "int64": (base * 10).astype(np.int64),
        "uint8": (base * 10).astype(np.uint8), "bool": base > 0.5,
        "bf16": base.astype(ml_dtypes.bfloat16), "bf16_negative": neg.astype(ml_dtypes.bfloat16),
        "vector": base[0], "scalar": np.float32(-2.0),
    }


ARRAYS = _arrays()


@pytest.mark.parametrize("case", list(ARRAYS))
def test_validate_input_numpy(case):
    a = ARRAYS[case]
    assert _outcome(pg.validate_input, "X", a) == _outcome(jg.validate_input, "X", a)


def _tensor(a):
    if a.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", list(ARRAYS))
def test_validate_input_tensor(case):
    """A tensor (on the CPU here; on the card the checks run there) gets the
    decision and message of the NumPy array it holds."""
    a = ARRAYS[case]
    assert _outcome(pg.validate_input, "W0", _tensor(a)) == _outcome(jg.validate_input, "W0", a)


def test_rejections_name_first_entry():
    """The first offending entry in C order, with its value."""
    msg = _outcome(pg.validate_input, "X batch", ARRAYS["negative"])[1]
    assert msg == ("X batch: 2 negative entries (first at (1, 2), value -0.25); "
                   "NMF requires non-negative data")
    assert _outcome(pg.validate_input, "H", ARRAYS["nan"])[1] == \
        "H: 2 non-finite entries (first at (2, 3))"
    assert issubclass(pg.GuardError, ValueError)


def _result(w, h, cost, checks, iters=7):
    return types.SimpleNamespace(w=w, h=h, cost=cost, num_checks=checks, iterations=iters)


def _results():
    rng = np.random.RandomState(1)
    w, h = rng.rand(5, 2).astype(np.float32), rng.rand(2, 4).astype(np.float32)
    w_nan, h_inf = w.copy(), h.copy()
    w_nan[3, 1] = np.nan
    h_inf[0, 2] = np.inf
    return {
        "clean": (w, h, np.float32(3.5), 2),
        "w_nan": (w_nan, h, np.float32(3.5), 2),
        "h_inf": (w, h_inf, np.float32(3.5), 2),
        "cost_nan": (w, h, np.float32(np.nan), 2),
        "untracked_nan": (w, h, np.float32(np.nan), 0),
        "cost_inf": (w, h, np.float32(np.inf), 1),
        "bf16": (w.astype(ml_dtypes.bfloat16), h.astype(ml_dtypes.bfloat16), np.float32(1.0), 1),
    }


@pytest.mark.parametrize("case", list(_results()))
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_validate_result(case, as_tensor):
    w, h, cost, checks = _results()[case]
    ref = _outcome(jg.validate_result, _result(w, h, cost, checks))
    if as_tensor:
        w, h = _tensor(w), _tensor(h)
        cost, checks = torch.tensor(float(cost)), torch.tensor(checks, dtype=torch.int32)
    assert _outcome(pg.validate_result, _result(w, h, cost, checks)) == ref


def test_validate_result_of_a_solve():
    """A port solve's SolveResult (tensors) passes; its NaN twin fails as
    JAX's guard fails the NumPy copy."""
    rng = np.random.RandomState(2)
    x, w, h = rng.rand(8, 6), rng.rand(8, 2), rng.rand(2, 6)
    res = pt.solve(x, w, h, pt.SolveConfig(max_iter=5), device="cpu")
    pg.validate_result(res)
    res.h[1, 1] = float("nan")
    ours = _outcome(pg.validate_result, res)
    ref = _outcome(jg.validate_result, _result(res.w.numpy(), res.h.numpy(), float(res.cost),
                                               int(res.num_checks), int(res.iterations)))
    assert ours == ref and "result H: 1 non-finite entries (first at (1, 1))" in ours[1]


def test_public_names():
    from nmf_tpu_torch import utils

    for name in ("GuardError", "validate_input", "validate_result"):
        assert getattr(utils, name) is getattr(pg, name) and name in utils.__all__
