"""Numerical guards: NaN/Inf/negativity checks for inputs and results.

Counterpart of ``nmf_tpu.utils.guards``: the same accept/reject decisions
and messages.  The arrays are NumPy arrays (``ml_dtypes`` bf16 among them)
or tensors on any device; a tensor is checked where it lies, and only the
counts, the first offending index and its value come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["validate_input", "validate_result", "GuardError"]


class GuardError(ValueError):
    """An input or result failed a numerical sanity check."""


def _np_float_dtype(dtype) -> bool:
    # np.issubdtype rejects ml_dtypes' bfloat16, a storage dtype here too
    if np.issubdtype(dtype, np.floating):
        return True
    try:
        import ml_dtypes
    except ImportError:  # pragma: no cover
        return False
    return dtype == np.dtype(ml_dtypes.bfloat16)


def _as_float(name: str, arr):
    """``arr`` as a floating tensor (NumPy arrays viewed or copied, a bf16
    array as exact f32); a non-floating dtype raises :class:`GuardError`
    naming the NumPy dtype, as JAX's guard does."""
    if isinstance(arr, torch.Tensor):
        if not arr.is_floating_point():
            raise GuardError(f"{name}: expected floating dtype, got {str(arr.dtype)[6:]}")
        return arr.detach()
    a = np.asarray(arr)
    if not _np_float_dtype(a.dtype):
        raise GuardError(f"{name}: expected floating dtype, got {a.dtype}")
    if not np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)   # bf16: exact in f32
    return torch.as_tensor(np.asarray(a, order="C"))


def _first(mask: torch.Tensor):
    """(count, first index in C order) of the True entries of ``mask``."""
    n = int(mask.sum())
    return n, (tuple(int(v) for v in torch.nonzero(mask)[0].tolist()) if n else None)


def validate_input(name: str, arr) -> None:
    """Check an input matrix is finite and non-negative."""
    t = _as_float(name, arr)
    n, i = _first(~torch.isfinite(t))
    if n:
        raise GuardError(f"{name}: {n} non-finite entries (first at {i})")
    n, i = _first(t < 0)
    if n:
        raise GuardError(
            f"{name}: {n} negative entries (first at {i}, "
            f"value {float(t[i]):.6g}); NMF requires non-negative data"
        )


def validate_result(result) -> None:
    """Check a SolveResult's factors and cost are finite."""
    for name, arr in (("W", result.w), ("H", result.h)):
        t = arr.detach() if isinstance(arr, torch.Tensor) else torch.as_tensor(
            np.asarray(arr, np.float32, order="C"))
        n, i = _first(~torch.isfinite(t))
        if n:
            raise GuardError(
                f"result {name}: {n} non-finite entries "
                f"(first at {i}) after {int(result.iterations)} iterations"
            )
    cost = float(result.cost)
    if int(result.num_checks) > 0:  # untracked runs legitimately carry NaN
        if not np.isfinite(cost):
            raise GuardError(f"result cost is {cost} after {int(result.iterations)} iterations")
