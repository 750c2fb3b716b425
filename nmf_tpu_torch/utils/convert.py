"""Carry configs, state and results across the two packages, as NumPy.

The port never imports ``nmf_tpu``: a JAX ``SolveConfig`` crosses over as
``dataclasses.asdict(cfg)``, arrays as NumPy, and a result comes back as a
dict of NumPy values keyed by the ``SolveResult`` field names, so a test can
compare both packages field by field.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .config import Precision, SolveConfig
from .device import resolve_device

__all__ = ["config_from_dict", "state_from_numpy", "result_to_numpy", "RESULT_FIELDS"]

RESULT_FIELDS = (
    "w", "h", "iterations", "cost", "cost_history", "num_checks",
    "converged", "momentum",
)


def config_from_dict(d: Mapping) -> SolveConfig:
    """The port's ``SolveConfig`` from ``dataclasses.asdict`` of either
    package's config; unknown fields raise ``TypeError``."""
    d = dict(d)
    prec = d.pop("precision", None)
    if isinstance(prec, Mapping):
        prec = Precision(**prec)
    elif prec is None:
        prec = Precision()
    return SolveConfig(precision=prec, **d)


def state_from_numpy(x, w, h, device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """X, W and H as contiguous f32 tensors on ``device``."""
    dev = resolve_device(device)
    return tuple(
        torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=dev)
        for a in (x, w, h)
    )


def result_to_numpy(res) -> Dict[str, np.ndarray]:
    """Every ``SolveResult`` field as a NumPy array (None stays None)."""
    out = {}
    for f in RESULT_FIELDS:
        v = getattr(res, f)
        if v is not None and hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[f] = None if v is None else np.asarray(v)
    return out
