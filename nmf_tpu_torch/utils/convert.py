"""Carry configs, state and results across the two packages, as NumPy.

The port never imports ``nmf_tpu``: a JAX ``SolveConfig`` crosses over as
``dataclasses.asdict(cfg)``, arrays as NumPy, and a result comes back as a
dict of NumPy values keyed by the ``SolveResult`` field names, so a test can
compare both packages field by field.

NumPy has no bf16 of its own: a JAX bf16 array comes out of ``np.asarray``
with the ``ml_dtypes`` ``bfloat16`` dtype, and crosses bit for bit into a
``torch.bfloat16`` tensor; a bf16 tensor goes back as an f32 array, which
holds every bf16 value exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import Precision, SolveConfig
from .device import resolve_device

__all__ = [
    "accel_state_from",
    "config_from_dict",
    "nmf_from_params",
    "state_from_numpy",
    "result_to_numpy",
    "tile_sparse_from",
    "to_tensor",
    "RESULT_FIELDS",
]

RESULT_FIELDS = (
    "w", "h", "iterations", "cost", "cost_history", "num_checks",
    "converged", "momentum", "w_ex", "h_ex",
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


def nmf_from_params(params: Mapping, w_, components_, device="cuda"):
    """The port's fitted ``NMF`` from an estimator's ``get_params()`` (a JAX
    ``nmf_tpu.NMF``'s among them) and its fitted ``w_`` and ``components_``
    as NumPy (bf16 ones as exact f32): a dictionary learned in either
    package serves ``transform`` in the port.  ``precision`` crosses as its
    fields; ``mesh`` must be None (a JAX mesh does not cross)."""
    from ..models.nmf import NMF

    p = dict(params)
    if p.pop("mesh", None) is not None:
        raise NotImplementedError(
            "mesh (ROADMAP.md Queue 1 step 12, item 12: sharded solves) is not "
            "in the PyTorch port yet"
        )
    p.pop("device", None)
    prec = p.get("precision")
    if prec is not None and not isinstance(prec, Precision):
        p["precision"] = Precision(**dataclasses.asdict(prec))
    est = NMF(**p, device=device)
    est.w_ = np.asarray(w_, np.float32)
    est.components_ = np.asarray(components_, np.float32)
    return est


def to_tensor(a, device) -> torch.Tensor:
    """A contiguous tensor of ``a`` on ``device`` keeping its dtype: bf16
    (a tensor, or a NumPy array of the ``ml_dtypes`` bfloat16 dtype, bit
    for bit), uint8 codes and f32 stay as they are; any other float array
    becomes f32."""
    if isinstance(a, torch.Tensor):
        return a.to(device).contiguous()
    a = np.asarray(a)
    if not a.flags.writeable:   # e.g. a JAX array's buffer: the tensor owns a copy
        a = a.copy()
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device).contiguous()
    if a.dtype != np.uint8:
        a = a.astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def state_from_numpy(x, w, h, device="cuda") -> Tuple:
    """X, W and H as contiguous tensors on ``device``, each in its own
    dtype (:func:`to_tensor`): f32 or bf16 state, f32 or bf16 X, or X as a
    ``(uint8 codes, f32 scales)`` pair."""
    dev = resolve_device(device)
    xt = tuple(to_tensor(a, dev) for a in x) if isinstance(x, tuple) else to_tensor(x, dev)
    return xt, to_tensor(w, dev), to_tensor(h, dev)


def accel_state_from(res, device="cuda") -> Tuple[float, Optional[Tuple]]:
    """The accelerated loop's resume state in a result of either package,
    as ``solve``'s ``(initial_momentum, initial_extrap)``: the momentum as
    a float (the f32 value exactly; NaN for a plain solve), and ``(w_ex,
    h_ex)`` as tensors on ``device`` in their own dtype (bf16 bit for bit,
    :func:`to_tensor`), or None where the result carries none."""
    mom = res.momentum
    if isinstance(mom, torch.Tensor):
        mom = mom.detach().cpu().numpy()
    momentum = float(np.asarray(mom, np.float32))
    if getattr(res, "w_ex", None) is None:
        return momentum, None
    dev = resolve_device(device)
    return momentum, (to_tensor(res.w_ex, dev), to_tensor(res.h_ex, dev))


def tile_sparse_from(tx):
    """The port's ``TileSparseX`` from any object with ``.tiles``, ``.rows``,
    ``.cols`` and ``.shape`` (a JAX ``TileSparseX`` among them): the tiles
    as a CPU tensor (f32, or bf16 bit for bit, by :func:`to_tensor`), the
    block ids as int32 arrays."""
    from ..models.sparse_tiled import TileSparseX

    return TileSparseX(
        tiles=to_tensor(tx.tiles, "cpu"),
        rows=np.asarray(tx.rows, np.int32),
        cols=np.asarray(tx.cols, np.int32),
        shape=tuple(int(d) for d in tx.shape),
    )


def result_to_numpy(res) -> Dict[str, np.ndarray]:
    """Every ``SolveResult`` field as a NumPy array (None stays None); bf16
    factors come back as exact f32 copies."""
    out = {}
    for f in RESULT_FIELDS:
        v = getattr(res, f)
        if v is not None and hasattr(v, "detach"):
            v = v.detach().cpu()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[f] = None if v is None else np.asarray(v)
    return out
