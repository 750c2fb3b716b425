"""Quantized X storage: uint8 codes + per-column (or per-row-block) f32 scales.

Counterpart of ``nmf_tpu.ops.quant``, ported whole::

    q[i, j] = round(x[i, j] / s[j] * 255),   s[j] = max_i x[i, j]

stored as ``uint8`` codes and f32 scales; ``x ~= q * s``.  The kernels
K1-K3 (``csrc/fused_mu.cu``) dequantize per-column codes in register, so X
streams at one byte an entry; per-row-block scales (``x_quant_rows > 0``)
go to the plain ops on dequantized values.

Bit for bit.  Codes and scales equal the JAX package's and the NumPy
twins', on the CPU and on the card.  The scale is ``max(colmax, eps) *
float32(1/255)`` (a multiply, never ``/ 255``), and the code is the
canonical comparison-based one: the integer ``q`` with
``f32(s*(q-0.5)) <= x < f32(s*(q+0.5))``.  A fast approximate code (a
reciprocal multiply) is moved onto it in one step by :func:`_canonical_fixup`
using only correctly rounded f32 multiplies, adds and compares, the same op
sequence in every twin.  Each torch op here is its own kernel, so no
multiply-add is contracted into an FMA.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "quantize_columns",
    "quantize_rowblocks",
    "quantize_policy",
    "dequantize",
    "dequantize_rows",
    "quantize_columns_np",
    "quantize_rowblocks_np",
    "quantize_policy_np",
]

_F32 = torch.float32
# f32 constants as Python floats: each is exactly an f32 value, so the
# scalar torch casts to f32 is the NumPy twin's np.float32 constant
_INV255 = float(np.float32(1.0 / 255.0))


def _canonical_fixup(xf, q0, s_b, np_mod):
    """Move the approximate code ``q0`` (f32 integers, within +-1 of
    canonical) onto the canonical definition

        q = the integer with  f32(s*(q-0.5)) <= x < f32(s*(q+0.5))

    with correctly rounded f32 ops only, so NumPy, the CPU and the card give
    the same codes whatever the rounding of ``1/s``.  ``np_mod`` is
    ``numpy`` or ``torch``: the same op sequence runs in both twins
    (``nmf_tpu/ops/quant.py:61-84``)."""
    if np_mod is np:
        one, half, zero = np.float32(1.0), np.float32(0.5), np.float32(0.0)
    else:
        one, half, zero = 1.0, 0.5, 0.0
    hi = s_b * (q0 + half)   # threshold into q0+1 territory
    lo = s_b * (q0 - half)   # threshold below which q0-1 owns x
    up = np_mod.where(xf >= hi, one, zero)
    dn = np_mod.where(xf < lo, one, zero)
    return q0 + up - dn


def _codes(xf: torch.Tensor, scales_b: torch.Tensor) -> torch.Tensor:
    """uint8 codes of ``xf`` under broadcast scales ``scales_b``."""
    inv = 1.0 / scales_b
    q0 = torch.floor(xf * inv + 0.5)
    q1 = _canonical_fixup(xf, q0, scales_b, torch)
    return torch.clamp(q1, 0, 255).to(torch.uint8)


def quantize_columns(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 codes and per-column f32 scales with ``x ~= q * scales[None, :]``
    for a nonnegative (already eps-clamped) matrix; rounding half up."""
    xf = x.to(_F32)
    scales = torch.clamp_min(torch.amax(xf, dim=0), float(eps)) * _INV255
    return _codes(xf, scales[None, :]), scales


def _row_blocks(m: int, rows_per_block: int) -> Tuple[int, int]:
    """(R, rb): block count and the normalised block height
    ``ceil(M / ceil(M / rows_per_block))`` that :func:`dequantize` re-derives
    from shapes alone (``nmf_tpu/ops/quant.py:128-137``)."""
    r = -(-m // int(rows_per_block))
    return r, -(-m // r)


def quantize_rowblocks(
    x: torch.Tensor, eps: float, rows_per_block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 codes + (R, N) f32 scales with ``x[i, j] ~= q[i, j] *
    scales[i // rb, j]``, R = ceil(M / rows_per_block), rb normalised."""
    xf = x.to(_F32)
    m, n = xf.shape
    r, rb = _row_blocks(m, rows_per_block)
    pad = r * rb - m
    xp = torch.nn.functional.pad(xf, (0, 0, 0, pad)) if pad else xf
    blocks = xp.reshape(r, rb, n)
    scales = torch.clamp_min(torch.amax(blocks, dim=1), float(eps)) * _INV255  # (R, N)
    q = _codes(blocks, scales[:, None, :]).reshape(r * rb, n)[:m]
    return q.contiguous(), scales


def quantize_policy(x: torch.Tensor, eps: float, x_quant_rows: int):
    """Per-column scales (``x_quant_rows == 0``) or per-row-block ones."""
    if x_quant_rows:
        return quantize_rowblocks(x, eps, x_quant_rows)
    return quantize_columns(x, eps)


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """f32 values ``q * scale``; 1-D (N,) scales are per column, 2-D (R, N)
    per row block of the FULL row extent of ``q`` (for a row slice use
    :func:`dequantize_rows`).  No clamp is reapplied."""
    return dequantize_rows(q, scales, 0, q.shape[0])


def dequantize_rows(q, scales, row_offset: int, m_total: int) -> torch.Tensor:
    """Dequantize the row slice ``[row_offset, row_offset + m)`` of codes
    quantized at ``m_total`` rows: the block height comes from the full
    extent, never from the slice."""
    if scales.dim() == 1:
        return q.to(_F32) * scales[None, :]
    m = q.shape[0]
    rb = -(-int(m_total) // scales.shape[0])
    idx = (row_offset + torch.arange(m, device=q.device)) // rb
    return q.to(_F32) * scales[idx, :]


def quantize_columns_np(x, eps: float):
    """NumPy twin of :func:`quantize_columns` (host-side quantization)."""
    xf = np.asarray(x, np.float32)
    scales = np.maximum(xf.max(axis=0), np.float32(eps)) * np.float32(1.0 / 255.0)
    v = xf * (np.float32(1.0) / scales)[None, :]
    v += np.float32(0.5)
    np.floor(v, out=v)
    q1 = _canonical_fixup(xf, v, scales[None, :], np)
    np.clip(q1, 0, 255, out=q1)
    return q1.astype(np.uint8), scales


def quantize_rowblocks_np(x, eps: float, rows_per_block: int):
    """NumPy twin of :func:`quantize_rowblocks`."""
    xf = np.asarray(x, np.float32)
    m, n = xf.shape
    r, rb = _row_blocks(m, rows_per_block)
    pad = r * rb - m
    xp = np.pad(xf, ((0, pad), (0, 0))) if pad else xf
    blocks = xp.reshape(r, rb, n)
    scales = np.maximum(blocks.max(axis=1), np.float32(eps)) * np.float32(1.0 / 255.0)
    v = blocks * (np.float32(1.0) / scales)[:, None, :]
    v += np.float32(0.5)
    np.floor(v, out=v)
    q1 = _canonical_fixup(blocks, v, scales[:, None, :], np)
    np.clip(q1, 0, 255, out=q1)
    return q1.astype(np.uint8).reshape(r * rb, n)[:m], scales


def quantize_policy_np(x, eps: float, x_quant_rows: int):
    """NumPy twin of :func:`quantize_policy`."""
    if x_quant_rows:
        return quantize_rowblocks_np(x, eps, x_quant_rows)
    return quantize_columns_np(x, eps)
