"""HALS (hierarchical alternating least squares) for Frobenius NMF.

Counterpart of ``nmf_tpu.ops.hals``: coordinate descent over the rank-1
factors (Cichocki & Phan 2009), beta = 2 only.  An outer iteration takes the
Gram and cross products (W^T W, W^T X, H H^T, X H^T) through
:func:`~nmf_tpu_torch.ops.mu.matmul` under the precision policy, then
refines the K rows of H (or columns of W) one after another.

JAX's ``lax.fori_loop`` over k becomes a Python loop that writes the rows
(columns) of an f32 copy in place, so a sweep is K short steps of a few
elementwise launches each on the card.  Neither package has a kernel for
it.  The dot inside the sweep is true f32 whatever the policy
(``hals.py:40-46`` of the JAX package, its ``_HIGHEST``): a plain f32
``torch.matmul``, which on the card is IEEE f32 because
:func:`~nmf_tpu_torch.utils.device.resolve_device` turns TF32 off.

The sweeps take the products as inputs, so that a sharded or streamed
solver can sum them first and share one sweep definition.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.config import Precision
from .elementwise import eps_clamp
from .mu import matmul

__all__ = ["hals_step", "cd_sweep_h", "cd_sweep_w"]

_F32 = torch.float32


def cd_sweep_h(h: torch.Tensor, wtx: torch.Tensor, wtw: torch.Tensor, eps: float) -> torch.Tensor:
    """Sweep H's rows once by coordinate descent.

    ``wtx`` = W^T X (K x N) and ``wtw`` = W^T W (K x K), f32; each row is
    updated against the current H, the rows already swept included.
    """
    hh = h.to(_F32, copy=True)
    for k in range(hh.shape[0]):
        grad = wtx[k] - torch.matmul(wtw[k], hh)              # (N,)
        hh[k] = torch.clamp_min(hh[k] + grad / eps_clamp(wtw[k, k], eps), 0.0)
    return hh.to(h.dtype)


def cd_sweep_w(w: torch.Tensor, xht: torch.Tensor, hht: torch.Tensor, eps: float) -> torch.Tensor:
    """Sweep W's columns once by coordinate descent.

    ``xht`` = X H^T (M x K) and ``hht`` = H H^T (K x K), f32.
    """
    ww = w.to(_F32, copy=True)
    for k in range(ww.shape[1]):
        grad = xht[:, k] - torch.matmul(ww, hht[:, k])        # (M,)
        ww[:, k] = torch.clamp_min(ww[:, k] + grad / eps_clamp(hht[k, k], eps), 0.0)
    return ww.to(w.dtype)


def _update_h_hals(w, h, x, eps: float, precision: Precision) -> torch.Tensor:
    """H's half of a HALS iteration: its products, then one row sweep."""
    wtx = matmul(w, x, precision, transpose_a=True)     # (K, N)
    wtw = matmul(w, w, precision, transpose_a=True)     # (K, K)
    return cd_sweep_h(h, wtx, wtw, eps)


def _update_w_hals(w, h, x, eps: float, precision: Precision) -> torch.Tensor:
    """W's half of a HALS iteration: its products, then one column sweep."""
    xht = matmul(x, h, precision, transpose_b=True)     # (M, K)
    hht = matmul(h, h, precision, transpose_b=True)     # (K, K)
    return cd_sweep_w(w, xht, hht, eps)


def hals_step(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float,
    precision: Precision = Precision(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One HALS outer iteration: sweep H's rows, then W's columns."""
    h = _update_h_hals(w, h, x, eps, precision)
    w = _update_w_hals(w, h, x, eps, precision)
    return w, h
