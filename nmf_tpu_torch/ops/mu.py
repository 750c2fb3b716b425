"""Lee-Seung multiplicative updates (KL divergence) in plain torch ops.

Counterpart of ``nmf_tpu.ops.mu`` and the plain version of the update
kernels K1 and K2 (:mod:`nmf_tpu_torch.ops.kernels.fused_mu`).  The
per-iteration structure is the reference's (nmf.cu:118-176), including the
recomputation of W@H after H's half-update::

    update_h:  Z = X / clamp(W @ H);  H = H * ((W^T @ Z) / clamp(colsum W)[:, None])
    update_w:  Z = X / clamp(W @ H);  W = W * ((Z @ H^T) / clamp(rowsum H)[None, :])

The products go to ``torch.matmul``, as the JAX package leaves them to XLA.
On the card they are true f32 (see :mod:`nmf_tpu_torch.utils.config`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.config import Precision
from .elementwise import EPS, eps_clamp

__all__ = ["matmul", "update_h", "update_w", "mu_step"]

_F32 = torch.float32


def _require_f32(precision: Precision) -> None:
    if not precision.all_f32:
        raise NotImplementedError(
            f"{precision} is not in the PyTorch port yet: only the all-float32 "
            "policy is (the bf16, int8 and float32_fast tiers are queued in "
            "ROADMAP.md)"
        )


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    precision: Precision = Precision(),
    transpose_a: bool = False,
    transpose_b: bool = False,
) -> torch.Tensor:
    """f32 matmul with optional transposes (the reference's three cuBLAS
    wrappers N/N, T/N, N/T, matrix.cu:97-125)."""
    _require_f32(precision)
    a = a.t() if transpose_a else a
    b = b.t() if transpose_b else b
    return torch.matmul(a.to(_F32), b.to(_F32))


def _recon_ratio(w, h, x, eps, precision):
    """Z = X / clamp(W@H, eps): nmf.cu:125-131 / 155-161."""
    return x / eps_clamp(matmul(w, h, precision), eps)


def update_h(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> torch.Tensor:
    """H half-update (nmf.cu:118-146). Returns the new H."""
    z = _recon_ratio(w, h, x, eps, precision)
    sum_w = eps_clamp(torch.sum(w, dim=0, dtype=_F32), eps)          # (K,)
    wtz = matmul(w, z, precision, transpose_a=True)                   # (K, N)
    return (h * (wtz / sum_w[:, None])).to(h.dtype)


def update_w(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> torch.Tensor:
    """W half-update (nmf.cu:148-176). Returns the new W."""
    z = _recon_ratio(w, h, x, eps, precision)
    sum_h = eps_clamp(torch.sum(h, dim=1, dtype=_F32), eps)          # (K,)
    zht = matmul(z, h, precision, transpose_b=True)                   # (M, K)
    return (w * (zht / sum_h[None, :])).to(w.dtype)


def mu_step(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full MU iteration: H half-update, then W half-update with the
    new H (one reference graph replay, nmf.cu:108-109)."""
    h = update_h(w, h, x, eps, precision)
    w = update_w(w, h, x, eps, precision)
    return w, h
