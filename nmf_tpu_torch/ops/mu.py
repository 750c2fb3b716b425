"""Lee-Seung multiplicative updates (KL divergence) in plain torch ops.

Counterpart of ``nmf_tpu.ops.mu`` and the plain version of the update
kernels K1 and K2 (:mod:`nmf_tpu_torch.ops.kernels.fused_mu`).  The
per-iteration structure is the reference's (nmf.cu:118-176), including the
recomputation of W@H after H's half-update::

    update_h:  Z = X / clamp(W @ H);  H = H * ((W^T @ Z) / clamp(colsum W)[:, None])
    update_w:  Z = X / clamp(W @ H);  W = W * ((Z @ H^T) / clamp(rowsum H)[None, :])

The products go to ``torch.matmul`` in f32, as the JAX package leaves them
to XLA, with each precision policy spelled out on the operands (never
through ``torch.set_float32_matmul_precision``, which on CUDA means TF32):

* ``float32``: true f32 (TF32 is off on the card, see
  :mod:`nmf_tpu_torch.utils.config`);
* ``bfloat16``: each operand rounded to bf16 (nearest even), the product
  of two bf16 values exact in f32, summed in f32 with an f32 result, as
  ``dot_general(..., preferred_element_type=f32)`` (``nmf_tpu/ops/mu.py:71-77``);
  ``torch.matmul`` on bf16 tensors would round the sum to bf16;
* ``float32_fast``: the explicit 3-pass split ``hi@bh + hi@bl + lo@bh`` on
  bf16-exact f32 values (``nmf_tpu/ops/pallas/fused_mu.py:215-237``).

Z is an operand of the second product, so it is rounded (or split) like W
and H, as both JAX paths do.

The beta-divergence MU (:func:`mu_step_beta`) and the penalized KL MU
(:func:`mu_step_kl_reg`) have no kernel in either package: JAX sends them to
plain ops on every platform (``nmf_tpu/models/solver.py:113-127``), and so
does the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.config import Precision
from .elementwise import EPS, eps_clamp

__all__ = [
    "matmul", "numerator_h", "numerator_w", "update_h", "update_w", "mu_step",
    "mu_step_beta", "mu_step_kl_reg",
]

_F32 = torch.float32


def _bf16_exact(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bf16 (nearest even), held in f32."""
    return a.to(torch.bfloat16).to(_F32)


def _split3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = bf16(a), lo = bf16(a - hi), both in f32."""
    a = a.to(_F32)
    hi = _bf16_exact(a)
    return hi, _bf16_exact(a - hi)


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    precision: Precision = Precision(),
    transpose_a: bool = False,
    transpose_b: bool = False,
) -> torch.Tensor:
    """Matmul under ``precision`` with an f32 result and optional transposes
    (the reference's three cuBLAS wrappers N/N, T/N, N/T, matrix.cu:97-125);
    on ``[B, ...]`` stacks, one batched product a member."""
    a = a.transpose(-2, -1) if transpose_a else a
    b = b.transpose(-2, -1) if transpose_b else b
    if precision.matmul_dtype == "float32_fast":
        (ah, al), (bh, bl) = _split3(a), _split3(b)
        return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)
    if precision.matmul_dtype == "bfloat16":
        return torch.matmul(_bf16_exact(a), _bf16_exact(b))
    return torch.matmul(a.to(_F32), b.to(_F32))


def _recon_ratio(w, h, x, eps, precision):
    """Z = X / clamp(W@H, eps): nmf.cu:125-131 / 155-161."""
    return x / eps_clamp(matmul(w, h, precision), eps)


def numerator_h(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> torch.Tensor:
    """H's numerator ``W^T (X / clamp(W@H))``, (K, N) f32: the plain version
    of K1's ``numerator_only`` mode (``nmf_tpu/ops/pallas/fused_mu.py:310-312``)."""
    return matmul(w, _recon_ratio(w, h, x, eps, precision), precision, transpose_a=True)


def numerator_w(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> torch.Tensor:
    """W's numerator ``(X / clamp(W@H)) H^T``, (M, K) f32: the plain version
    of K2's ``numerator_only`` mode (``fused_mu.py:436-438``)."""
    return matmul(_recon_ratio(w, h, x, eps, precision), h, precision, transpose_b=True)


def update_h(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> torch.Tensor:
    """H half-update (nmf.cu:118-146). Returns the new H.  Also on a member
    axis (W ``[B, M, K]``, H ``[B, K, N]``, X per member or shared)."""
    sum_w = eps_clamp(torch.sum(w, dim=-2, dtype=_F32), eps)         # (K,)
    wtz = numerator_h(w, h, x, eps, precision)                        # (K, N)
    return (h * (wtz / sum_w[..., :, None])).to(h.dtype)


def update_w(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> torch.Tensor:
    """W half-update (nmf.cu:148-176). Returns the new W (also on a member
    axis, as :func:`update_h`)."""
    sum_h = eps_clamp(torch.sum(h, dim=-1, dtype=_F32), eps)         # (K,)
    zht = numerator_w(w, h, x, eps, precision)                        # (M, K)
    return (w * (zht / sum_h[..., None, :])).to(w.dtype)


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


def _beta_ratios(w, h, x, beta: float, eps: float, precision: Precision):
    """The beta-MU factors ``(X Y^(b-2), Y^(b-1))``, ``Y = clamp(W@H)``
    (``nmf_tpu/ops/mu.py:140-154``); beta = 0 takes ``x * inv * inv``."""
    y = eps_clamp(matmul(w, h, precision), eps)
    b = float(beta)
    if b == 2.0:
        return x, y
    if b == 1.0:
        return x / y, torch.ones_like(y)
    if b == 0.0:
        inv = 1.0 / y
        return x * inv * inv, inv
    return x * y ** (b - 2.0), y ** (b - 1.0)


def mu_step_beta(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    beta: float,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One beta-divergence MU iteration (Fevotte & Idier 2011)::

        H <- H * (W^T (X Y^(b-2))) / clamp(W^T Y^(b-1)),  Y = clamp(W@H)
        W <- W * ((X Y^(b-2)) H^T) / clamp(Y^(b-1) H^T)   (Y with the new H)

    At beta = 1 the denominators are the clamped column and row sums, as
    in JAX (``mu.py:176-186``).
    """
    num, den = _beta_ratios(w, h, x, beta, eps, precision)
    h_num = matmul(w, num, precision, transpose_a=True)
    if beta == 1.0:
        h_den = eps_clamp(torch.sum(w, dim=0, dtype=_F32), eps)[:, None]
    else:
        h_den = eps_clamp(matmul(w, den, precision, transpose_a=True), eps)
    h = (h * (h_num / h_den)).to(h.dtype)

    num, den = _beta_ratios(w, h, x, beta, eps, precision)
    w_num = matmul(num, h, precision, transpose_b=True)
    if beta == 1.0:
        w_den = eps_clamp(torch.sum(h, dim=1, dtype=_F32), eps)[None, :]
    else:
        w_den = eps_clamp(matmul(den, h, precision, transpose_b=True), eps)
    w = (w * (w_num / w_den)).to(w.dtype)
    return w, h


def update_h_kl_reg(w, h, x, eps: float, precision: Precision, l1_h: float, l2_h: float):
    """H's penalized KL half-update: the penalty gradient joins the
    denominator, ``H * (W^T Z) / (colsum(W)[:, None] + l1_h + l2_h H)``."""
    sum_w = eps_clamp(torch.sum(w, dim=0, dtype=_F32), eps)
    numer = matmul(w, _recon_ratio(w, h, x, eps, precision), precision, transpose_a=True)
    denom = sum_w[:, None] + l1_h + l2_h * h.to(_F32)
    return (h * (numer / denom)).to(h.dtype)


def mu_step_kl_reg(
    w: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
    l1_w: float = 0.0,
    l1_h: float = 0.0,
    l2_w: float = 0.0,
    l2_h: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL MU iteration with L1/L2 factor penalties in the denominators::

        H <- H * (W^T Z) / (colsum(W)[:, None] + l1_h + l2_h * H)
        W <- W * (Z H^T) / (rowsum(H)[None, :] + l1_w + l2_w * W)

    Zero penalties give :func:`mu_step`'s values.
    """
    h = update_h_kl_reg(w, h, x, eps, precision, l1_h, l2_h)
    sum_h = eps_clamp(torch.sum(h, dim=1, dtype=_F32), eps)
    numer = matmul(_recon_ratio(w, h, x, eps, precision), h, precision, transpose_b=True)
    denom = sum_h[None, :] + l1_w + l2_w * w.to(_F32)
    w = (w * (numer / denom)).to(w.dtype)
    return w, h
