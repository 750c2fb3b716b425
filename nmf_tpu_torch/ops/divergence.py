"""The KL divergence, counterpart of ``nmf_tpu.ops.divergence`` (KL only).

Formula of the reference's ``reduce1d_div`` (cuda/matrix.cu:592)::

    D(X || Y) = sum( x * (log(x) - log(y)) - x + y ),   y = clamp(W @ H, eps)

:func:`kl_divergence` is the plain version of the cost kernel K3 under both
f32 policies (under ``bfloat16`` K3 takes bf16-rounded recon inputs:
``ops.kernels.fused_mu.kl_cost_plain``).  X may be f32 or bf16; it is
widened to f32, and the recon is true f32 whatever the state dtype.  The
Euclidean, Itakura-Saito and general beta costs are not ported yet.
"""

from __future__ import annotations

import torch

from .elementwise import EPS, eps_clamp

__all__ = ["kl_divergence", "kl_divergence_from_recon"]

_F32 = torch.float32


def _recon(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """W@H in true f32 whatever the update policy: the cost must not drift
    (``divergence.py:39-45`` of the JAX package; TF32 is off on the card)."""
    return torch.matmul(w.to(_F32), h.to(_F32))


def kl_divergence_from_recon(
    x: torch.Tensor, y: torch.Tensor, eps: float = EPS
) -> torch.Tensor:
    """Generalized KL divergence given a reconstruction ``y``.

    Genuine ``x == 0`` entries take the x->0 limit of x*log(x/y) (zero, not
    NaN) and still add their ``+y``.
    """
    x = x.to(_F32)
    y = eps_clamp(y.to(_F32), eps)
    xlog = torch.where(x > 0, x * (torch.log(x) - torch.log(y)), 0.0)
    return torch.sum(xlog - x + y)


def kl_divergence(
    x: torch.Tensor, w: torch.Tensor, h: torch.Tensor, eps: float = EPS
) -> torch.Tensor:
    """Generalized KL divergence D(X || W@H), a 0-dim f32 tensor."""
    return kl_divergence_from_recon(x, _recon(w, h), eps)
