"""Divergences (costs) of NMF, counterpart of ``nmf_tpu.ops.divergence``.

Formula of the reference's ``reduce1d_div`` (cuda/matrix.cu:592)::

    D(X || Y) = sum( x * (log(x) - log(y)) - x + y ),   y = clamp(W @ H, eps)

:func:`kl_divergence` is the plain version of the cost kernel K3 under both
f32 policies (under ``bfloat16`` K3 takes bf16-rounded recon inputs:
``ops.kernels.fused_mu.kl_cost_plain``).  The Euclidean, Itakura-Saito and
general beta-divergence costs (beta = 2, 0, any) have no kernel in either
package.  :func:`beta_partial` is the cost of one streamed column block of
the beta and HALS families (``nmf_tpu/parallel/sharded.py:411``): its
Euclidean term takes the clamped recon, unlike :func:`euclidean_cost`.  X may be f32 or bf16; it is widened to f32, and the recon is true
f32 whatever the state dtype.  The clamps are JAX's, site for site.
"""

from __future__ import annotations

import torch

from .elementwise import EPS, eps_clamp

__all__ = [
    "kl_divergence",
    "kl_divergence_from_recon",
    "euclidean_cost",
    "itakura_saito",
    "beta_divergence",
    "beta_partial",
]

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


def euclidean_cost(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """0.5 * ||X - W@H||_F^2 (the beta = 2 member of the family)."""
    d = x.to(_F32) - _recon(w, h)
    return 0.5 * torch.sum(d * d)


def itakura_saito(
    x: torch.Tensor, w: torch.Tensor, h: torch.Tensor, eps: float = EPS
) -> torch.Tensor:
    """Itakura-Saito divergence sum(x/y - log(x/y) - 1) (beta = 0); X is
    clamped as well as Y (``divergence.py:78-79`` of the JAX package)."""
    y = eps_clamp(_recon(w, h), eps)
    r = eps_clamp(x.to(_F32), eps) / y
    return torch.sum(r - torch.log(r) - 1.0)


def beta_divergence(
    x: torch.Tensor, w: torch.Tensor, h: torch.Tensor, beta: float, eps: float = EPS
) -> torch.Tensor:
    """General beta-divergence D_beta(X || W@H): beta = 2 Euclidean, 1 the
    generalized KL, 0 Itakura-Saito.  ``beta`` is a Python float that picks
    the formula, as in JAX; the general term clamps both X and Y."""
    if beta == 2.0:
        return euclidean_cost(x, w, h)
    if beta == 1.0:
        return kl_divergence(x, w, h, eps)
    if beta == 0.0:
        return itakura_saito(x, w, h, eps)
    xf = eps_clamp(x.to(_F32), eps)
    y = eps_clamp(_recon(w, h), eps)
    b = float(beta)
    term = (xf ** b + (b - 1.0) * y ** b - b * xf * y ** (b - 1.0)) / (b * (b - 1.0))
    return torch.sum(term)


def beta_partial(
    x: torch.Tensor, w: torch.Tensor, h: torch.Tensor, beta: float, eps: float = EPS
) -> torch.Tensor:
    """One block's beta-divergence partial sum (elementwise in (x, y)), the
    streamed beta and HALS families' block cost: ``y = clamp(W @ H)`` in
    true f32, then the term of :func:`beta_divergence` for ``beta``, the
    Euclidean one on the clamped ``y`` (``sharded.py:411-427`` of the JAX
    package)."""
    b = float(beta)
    if b == 1.0:
        return kl_divergence(x, w, h, eps)
    y = eps_clamp(_recon(w, h), eps)
    xf = x.to(_F32)
    if b == 2.0:
        d = xf - y
        return 0.5 * torch.sum(d * d)
    if b == 0.0:
        r = eps_clamp(xf, eps) / y
        return torch.sum(r - torch.log(r) - 1.0)
    xc = eps_clamp(xf, eps)
    return torch.sum((xc ** b + (b - 1.0) * y ** b - b * xc * y ** (b - 1.0)) / (b * (b - 1.0)))
