"""Masked (missing-data) NMF: factorize only the observed entries of X.

Counterpart of ``nmf_tpu.models.masked``: the weighted KL multiplicative
updates (Zhang et al. 2006 / Ho 2008), where a binary or real-valued weight
matrix ``M`` selects or weights the observations::

    H <- H * (W^T (M .* X ./ clamp(W@H))) / clamp(W^T M)
    W <- W * ((M .* X ./ clamp(W@H)) H^T) / clamp(M H^T)

With ``M = 1`` everywhere these are the reference updates.  Plain torch ops
on every device, as JAX takes its jnp path (``masked.py:14-15``): neither
package has a kernel for the mask GEMMs.  L1/L2 penalties join the
denominators after their clamp, as in ``mu_step_kl_reg``.

Unobserved entries may hold anything, NaN and Inf included: the prep zeroes
them before anything else reads X.  ``mesh=`` runs both solves sharded
(:mod:`nmf_tpu_torch.parallel.sharded`), the mask split like X.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.elementwise import EPS, eps_clamp
from ..ops.mu import matmul
from ..ops.quant import dequantize, quantize_policy
from ..utils.config import Precision, SolveConfig
from ..utils.convert import to_tensor
from ..utils.device import resolve_device
from .solver import (
    _DTYPES,
    SolveResult,
    _shape,
    run_checked_loop,
    to_state,
)

__all__ = ["mu_step_masked", "masked_kl", "solve_masked", "solve_masked_h_only"]

_F32 = torch.float32


def _masked_ratio(w, h, x, mask, eps, precision):
    """``M .* X ./ clamp(W H)``, the ratio both halves of the update take."""
    return mask * (x / eps_clamp(matmul(w, h, precision), eps))


def masked_update_h(w, h, x, mask, eps, precision, l1_h=0.0, l2_h=0.0):
    """H's masked half-update (the first half of :func:`mu_step_masked`);
    the streamed masked family takes it a block."""
    z = _masked_ratio(w, h, x, mask, eps, precision)
    numer = matmul(w, z, precision, transpose_a=True)
    denom = eps_clamp(matmul(w, mask, precision, transpose_a=True), eps) + l1_h + l2_h * h.to(_F32)
    return (h * (numer / denom)).to(h.dtype)


def masked_w_terms(w, h, x, mask, eps, precision):
    """The two W-side GEMMs of the masked update at the new H:
    ``(M .* X ./ clamp(W H)) H^T`` and ``M H^T``, both (M, K).  The W half
    of :func:`mu_step_masked`; the streamed masked family sums them over
    blocks."""
    z = _masked_ratio(w, h, x, mask, eps, precision)
    return (matmul(z, h, precision, transpose_b=True),
            matmul(mask, h, precision, transpose_b=True))


def mu_step_masked(
    w, h, x, mask, eps: float = EPS, precision: Precision = Precision(),
    l1_w: float = 0.0, l1_h: float = 0.0, l2_w: float = 0.0, l2_h: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One masked MU iteration: H's half, then W's with the new H."""
    h = masked_update_h(w, h, x, mask, eps, precision, l1_h, l2_h)
    numer, mh = masked_w_terms(w, h, x, mask, eps, precision)
    denom = eps_clamp(mh, eps) + l1_w + l2_w * w.to(_F32)
    w = (w * (numer / denom)).to(w.dtype)
    return w, h


def masked_kl(
    x, w, h, mask, eps: float = EPS,
    l1_w: float = 0.0, l1_h: float = 0.0, l2_w: float = 0.0, l2_h: float = 0.0,
) -> torch.Tensor:
    """The KL divergence over the observed entries (weighted by the mask),
    with a true-f32 recon, plus the optional penalties; a 0-dim f32 tensor."""
    y = eps_clamp(matmul(w, h, Precision()), eps)
    xf = x.to(_F32)
    # the x -> 0 limit of x log(x/y) is 0, as in kl_divergence
    xlog = torch.where(xf > 0, xf * (torch.log(xf) - torch.log(y)), 0.0)
    total = torch.sum(mask * (xlog - xf + y))
    if l1_w or l1_h or l2_w or l2_h:
        wf, hf = w.to(_F32), h.to(_F32)
        total = total + (
            l1_w * torch.sum(torch.abs(wf)) + l1_h * torch.sum(torch.abs(hf))
            + 0.5 * l2_w * torch.sum(wf * wf) + 0.5 * l2_h * torch.sum(hf * hf)
        )
    return total


def _dense(x):
    return dequantize(*x) if isinstance(x, tuple) else x


def _masked_prep(x, w0, h0, mask, config: SolveConfig, dev: torch.device):
    """The masked load-time prep (``_masked_prep_jit_cached`` of the JAX
    package), in its order: W and H cast to the state dtype and clamped
    there; X clamped in f32; the unobserved entries of X zeroed before
    anything else reads it (0 * NaN would be NaN); X cast or quantized.  A
    ``(codes, scales)`` pair is X so prepped already (the mesh's prep
    quantizes on the host)."""
    prec, eps = config.precision, float(config.eps)
    w, h = (to_state(a, config, dev) for a in (w0, h0))
    mask = to_tensor(mask, dev).to(_F32)
    if isinstance(x, tuple):
        return tuple(to_tensor(a, dev) for a in x), w, h, mask.contiguous()
    x = torch.clamp_min(to_tensor(x, dev).to(_F32), eps)
    x = torch.where(mask > 0, x, 0.0)
    if prec.x_dtype == "int8":
        x = tuple(t.contiguous() for t in quantize_policy(x, eps, prec.x_quant_rows))
    else:
        x = x.to(_DTYPES[prec.x_dtype]).contiguous()
    return x, w, h, mask.contiguous()


def _validate_and_prep(x, w0, h0, mask, config: SolveConfig, mesh, device):
    """The checks of ``_masked_validate_and_prep``, then the prep on
    ``device``, or of this rank's blocks on a mesh (None beyond it)."""
    config.validate()
    if config.beta != 1.0 or config.algorithm != "mu":
        raise NotImplementedError("masked solve implements the KL (beta=1) MU family")
    sx, sw, sh = _shape(x), _shape(w0), _shape(h0)
    if _shape(mask) != sx:
        raise ValueError(f"mask shape {_shape(mask)} != X shape {sx}")
    if sx != (sw[0], sh[1]) or sw[1] != sh[0]:
        raise ValueError(f"shape mismatch: X{sx} vs W{sw} @ H{sh}")
    if mesh is not None:
        from ..parallel.mesh import check_mesh, mesh_coordinate

        if mesh_coordinate(check_mesh(mesh)) is None:
            return None
        from ..parallel.sharded import _local_problem

        return _local_problem(x, w0, h0, config, True, mesh, mask=mask)
    return _masked_prep(x, w0, h0, mask, config, resolve_device(device))


def masked_h_step_cost(config: SolveConfig):
    """(step, cost) of the masked H-only loop over a packed ``(x, mask)``
    data operand, X dense or a ``(codes, scales)`` pair: the H half of
    :func:`mu_step_masked` and :func:`masked_kl` with the H penalties only.
    The in-memory and the streamed masked transforms share them."""
    eps, prec = config.eps, config.precision
    l1_h, l2_h = config.l1_h, config.l2_h

    def step(w, h, xm):
        x, mask = xm
        return w, masked_update_h(w, h, _dense(x), mask, eps, prec, l1_h, l2_h)

    def cost(xm, w, h):
        x, mask = xm
        return masked_kl(_dense(x), w, h, mask, eps, l1_h=l1_h, l2_h=l2_h)

    return step, cost


def solve_masked_h_only(
    x, w, h0, mask, config: SolveConfig = SolveConfig(), mesh=None, device="cuda"
) -> SolveResult:
    """Iterate the H half of the masked update with W fixed: score partially
    observed new columns against a learned dictionary (``mask`` 0 =
    missing, or real-valued weights).  The loop of
    :func:`~nmf_tpu_torch.solve_h_only`; the H penalties compose.  With
    ``mesh`` each rank gets its blocks (the mask split like X)."""
    prepped = _validate_and_prep(x, w, h0, mask, config, mesh, device)
    if mesh is not None:
        from ..parallel.sharded import build_sharded_masked_h_solver

        if prepped is None:
            return None
        x, w, h0, mask = prepped
        return build_sharded_masked_h_solver(config, mesh)((x, mask), w, h0)
    x, w, h0, mask = prepped
    step, cost = masked_h_step_cost(config)
    return run_checked_loop((x, mask), w, h0, config, step, cost)


def solve_masked(
    x, w0, h0, mask, config: SolveConfig = SolveConfig(), mesh=None, device="cuda"
) -> SolveResult:
    """Factorize the observed entries of ``x`` (mask 1 = observed, 0 =
    missing, or real-valued confidence weights in [0, inf)).

    Unobserved entries are ignored entirely, NaN and Inf included.  Every
    precision policy; the loop of :func:`~nmf_tpu_torch.solve` (plain or
    accelerated); ``device`` as there.  With ``mesh`` the solve runs
    sharded, the mask split like X, and each rank gets its blocks
    (:mod:`nmf_tpu_torch.parallel.sharded`).
    """
    prepped = _validate_and_prep(x, w0, h0, mask, config, mesh, device)
    if mesh is not None:
        from ..parallel.sharded import build_sharded_masked_solver

        if prepped is None:
            return None
        x, w0, h0, mask = prepped
        return build_sharded_masked_solver(config, mesh)(x, w0, h0, mask)
    x, w0, h0, mask = prepped
    eps, prec = config.eps, config.precision
    pens = dict(l1_w=config.l1_w, l1_h=config.l1_h, l2_w=config.l2_w, l2_h=config.l2_h)

    def step(w, h, xx):
        return mu_step_masked(w, h, _dense(xx), mask, eps, prec, **pens)

    def cost(xx, w, h):
        return masked_kl(_dense(xx), w, h, mask, eps, **pens)

    return run_checked_loop(x, w0, h0, config, step, cost)
