"""Batched NMF: many independent factorizations in one solve.

Counterpart of ``nmf_tpu.parallel.batched``, where the batched solve is
``jax.vmap`` of the single-problem ``while_loop``.  Here the loop runs once
for all members on stacked state (W ``[B, M, K]``, H ``[B, K, N]``), and
the fused kernels K1-K3 take the member axis themselves
(:mod:`nmf_tpu_torch.ops.kernels.fused_mu`): one K1 and one K2 launch an
iteration and one K3 launch a check serve every member, and member i gives
the bits of the 2-D solve of member i.

The semantics are those of the vmapped ``while_loop``: with ``thresh > 0``
each member stops changing at its own check (a finished member's W and H
are held by ``torch.where`` while the others run on), and ``iterations``,
``num_checks``, ``converged``, ``cost`` and ``cost_history`` come back per
member; one host read of the B relative changes a check decides.  With
``thresh == 0`` nothing is read back until the end, and every member runs
exactly ``max_iter`` iterations.  ``accelerate`` decides acceptance per
member from one read of the B costs a check block; a block any member
rejects is redone plain for all members and kept for the rejecting ones,
as the vmapped ``lax.cond`` selects.

``backend="auto"`` and ``"autotune"`` resolve by the card's rule for a
member axis (:func:`nmf_tpu_torch.utils.autotune.rule_pick` with
``members``; JAX sends every batched solve to ``jnp`` on a TPU,
``batched.py:202-211``): CUDA tensors at small K take cuBLAS's batched
GEMMs, where the member-axis kernels measured slower.  Not in the port
yet: ``mesh`` (ROADMAP.md Queue 1 step 12b).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..models.masked import masked_kl, mu_step_masked
from ..models.solver import (
    _DTYPES,
    _MESH,
    SolveResult,
    _cost_fn,
    _family_step,
    _use_kernels,
    extrapolate,
)
from ..ops.divergence import kl_divergence
from ..ops.kernels import fused_mu
from ..ops.mu import mu_step
from ..ops.quant import dequantize, quantize_policy
from ..utils.autotune import resolve_config
from ..utils.config import SolveConfig
from ..utils.convert import to_tensor
from ..utils.device import resolve_device

__all__ = ["solve_batched", "run_batched_loop", "batched_step_cost"]

_F32 = torch.float32


def _member(x, i: int):
    """Member i of a stacked X as the kernel wrappers take it apart (a
    tensor or a tuple of them, 2-D: shared), of a tuple whose first item
    is such a pair (each item taken apart), or of a list (one operand a
    member)."""
    if isinstance(x, list):
        return x[i]
    if isinstance(x, tuple) and isinstance(x[0], tuple):
        return tuple(_member(a, i) for a in x)
    return fused_mu._member_x(x, i)


def per_member_step(fn):
    """A 2-D step ``fn(w, h, x)`` run member by member on stacks."""

    def step(w, h, x):
        outs = [fn(w[i], h[i], _member(x, i)) for i in range(w.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    return step


def per_member_cost(fn):
    """A 2-D cost ``fn(x, w, h)`` run member by member: ``[B]`` f32."""
    return lambda x, w, h: torch.stack(
        [fn(_member(x, i), w[i], h[i]).to(_F32) for i in range(w.shape[0])])


def _dequant_members(x):
    """Stacked int8 X as f32 values, member by member (2-D codes: shared)."""
    codes, scales = x
    if codes.dim() == 2:
        return dequantize(codes, scales)
    return torch.stack([dequantize(codes[i], scales[i]) for i in range(codes.shape[0])])


def batched_step_cost(config: SolveConfig):
    """(step, cost) of a batched solve on stacked state.

    The KL MU takes the fused kernels over the member axis (their plain
    version member by member on CPU tensors) or, under ``backend="jnp"``,
    the plain ops on the whole stack (batched GEMMs), int8 X dequantized
    each step.  The beta, HALS and penalized families take their plain 2-D
    step and cost member by member, as JAX vmaps them.
    """
    eps, prec = config.eps, config.precision
    quant = prec.x_dtype == "int8"
    fam = _family_step(config)
    cost2d = _cost_fn(config)
    if fam is not None:
        if quant:
            fam = (lambda f: lambda w, h, x: f(w, h, dequantize(*x)))(fam)
        return per_member_step(fam), per_member_cost(cost2d)
    if _use_kernels(config):
        return (functools.partial(fused_mu.mu_step_fused, eps=eps, precision=prec),
                functools.partial(fused_mu.kl_cost_fused, eps=eps, precision=prec))
    step = functools.partial(mu_step, eps=eps, precision=prec)
    if quant:
        step = (lambda f: lambda w, h, x: f(w, h, _dequant_members(x)))(step)
        cost = per_member_cost(lambda x, w, h: kl_divergence(dequantize(*x), w, h, eps))
    else:
        cost = per_member_cost(lambda x, w, h: kl_divergence(x, w, h, eps))
    return step, cost


def _hold(keep: Optional[torch.Tensor], new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` where a member runs on, ``old`` where it has stopped."""
    if keep is None:
        return new
    return torch.where(keep.view(-1, *([1] * (new.dim() - 1))), new, old)


def _result(w, h, iters, cost, hist, checks, done, momentum) -> SolveResult:
    return SolveResult(
        w=w,
        h=h,
        iterations=torch.from_numpy(iters.astype(np.int32)),
        cost=cost,
        cost_history=hist,
        num_checks=torch.from_numpy(checks.astype(np.int32)),
        converged=torch.from_numpy(done.copy()),
        momentum=momentum,
    )


def run_batched_loop(x, w, h, config: SolveConfig, step_fn, cost_fn) -> SolveResult:
    """The check-blocked loop over a member axis: ``jax.vmap`` of
    ``run_checked_loop`` (module docstring).  ``step_fn`` and ``cost_fn``
    take and give stacks (the cost ``[B]`` f32)."""
    if config.accelerate:
        return _run_batched_accel(x, w, h, config, step_fn, cost_fn)
    b, dev = w.shape[0], w.device
    max_iter, check_every = int(config.max_iter), int(config.check_every)
    thresh = float(config.thresh)
    need_cost = config.track_cost or thresh > 0.0
    hist = torch.full((b, max(config.num_checks, 1)), float("nan"), dtype=_F32, device=dev)
    cost = torch.full((b,), float("nan"), dtype=_F32, device=dev)
    active = np.ones(b, bool)
    iters, checks, done = np.zeros(b, np.int64), np.zeros(b, np.int64), np.zeros(b, bool)
    it = chk = 0
    while it < max_iter and active.any():
        chunk = min(check_every, max_iter - it)
        # members that stopped keep their state (the vmapped while_loop's select)
        keep = None if active.all() else torch.from_numpy(active).to(dev)
        w0, h0 = w, h
        for _ in range(chunk):
            w, h = step_fn(w, h, x)
        w, h = _hold(keep, w, w0), _hold(keep, h, h0)
        it += chunk
        iters[active] = it
        if need_cost:
            prev = cost
            cost = _hold(keep, cost_fn(x, w, h).to(_F32), prev)
            hist[:, chk] = _hold(keep, cost, hist[:, chk])
            chk += 1
            checks[active] = chk
            if thresh > 0.0:
                # one host read of the B relative changes, compared in f32
                # as the 2-D loop compares; NaN (a first check) never stops
                stop = (torch.abs(prev - cost) / torch.abs(cost) < thresh).cpu().numpy()
                stop &= active
                done |= stop
                active &= ~stop
    nan = torch.full((b,), float("nan"), dtype=_F32, device=dev)
    return _result(w, h, iters, cost, hist, checks, done, nan)


def _extrapolate_members(new, old, m: np.ndarray, eps: float) -> torch.Tensor:
    """:func:`extrapolate` with member i's momentum ``m[i]``: one pass a
    distinct momentum, each member taking its own, so every member has the
    bits of the 2-D extrapolation."""
    vals = np.unique(m)
    out = extrapolate(new, old, float(vals[0]), eps)
    for v in vals[1:]:
        sel = torch.from_numpy(m == v).to(new.device)
        out = _hold(sel, extrapolate(new, old, float(v), eps), out)
    return out


def _run_batched_accel(x, w, h, config: SolveConfig, step_fn, cost_fn) -> SolveResult:
    """``_run_accel_loop`` over a member axis: per-member momentum, costs
    and accept/reject, decided on the host from one read of the B costs a
    check block (two when a member rejects)."""
    b, dev = w.shape[0], w.device
    max_iter, check_every = int(config.max_iter), int(config.check_every)
    thresh = np.float32(config.thresh)
    eps = config.eps
    m = np.full(b, np.float32(config.accel_momentum), np.float32)
    m_max = np.float32(config.accel_momentum_max)
    grow, shrink = np.float32(config.accel_grow), np.float32(config.accel_shrink)

    def costs(w_, h_):
        return cost_fn(x, w_, h_).to(_F32).cpu().numpy()

    cost = costs(w, h)
    we, he = w, h
    hist = np.full((b, max(config.num_checks, 1)), np.nan, np.float32)
    active = np.ones(b, bool)
    iters, checks, done = np.zeros(b, np.int64), np.zeros(b, np.int64), np.zeros(b, bool)
    it = chk = 0
    while it < max_iter and active.any():
        chunk = min(check_every, max_iter - it)
        w0, h0, we0, he0 = w, h, we, he
        for _ in range(chunk):
            wn, hn = step_fn(we, he, x)
            we, he = _extrapolate_members(wn, w, m, eps), _extrapolate_members(hn, h, m, eps)
            w, h = wn, hn
        c = costs(w, h)
        with np.errstate(invalid="ignore"):
            accept = c <= cost          # NaN rejects
        reject = ~accept & active
        if reject.any():                # redo the block plain; keep it where rejected
            w2, h2 = w0, h0
            for _ in range(chunk):
                w2, h2 = step_fn(w2, h2, x)
            c2 = costs(w2, h2)
            rj = torch.from_numpy(reject).to(dev)
            w, h = _hold(rj, w2, w), _hold(rj, h2, h)
            we, he = _hold(rj, w2, we), _hold(rj, h2, he)
            c = np.where(reject, c2, c)
        m_new = np.where(accept, np.minimum((m * grow).astype(np.float32), m_max),
                         (m * shrink).astype(np.float32)).astype(np.float32)
        if not active.all():
            keep = torch.from_numpy(active).to(dev)
            w, h = _hold(keep, w, w0), _hold(keep, h, h0)
            we, he = _hold(keep, we, we0), _hold(keep, he, he0)
        m = np.where(active, m_new, m).astype(np.float32)
        it += chunk
        prev = cost
        cost = np.where(active, c, cost).astype(np.float32)
        hist[active, chk] = cost[active]
        chk += 1
        iters[active], checks[active] = it, chk
        if thresh > 0:
            with np.errstate(divide="ignore", invalid="ignore"):
                stop = (np.abs(prev - cost) / np.abs(cost) < thresh) & active
            done |= stop
            active &= ~stop
    return _result(w, h, iters, torch.from_numpy(cost).to(dev), torch.from_numpy(hist).to(dev),
                   checks, done, torch.from_numpy(m).to(dev))


def _shape(a):
    return tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))


def _prep_members(x, w0, h0, config: SolveConfig, clamp_inputs: bool, mask, dev):
    """``_batched_prep_jit_cached`` (``nmf_tpu/parallel/batched.py:47-76``):
    clamp and casts, the unobserved entries zeroed, and int8 X quantized
    member by member (codes ``[B, M, N]``, scales ``[B, N]``, or
    ``[B, R, N]`` per row block)."""
    prec, eps = config.precision, float(config.eps)
    sd = _DTYPES[prec.state_dtype]
    fill = torch.full((), eps, dtype=sd, device=dev)
    w0, h0 = (to_tensor(a, dev).to(sd) for a in (w0, h0))
    x = to_tensor(x, dev).to(_F32)
    if clamp_inputs:
        w0, h0 = torch.maximum(w0, fill), torch.maximum(h0, fill)
        x = torch.clamp_min(x, eps)
    if mask is not None:
        # unobserved entries may hold anything (NaN/Inf holes): zeroed for
        # every storage dtype, before the scales see them
        mask = to_tensor(mask, dev).to(_F32).contiguous()
        x = torch.where(mask > 0, x, 0.0)
    if prec.x_dtype == "int8":
        pairs = [quantize_policy(x[i], eps, prec.x_quant_rows) for i in range(x.shape[0])]
        x = tuple(torch.stack([p[j] for p in pairs]).contiguous() for j in range(2))
    else:
        x = x.to(_DTYPES[prec.x_dtype]).contiguous()
    return x, w0.contiguous(), h0.contiguous(), mask


def solve_batched(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    mesh=None,
    clamp_inputs: bool = True,
    mask=None,
    device="cuda",
) -> SolveResult:
    """Solve a batch: x ``[B, M, N]``, w0 ``[B, M, K]``, h0 ``[B, K, N]``
    -> a :class:`SolveResult` with the member axis first
    (``nmf_tpu/parallel/batched.py:121-230``).

    ``mask`` (``[B, M, N]``) runs the masked KL MU per member on plain ops,
    each member seeing only its own ``mask != 0`` entries (unobserved X may
    be NaN or Inf).  ``live_metrics`` is turned off, as in JAX.  The inputs
    go to ``device`` (``"cuda"`` by default; a CUDA request without a card
    raises); ``mesh`` is refused.  Per-member convergence: module docstring.
    """
    config.validate()
    if mesh is not None:
        raise NotImplementedError(_MESH)
    if config.live_metrics:
        # a per-member-per-check stream is noise (nmf_tpu batched.py:80-86)
        config = dataclasses.replace(config, live_metrics=False)
    if isinstance(x, tuple):
        raise ValueError(
            "solve_batched takes the dense [B, M, N] stack and quantizes "
            "each member internally (codes [B,M,N] + per-member scales); "
            "pre-quantized (codes, scales) pairs are accepted by "
            "solve/solve_sharded/solve_h_only"
        )
    if mask is not None and (config.beta != 1.0 or config.algorithm != "mu"):
        raise NotImplementedError("masked solve implements the KL (beta=1) MU family")
    sx, sw, sh = _shape(x), _shape(w0), _shape(h0)
    if len(sx) != 3 or len(sw) != 3 or len(sh) != 3:
        raise ValueError("solve_batched expects 3-D [batch, rows, cols] arrays")
    if not (sx[0] == sw[0] == sh[0]):
        raise ValueError(f"batch sizes disagree: X{sx[0]} W{sw[0]} H{sh[0]}")
    if sx[1:] != (sw[1], sh[2]) or sw[2] != sh[1]:
        raise ValueError(f"shape mismatch: X{sx} vs W{sw} @ H{sh}")
    if mask is not None and _shape(mask) != sx:
        raise ValueError(f"mask shape {_shape(mask)} != X shape {sx}")
    dev = resolve_device(device)
    if mask is None:
        config = resolve_config(config, sw[1], sw[2], sh[2], dev, "batched", members=sw[0])
    x, w0, h0, mask = _prep_members(x, w0, h0, config, clamp_inputs, mask, dev)
    if mask is not None:
        eps, prec = config.eps, config.precision
        pens = dict(l1_w=config.l1_w, l1_h=config.l1_h, l2_w=config.l2_w, l2_h=config.l2_h)
        dense = (lambda a: dequantize(*a)) if isinstance(x, tuple) else (lambda a: a)
        step = per_member_step(
            lambda w, h, xm: mu_step_masked(w, h, dense(xm[0]), xm[1], eps, prec, **pens))
        cost = per_member_cost(
            lambda xm, w, h: masked_kl(dense(xm[0]), w, h, xm[1], eps, **pens))
        return run_batched_loop((x, mask), w0, h0, config, step, cost)
    step, cost = batched_step_cost(config)
    return run_batched_loop(x, w0, h0, config, step, cost)
