"""The NMF solve loop: check-blocked, with no host sync when ``thresh == 0``.

Counterpart of ``nmf_tpu.models.solver`` (plain loop only).  The JAX package
builds one ``jit(lax.while_loop)``; PyTorch runs eagerly, so the loop is a
Python loop that enqueues kernels on the current stream and keeps every
device value on the device:

* ``chunk = min(check_every, max_iter - it)`` steps per check block;
* the cost is taken at the end of each block into a device-side history
  of ``ceil(max_iter / check_every)`` f32 slots (unused ones NaN);
* with ``thresh == 0`` nothing is read back until the run ends, so exactly
  ``max_iter`` iterations run (nmf.cu:11); with ``thresh > 0`` one scalar
  is read per check to decide whether to stop.

Every precision policy runs: the state in f32 or bf16, X as f32, bf16 or
uint8 codes with scales (quantized at load, or passed in as a pair).

Not in the port yet, and refused with ``NotImplementedError``:
``accelerate``, ``live_metrics``, ``beta != 1``, ``algorithm="hals"``,
penalties, and ``backend="autotune"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.divergence import kl_divergence
from ..ops.kernels import fused_mu
from ..ops.mu import mu_step
from ..ops.quant import dequantize, quantize_policy
from ..utils.config import SolveConfig
from ..utils.convert import to_tensor
from ..utils.device import resolve_device

__all__ = ["SolveResult", "solve", "resolve_step_fn", "run_checked_loop"]

_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

StepFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
CostFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class SolveResult:
    """Factorization result, the fields of ``nmf_tpu``'s ``SolveResult``.

    ``w``, ``h``, ``cost`` and ``cost_history`` stay on the solve's device;
    ``iterations``, ``num_checks`` and ``converged`` are known on the host
    and are CPU tensors.  ``momentum`` is NaN: the accelerated loop is not
    ported yet.
    """

    w: torch.Tensor
    h: torch.Tensor
    iterations: torch.Tensor     # i32 scalar: MU iterations actually run
    cost: torch.Tensor           # f32 scalar: final divergence (NaN if none)
    cost_history: torch.Tensor   # f32 [num_check_slots]
    num_checks: torch.Tensor     # i32 scalar: populated history entries
    converged: torch.Tensor      # bool scalar: stopped via threshold
    momentum: torch.Tensor = None


def _refuse_unported(config: SolveConfig) -> None:
    later = {
        "accelerate=True": config.accelerate,
        "live_metrics=True": config.live_metrics,
        f"beta={config.beta}": config.beta != 1.0,
        f"algorithm={config.algorithm!r}": config.algorithm != "mu",
        "L1/L2 penalties": config.regularized,
        "backend='autotune'": config.backend == "autotune",
    }
    missing = [name for name, on in later.items() if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)} not in the PyTorch port yet (see "
            "ROADMAP.md: accel loop, model families)"
        )


def _use_kernels(config: SolveConfig) -> bool:
    """Whether the step and cost go to the fused kernels.

    ``"jnp"`` means plain torch ops.  Per-row-block int8 scales are not in
    the kernels: ``"pallas"`` raises, ``"auto"`` takes the plain ops on
    dequantized X (``nmf_tpu/models/solver.py:137-151``).  The JAX rule that
    ``auto`` sends int8 X to jnp is a TPU rule (Mosaic's slow uint8 path)
    and is not carried over: per-column int8 X goes to the kernels here.
    """
    if config.backend == "jnp":
        return False
    if config.precision.x_dtype == "int8" and config.precision.x_quant_rows:
        if config.backend == "pallas":
            raise NotImplementedError(
                "per-row-block int8 scales take the jnp path (the fused "
                "kernels' scales operand is per-column); drop "
                "backend='pallas' or x_quant_rows"
            )
        return False
    return True


def resolve_step_fn(config: SolveConfig) -> StepFn:
    """The per-iteration update for this config.

    The fused kernels (which take their plain version for CPU tensors and
    dequantize int8 X themselves) or plain torch ops, by
    :func:`_use_kernels`.
    """
    config.validate()
    _refuse_unported(config)
    eps, prec = config.eps, config.precision
    if _use_kernels(config):
        return functools.partial(fused_mu.mu_step_fused, eps=eps, precision=prec)
    fn = functools.partial(mu_step, eps=eps, precision=prec)
    if prec.x_dtype == "int8":   # the plain ops on dequantized (codes, scales)
        return lambda w, h, x: fn(w, h, dequantize(*x))
    return fn


def _cost_fn(config: SolveConfig) -> CostFn:
    if _use_kernels(config):
        return functools.partial(
            fused_mu.kl_cost_fused, eps=config.eps, precision=config.precision
        )
    fn = functools.partial(kl_divergence, eps=config.eps)
    if config.precision.x_dtype == "int8":
        return lambda x, w, h: fn(dequantize(*x), w, h)
    return fn


def run_checked_loop(
    x: torch.Tensor,
    w: torch.Tensor,
    h: torch.Tensor,
    config: SolveConfig,
    step_fn: StepFn,
    cost_fn: CostFn,
    initial_cost: Optional[float] = None,
) -> SolveResult:
    """The check-blocked loop (``solver.py:402-498`` of the JAX package).

    ``initial_cost`` seeds the convergence baseline (None/NaN: the first
    check never converges).
    """
    max_iter = int(config.max_iter)
    check_every = int(config.check_every)
    thresh = float(config.thresh)
    # with thresh == 0 and no tracking the cost GEMM is skipped entirely
    need_cost = config.track_cost or thresh > 0.0
    n_slots = max(config.num_checks, 1)
    dev = w.device
    hist = torch.full((n_slots,), float("nan"), dtype=_F32, device=dev)
    c0 = float("nan") if initial_cost is None else float(initial_cost)
    cost = torch.full((), c0, dtype=_F32, device=dev)
    it, chk, done = 0, 0, False
    while it < max_iter and not done:
        chunk = min(check_every, max_iter - it)
        for _ in range(chunk):
            w, h = step_fn(w, h, x)
        it += chunk
        if need_cost:
            prev = cost
            cost = cost_fn(x, w, h).to(_F32)
            hist[chk] = cost          # device-to-device copy, no sync
            if thresh > 0.0:
                # the one host read per check, compared in f32 as the JAX
                # loop compares; NaN (the first check) never stops
                rel = torch.abs(prev - cost) / torch.abs(cost)
                done = bool(rel < thresh)
            chk += 1
    return SolveResult(
        w=w,
        h=h,
        iterations=torch.tensor(it, dtype=torch.int32),
        cost=cost,
        cost_history=hist,
        num_checks=torch.tensor(chk, dtype=torch.int32),
        converged=torch.tensor(done, dtype=torch.bool),
        momentum=torch.full((), float("nan"), dtype=_F32, device=dev),
    )


def _shape(a) -> Tuple[int, ...]:
    return tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))


def solve(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    clamp_inputs: bool = True,
    initial_cost: float = float("nan"),
    device="cuda",
) -> SolveResult:
    """Factorize ``x ~= w @ h`` (the reference's ``run_async``, nmf.cu:76-116).

    ``x``, ``w0`` and ``h0`` are NumPy arrays or tensors, ``x`` also a
    pre-quantized ``(codes, scales)`` pair under ``x_dtype="int8"``; they are
    copied to ``device`` (``"cuda"`` by default; a CUDA request without a
    card raises).  The load-time prep is ``_prep_jit_cached``'s
    (``nmf_tpu/models/solver.py:688-709``): with ``clamp_inputs`` (the
    reference's ``set_epsilon``, nmf.cu:211) W and H are cast to the state
    dtype and clamped there, X is clamped in f32 and then cast to
    ``x_dtype`` or quantized; without it they are cast or quantized
    directly.  A pair passes through untouched.  The prep writes fresh
    tensors, so the caller's arrays are never modified.
    """
    config.validate()
    quant = config.precision.x_dtype == "int8"
    if isinstance(x, tuple) and not quant:
        raise ValueError(
            "X is a pre-quantized (codes, scales) pair but "
            f"Precision(x_dtype={config.precision.x_dtype!r}) — pre-quantized "
            "input requires x_dtype='int8' (quantize with "
            "ops.quant.quantize_policy on the same Precision)"
        )
    if isinstance(x, tuple):
        want = 2 if config.precision.x_quant_rows else 1
        if np.ndim(x[1]) != want:
            raise ValueError(
                f"pre-quantized scales are {np.ndim(x[1])}-D but "
                f"Precision(x_quant_rows={config.precision.x_quant_rows}) "
                f"expects {want}-D — quantize with ops.quant.quantize_policy "
                f"on the same Precision"
            )
    shape_x = _shape(x[0]) if isinstance(x, tuple) else _shape(x)
    shape_w, shape_h = _shape(w0), _shape(h0)
    if shape_x != (shape_w[0], shape_h[1]) or shape_w[1] != shape_h[0]:
        raise ValueError(
            f"shape mismatch: X{shape_x} vs W{shape_w} @ H{shape_h}"
        )
    step_fn = resolve_step_fn(config)
    cost_fn = _cost_fn(config)
    dev = resolve_device(device)
    x, w0, h0 = _prep(x, w0, h0, config, clamp_inputs, dev)
    c0 = None if np.isnan(initial_cost) else initial_cost
    return run_checked_loop(x, w0, h0, config, step_fn, cost_fn, c0)


def to_state(a, config: SolveConfig, dev: torch.device, clamp: bool = True) -> torch.Tensor:
    """A factor as a row-major tensor on ``dev`` in the state dtype, clamped
    there (``max(w.astype(sd), sd(eps))``, the reference's load-time clamp)."""
    sd = _DTYPES[config.precision.state_dtype]
    a = to_tensor(a, dev).to(sd)
    if clamp:
        a = torch.maximum(a, torch.full((), float(config.eps), dtype=sd, device=dev))
    return a.contiguous()


def _prep(x, w0, h0, config: SolveConfig, clamp_inputs: bool, dev: torch.device):
    """The load-time clamp, casts and quantization, as row-major tensors on
    ``dev``."""
    prec, eps = config.precision, float(config.eps)
    w0, h0 = (to_state(a, config, dev, clamp_inputs) for a in (w0, h0))
    if isinstance(x, tuple):   # clamped when it was quantized
        return tuple(to_tensor(a, dev) for a in x), w0, h0
    x = to_tensor(x, dev).to(_F32)
    if clamp_inputs:
        x = torch.clamp_min(x, eps)
    if prec.x_dtype == "int8":
        x = quantize_policy(x, eps, prec.x_quant_rows)
        return tuple(t.contiguous() for t in x), w0, h0
    return x.to(_DTYPES[prec.x_dtype]).contiguous(), w0, h0
