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

Not in the port yet, and refused with ``NotImplementedError``:
``accelerate``, ``live_metrics``, ``beta != 1``, ``algorithm="hals"``,
penalties, any precision other than all-f32, and ``backend="autotune"``.
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
from ..utils.config import SolveConfig
from ..utils.device import resolve_device

__all__ = ["SolveResult", "solve", "resolve_step_fn", "run_checked_loop"]

_F32 = torch.float32

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
        f"{config.precision}": not config.precision.all_f32,
        "backend='autotune'": config.backend == "autotune",
    }
    missing = [name for name, on in later.items() if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)} not in the PyTorch port yet (see "
            "ROADMAP.md: accel loop, precision tiers, model families)"
        )


def resolve_step_fn(config: SolveConfig) -> StepFn:
    """The per-iteration update for this config.

    ``"auto"`` and ``"pallas"`` give the fused kernels (which take their
    plain version for CPU tensors); ``"jnp"`` gives plain torch ops.
    """
    config.validate()
    _refuse_unported(config)
    step = fused_mu.mu_step_fused if config.backend != "jnp" else mu_step
    return functools.partial(step, eps=config.eps, precision=config.precision)


def _cost_fn(config: SolveConfig) -> CostFn:
    if config.backend != "jnp":
        return functools.partial(
            fused_mu.kl_cost_fused, eps=config.eps, precision=config.precision
        )
    return functools.partial(kl_divergence, eps=config.eps)


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

    ``x``, ``w0`` and ``h0`` are NumPy arrays or tensors; they are copied to
    ``device`` (``"cuda"`` by default; a CUDA request without a card
    raises).  ``clamp_inputs`` replicates the load-time ``set_epsilon``
    (nmf.cu:211): W and H are clamped in the state dtype, X in f32.  The
    clamp writes fresh tensors, so the caller's arrays are never modified
    (the JAX package donates its internal copies; nothing here needs to).
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
    x = torch.as_tensor(x, device=dev).to(_F32)
    w0 = torch.as_tensor(w0, device=dev).to(_F32)
    h0 = torch.as_tensor(h0, device=dev).to(_F32)
    if clamp_inputs:
        x = torch.clamp_min(x, float(config.eps))
        w0 = torch.clamp_min(w0, float(config.eps))
        h0 = torch.clamp_min(h0, float(config.eps))
    # row-major operands for the kernels (a no-op for fresh tensors)
    x, w0, h0 = x.contiguous(), w0.contiguous(), h0.contiguous()
    c0 = None if np.isnan(initial_cost) else initial_cost
    return run_checked_loop(x, w0, h0, config, step_fn, cost_fn, c0)
