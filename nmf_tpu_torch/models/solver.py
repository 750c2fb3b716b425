"""The NMF solve loop: check-blocked, with no host sync when ``thresh == 0``.

Counterpart of ``nmf_tpu.models.solver``.  The JAX package builds one
``jit(lax.while_loop)``; PyTorch runs eagerly, so the loop is a Python loop
that enqueues kernels on the current stream and keeps every device value on
the device:

* ``chunk = min(check_every, max_iter - it)`` steps per check block;
* the cost is taken at the end of each block into a device-side history
  of ``ceil(max_iter / check_every)`` f32 slots (unused ones NaN);
* with ``thresh == 0`` nothing is read back until the run ends, so exactly
  ``max_iter`` iterations run (nmf.cu:11); with ``thresh > 0`` one scalar
  is read per check to decide whether to stop.

``accelerate=True`` runs the safeguarded Nesterov loop
(:func:`_run_accel_loop`).  Its accept/reject decision is made on the host:
one cost is read back per check block (two on a rejected block), so under
``accelerate`` even ``thresh == 0`` syncs once a block.

``live_metrics=True`` calls :func:`~nmf_tpu_torch.utils.metrics.emit_live`
at each check with ``(iteration, cost, rel_change)``, the values of JAX's
loops (``rel_change`` NaN at the first check of a run with no baseline).
The plain loop reads the cost and the relative change back for it, one
read a check, which a ``thresh == 0`` run does not make otherwise; the
accelerated loop reads its costs anyway.  No value of the solve changes.

Every precision policy runs: the state in f32 or bf16, X as f32, bf16 or
uint8 codes with scales (quantized at load, or passed in as a pair).

Every family of the JAX package runs: the KL MU (the fused kernels, or
plain ops by :func:`_use_kernels`), and the beta-divergence MU (``beta !=
1``), HALS (``algorithm="hals"``) and the penalized KL MU (L1/L2), which
take plain ops on every device, as in JAX (``solver.py:113-127``).

:func:`solve` resolves ``backend="auto"`` and ``"autotune"`` per shape
before it builds the step, as JAX's ``solve`` does
(:func:`nmf_tpu_torch.utils.autotune.resolve_config`): on CUDA tensors the
card's measured rule, or a measurement cached on disk; on CPU tensors the
kernel wrappers, which take their plain versions there.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.divergence import beta_divergence, kl_divergence
from ..ops.hals import hals_step
from ..ops.kernels import fused_mu
from ..ops.mu import mu_step, mu_step_beta, mu_step_kl_reg
from ..ops.quant import dequantize, quantize_policy
from ..utils.autotune import resolve_config
from ..utils.config import SolveConfig
from ..utils.convert import to_tensor
from ..utils.device import resolve_device
from ..utils.metrics import emit_live

__all__ = ["SolveResult", "solve", "solve_jit", "resolve_step_fn", "run_checked_loop"]

_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
StepFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
CostFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class SolveResult:
    """Factorization result, the fields of ``nmf_tpu``'s ``SolveResult``.

    ``w``, ``h``, ``cost``, ``cost_history`` and ``momentum`` stay on the
    solve's device; ``iterations``, ``num_checks`` and ``converged`` are
    known on the host and are CPU tensors.  ``momentum`` is the accelerated
    loop's final momentum coefficient, NaN for a plain solve.  ``w_ex`` and
    ``h_ex`` are the accelerated loop's extrapolation carry, set only when
    the solve was given ``initial_extrap`` (a segment of a longer run): a
    segment fed ``momentum`` and ``(w_ex, h_ex)`` back as
    ``initial_momentum`` and ``initial_extrap`` continues the run exactly.
    """

    w: torch.Tensor
    h: torch.Tensor
    iterations: torch.Tensor     # i32 scalar: MU iterations actually run
    cost: torch.Tensor           # f32 scalar: final divergence (NaN if none)
    cost_history: torch.Tensor   # f32 [num_check_slots]
    num_checks: torch.Tensor     # i32 scalar: populated history entries
    converged: torch.Tensor      # bool scalar: stopped via threshold
    momentum: torch.Tensor = None   # f32 scalar: final accel momentum (NaN if none)
    w_ex: torch.Tensor = None
    h_ex: torch.Tensor = None


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _use_kernels(config: SolveConfig) -> bool:
    """Whether the step and cost go to the fused kernels.

    ``"jnp"`` means plain torch ops; ``"pallas"`` the kernels, and so do
    ``"auto"`` and ``"autotune"`` where nothing resolved them by shape
    (:func:`nmf_tpu_torch.utils.autotune.resolve_config` does, at every
    entry point).  Per-row-block int8 scales are not in
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


def _dequant_wrap_step(step_fn: StepFn) -> StepFn:
    """A step on dense X as a step on ``(codes, scales)``: the plain ops on
    dequantized X."""
    return lambda w, h, x: step_fn(w, h, dequantize(*x))


def _dequant_wrap_cost(cost_fn: CostFn) -> CostFn:
    return lambda x, w, h: cost_fn(dequantize(*x), w, h)


def _family_step(config: SolveConfig) -> Optional[StepFn]:
    """The plain step of the beta, HALS and penalized families (every
    device, ``nmf_tpu/models/solver.py:113-127``), or None for KL MU."""
    eps, prec = config.eps, config.precision
    if config.algorithm == "hals":
        return functools.partial(hals_step, eps=eps, precision=prec)
    if config.beta != 1.0:
        return functools.partial(mu_step_beta, beta=config.beta, eps=eps, precision=prec)
    if config.regularized:
        return functools.partial(
            mu_step_kl_reg, eps=eps, precision=prec,
            l1_w=config.l1_w, l1_h=config.l1_h, l2_w=config.l2_w, l2_h=config.l2_h,
        )
    return None


def resolve_step_fn(config: SolveConfig) -> StepFn:
    """The per-iteration update for this config.

    The beta, HALS and penalized families take plain torch ops; KL MU the
    fused kernels (which take their plain version for CPU tensors and
    dequantize int8 X themselves) or plain torch ops, by :func:`_use_kernels`.
    """
    config.validate()
    fn = _family_step(config)
    if fn is None:
        if _use_kernels(config):
            return functools.partial(
                fused_mu.mu_step_fused, eps=config.eps, precision=config.precision
            )
        fn = functools.partial(mu_step, eps=config.eps, precision=config.precision)
    return _dequant_wrap_step(fn) if config.precision.x_dtype == "int8" else fn


def _cost_fn(config: SolveConfig) -> CostFn:
    eps = config.eps
    if config.beta != 1.0:
        fn = functools.partial(beta_divergence, beta=config.beta, eps=eps)
    elif config.regularized:
        def fn(x, w, h):
            # KL + l1 ||.||_1 + (l2 / 2) ||.||_F^2 (``solver.py:159-172`` of JAX)
            wf, hf = w.to(_F32), h.to(_F32)
            pen = (config.l1_w * torch.sum(torch.abs(wf)) + config.l1_h * torch.sum(torch.abs(hf))
                   + 0.5 * config.l2_w * torch.sum(wf * wf)
                   + 0.5 * config.l2_h * torch.sum(hf * hf))
            return kl_divergence(x, w, h, eps) + pen
    elif _use_kernels(config):
        return functools.partial(fused_mu.kl_cost_fused, eps=eps, precision=config.precision)
    else:
        fn = functools.partial(kl_divergence, eps=eps)
    return _dequant_wrap_cost(fn) if config.precision.x_dtype == "int8" else fn


def run_checked_loop(
    x: torch.Tensor,
    w: torch.Tensor,
    h: torch.Tensor,
    config: SolveConfig,
    step_fn: StepFn,
    cost_fn: CostFn,
    initial_cost: Optional[float] = None,
    initial_momentum: Optional[float] = None,
    initial_extrap: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    all_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    live_emit: Optional[Callable] = None,
) -> SolveResult:
    """The check-blocked loop (``solver.py:402-498`` of the JAX package).

    ``initial_cost`` seeds the convergence baseline (None/NaN: the first
    check never converges).  ``config.accelerate`` sends the run to
    :func:`_run_accel_loop`, with ``initial_momentum`` and
    ``initial_extrap``.  ``config.live_metrics`` emits each check (module
    docstring) through ``live_emit`` (default :func:`emit_live`).

    ``all_reduce`` sums a cost partial over the ranks of a mesh (the
    sharded solves; default: the identity): it runs before the check's
    host read, so every rank reads the same cost and takes the same stop,
    and the loop stays uniform across ranks.
    """
    all_reduce = _identity if all_reduce is None else all_reduce
    emit = emit_live if live_emit is None else live_emit
    if config.accelerate:
        return _run_accel_loop(x, w, h, config, step_fn, cost_fn, initial_cost,
                               initial_momentum, initial_extrap, all_reduce, emit)
    max_iter = int(config.max_iter)
    check_every = int(config.check_every)
    thresh = float(config.thresh)
    # with thresh == 0 and no tracking the cost GEMM is skipped entirely
    need_cost = config.track_cost or thresh > 0.0
    live = bool(config.live_metrics)
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
            cost = all_reduce(cost_fn(x, w, h)).to(_F32)
            hist[chk] = cost          # device-to-device copy, no sync
            if thresh > 0.0 or live:
                # the one host read per check, compared in f32 as the JAX
                # loop compares; NaN (the first check) never stops
                rel = torch.abs(prev - cost) / torch.abs(cost)
                if live:
                    emit(it, *torch.stack((cost, rel)).tolist())
                if thresh > 0.0:
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


def extrapolate(new: torch.Tensor, old: torch.Tensor, m: float, eps: float) -> torch.Tensor:
    """``max(f32(new) + m (f32(new) - f32(old)), f32(eps))`` in the dtype of
    ``new`` (bf16: rounded to nearest even), with ``m`` and ``eps`` rounded
    to f32: the JAX loops' ``_extrap``, whose multiply-add XLA fuses into
    one FMA, as ``torch.add(..., alpha=m)`` computes it.  Plain torch ops,
    three elementwise passes on f32 state; the inputs are not written."""
    n32 = new.to(_F32)
    e = torch.add(n32, torch.sub(n32, old.to(_F32)), alpha=float(m)).clamp_min_(float(eps))
    return e.to(new.dtype)


def _run_accel_loop(
    x, w, h, config: SolveConfig, step_fn: StepFn, cost_fn: CostFn,
    initial_cost: Optional[float] = None,
    initial_momentum: Optional[float] = None,
    initial_extrap: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    all_reduce: Callable[[torch.Tensor], torch.Tensor] = _identity,
    emit: Callable = emit_live,
) -> SolveResult:
    """Safeguarded Nesterov-extrapolated loop (``config.accelerate``;
    ``solver.py:501-649`` of the JAX package).

    Each step runs from the extrapolated point ``(we, he)``
    (:func:`extrapolate` of the new iterate against the last one); the
    recorded iterate is the step's output.  At each block end the cost of
    the iterate decides: kept if it did not rise (the momentum grows by
    ``accel_grow`` up to ``accel_momentum_max``), else the block is redone
    with plain steps from its start, the extrapolation carry restarts at the
    new iterate and the momentum shrinks by ``accel_shrink``.  A NaN cost
    rejects.  So the recorded history never rises.

    The momentum is an f32 scalar, multiplied and capped in f32 as the JAX
    loop does on the device, so the final ``momentum`` is JAX's bit for bit
    wherever the accept/reject sequence is.  JAX decides on the device
    (``lax.cond``); here each block's cost is read back to decide, so this
    loop syncs the host once a block (twice on a reject).  The costs live on
    the host as f32, the history goes to the device at the end.

    ``all_reduce`` and ``emit`` are :func:`run_checked_loop`'s: every cost
    read is summed over the mesh first, so each rank accepts or rejects
    alike.  The seed cost is taken up front unless ``initial_cost`` is
    given (not NaN); the carry starts at the iterate unless ``initial_extrap`` (in the
    state dtype, on the device) is given, and then comes back in
    ``w_ex``/``h_ex``.
    """
    max_iter = int(config.max_iter)
    check_every = int(config.check_every)
    thresh = np.float32(config.thresh)
    eps = config.eps
    n_slots = max(config.num_checks, 1)
    m = np.float32(config.accel_momentum)
    if initial_momentum is not None and not np.isnan(initial_momentum):
        m = np.float32(initial_momentum)
    m_max = np.float32(config.accel_momentum_max)
    grow = np.float32(config.accel_grow)
    shrink = np.float32(config.accel_shrink)

    def cost_of(w, h):
        # the host read: the accept test and the stop test are f32 compares
        return np.float32(all_reduce(cost_fn(x, w, h)).to(_F32).item())

    if initial_cost is None or np.isnan(initial_cost):
        cost = cost_of(w, h)
    else:
        cost = np.float32(initial_cost)
    we, he = (w, h) if initial_extrap is None else initial_extrap
    hist = np.full((n_slots,), np.nan, np.float32)
    it, chk, done = 0, 0, False
    while it < max_iter and not done:
        chunk = min(check_every, max_iter - it)
        w0, h0 = w, h           # the wrappers return fresh tensors: no copy
        for _ in range(chunk):
            wn, hn = step_fn(we, he, x)
            we, he = extrapolate(wn, w, m, eps), extrapolate(hn, h, m, eps)
            w, h = wn, hn
        c = cost_of(w, h)
        if c <= cost:
            m = min(np.float32(m * grow), m_max)
        else:                   # rejected (NaN too): redo the block plain
            w, h = w0, h0
            for _ in range(chunk):
                w, h = step_fn(w, h, x)
            c = cost_of(w, h)
            we, he = w, h
            m = np.float32(m * shrink)
        it += chunk
        prev, cost = cost, c
        hist[chk] = cost
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.abs(prev - cost) / np.abs(cost)   # f32, as on JAX's device
        if config.live_metrics:
            emit(it, cost, rel)
        if thresh > 0:
            done = bool(rel < thresh)
        chk += 1
    dev = w.device
    return SolveResult(
        w=w,
        h=h,
        iterations=torch.tensor(it, dtype=torch.int32),
        cost=torch.tensor(cost, dtype=_F32).to(dev),
        cost_history=torch.from_numpy(hist).to(dev),
        num_checks=torch.tensor(chk, dtype=torch.int32),
        converged=torch.tensor(done, dtype=torch.bool),
        momentum=torch.tensor(m, dtype=_F32).to(dev),
        w_ex=we if initial_extrap is not None else None,
        h_ex=he if initial_extrap is not None else None,
    )


@functools.lru_cache(maxsize=32)
def solve_jit(config: SolveConfig, platform: Optional[str] = None):
    """The solver of a config, built once and cached (``solve_jit`` of
    ``nmf_tpu.models.solver``): ``_solve(x, w, h, initial_cost,
    initial_momentum=None, initial_extrap=None)`` runs
    :func:`run_checked_loop` with the config's step and cost on tensors
    already prepared (clamped, cast or quantized, on their device, as
    :func:`solve` prepares them).

    ``platform`` names the device type the tensors lie on, ``"cuda"`` or
    ``"cpu"`` (None: either); it keys the cache, as JAX's platform does,
    and the step is the same, because the kernel wrappers take their plain
    version for CPU tensors.  A config with ``backend="auto"`` or
    ``"autotune"`` takes the kernels here; :func:`solve` resolves the
    backend by the shape's rule before it builds the solver.

    JAX donates W and H to the jitted call.  Nothing here writes into the
    caller's ``w`` and ``h``: every step returns new tensors, so they keep
    their values, and the result's factors are new tensors.  ``initial_cost``
    (NaN or None: no baseline) and ``initial_momentum`` are host numbers or
    0-d tensors.
    """
    if platform not in (None, "cuda", "cpu"):
        raise ValueError(f"unsupported platform {platform!r}: use 'cuda' or 'cpu'")
    step_fn = resolve_step_fn(config)
    cost_fn = _cost_fn(config)

    def _solve(x, w, h, initial_cost, initial_momentum=None, initial_extrap=None):
        c0 = None if initial_cost is None else float(initial_cost)
        m0 = None if initial_momentum is None else float(initial_momentum)
        return run_checked_loop(x, w, h, config, step_fn, cost_fn,
                                None if c0 is None or np.isnan(c0) else c0, m0, initial_extrap)

    return _solve


def _shape(a) -> Tuple[int, ...]:
    return tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))


def check_inputs(x, w0, h0, config: SolveConfig) -> None:
    """The boundary checks of a solve: a ``(codes, scales)`` pair only
    under ``x_dtype="int8"`` with scales of the policy's rank, and the
    shapes of X, W and H."""
    if isinstance(x, tuple):
        if config.precision.x_dtype != "int8":
            raise ValueError(
                "X is a pre-quantized (codes, scales) pair but "
                f"Precision(x_dtype={config.precision.x_dtype!r}) — pre-quantized "
                "input requires x_dtype='int8' (quantize with "
                "ops.quant.quantize_policy on the same Precision)"
            )
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


def solve(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    clamp_inputs: bool = True,
    initial_cost: float = float("nan"),
    device="cuda",
    initial_momentum: float = float("nan"),
    initial_extrap=None,
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

    ``initial_cost`` seeds the convergence baseline of a resumed run;
    ``initial_momentum`` seeds the accelerated loop's momentum (NaN: start
    at ``config.accel_momentum``), and ``initial_extrap``, a ``(w_ex,
    h_ex)`` pair cast to the state dtype, its extrapolation carry; then the
    result's ``w_ex``/``h_ex`` hold the carry for the next segment
    (``utils.convert.accel_state_from`` reads both from a result of either
    package).
    """
    config.validate()
    check_inputs(x, w0, h0, config)
    dev = resolve_device(device)
    (m, k), n = _shape(w0), _shape(h0)[1]
    config = resolve_config(config, m, k, n, dev, "solve")
    step_fn = resolve_step_fn(config)
    cost_fn = _cost_fn(config)
    x, w0, h0 = _prep(x, w0, h0, config, clamp_inputs, dev)
    if initial_extrap is not None:
        initial_extrap = tuple(to_state(a, config, dev, clamp=False) for a in initial_extrap)
    c0 = None if np.isnan(initial_cost) else initial_cost
    return run_checked_loop(x, w0, h0, config, step_fn, cost_fn, c0,
                            float(initial_momentum), initial_extrap)


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
