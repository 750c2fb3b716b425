"""Profiling and per-stage timing, counterpart of ``nmf_tpu.utils.profiling``.

  * :func:`trace`: a context manager around ``torch.profiler`` that writes
    a Chrome trace (``trace.json``, which Perfetto and ``chrome://tracing``
    read) of the host and, on the card, the device activity.
  * :func:`stage_timings`: the reference's per-stage ``t[10]`` timings
    (README.md:46,53) restored: each stage of one MU iteration run on its
    own, with JAX's keys, timed with CUDA events on the card and with
    ``time.perf_counter`` on the CPU.  ``full_step`` is the step
    :func:`~nmf_tpu_torch.solve` runs at f32 (K1 and K2 on the card), the
    other stages plain torch ops, so they show where the time would go
    unfused.
  * :func:`force_completion`: wait for the card's queue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

__all__ = ["trace", "stage_timings", "force_completion"]


def force_completion(*tensors) -> None:
    """Wait until the work that makes ``tensors`` is done (a synchronize of
    each CUDA tensor's device; nothing for CPU tensors)."""
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("nmf-trace") as prof: run(...)`` writes
    ``nmf-trace/trace.json``, with the device's kernels and copies when a
    card is there.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with_cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if with_cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if with_cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _timeit(fn, args, repeats: int, cuda: bool) -> float:
    """Best of ``repeats`` calls, in seconds, after a warm-up call."""
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best


def stage_timings(x, w, h, eps: Optional[float] = None, repeats: int = 5,
                  device="cuda") -> Dict[str, float]:
    """Per-stage standalone timings (seconds) of one MU iteration's pieces.

    The stages follow the reference's kernel launches (nmf.cu:118-176):
    recon_divide (W H, the clamp and X / it), h_numerator (W^T Z),
    w_numerator (Z H^T), sums (colsum W, rowsum H, clamped), epilogues (the
    row and column scalings), kl_cost (the per-check cost), full_step (also
    keyed ``fused_step``, JAX's legacy name: one whole iteration of the
    step the solve runs at this shape, its backend resolved as ``solve``
    resolves it: K1 and K2 where the card's rule keeps the kernels) and
    null_dispatch (a trivial op, the floor under every number).  The inputs
    go to ``device`` as f32.
    """
    from ..models.solver import resolve_step_fn
    from .autotune import resolve_config
    from ..ops.divergence import kl_divergence
    from ..ops.elementwise import EPS, eps_clamp
    from ..ops.mu import matmul
    from .config import Precision, SolveConfig
    from .convert import to_tensor
    from .device import resolve_device

    eps = EPS if eps is None else eps
    prec = Precision()
    dev = resolve_device(device)
    x, w, h = (to_tensor(a, dev).to(torch.float32).contiguous() for a in (x, w, h))

    def recon(w, h, x):
        return x / eps_clamp(matmul(w, h, prec), eps)

    z = recon(w, h, x)
    (m, k), n = w.shape, h.shape[1]
    step = resolve_step_fn(resolve_config(SolveConfig(eps=eps), m, k, n, dev, "profiling"))
    stages = {
        "recon_divide": (recon, (w, h, x)),
        "h_numerator": (lambda w, z: matmul(w, z, prec, transpose_a=True), (w, z)),
        "w_numerator": (lambda z, h: matmul(z, h, prec, transpose_b=True), (z, h)),
        "sums": (lambda w, h: (eps_clamp(torch.sum(w, dim=0), eps),
                               eps_clamp(torch.sum(h, dim=1), eps)), (w, h)),
        "epilogues": (lambda w, h: (h * 2.0 / eps_clamp(torch.sum(w, dim=0), eps)[:, None],
                                    w * 2.0 / eps_clamp(torch.sum(h, dim=1), eps)[None, :]),
                      (w, h)),
        "kl_cost": (lambda x, w, h: kl_divergence(x, w, h, eps), (x, w, h)),
        "full_step": (step, (w, h, x)),
        "null_dispatch": (lambda a: a + 1.0, (torch.zeros((), device=dev),)),
    }
    cuda = dev.type == "cuda"
    out = {name: _timeit(fn, args, repeats, cuda) for name, (fn, args) in stages.items()}
    out["fused_step"] = out["full_step"]  # legacy key
    return out
