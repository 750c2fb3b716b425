"""Online (one-pass, streaming) NMF: learn W from a column stream.

Counterpart of ``nmf_tpu.models.online`` on one device.
:func:`~nmf_tpu_torch.solve_out_of_core` streams every block once an
iteration; the online learner visits each block once a pass and still
learns a full dictionary (Lefevre, Bertin & Badeau 2011, the KL instance of
the sufficient-statistics online MU)::

    per block X_b:
      1. H_b: ``inner_iters`` H-only MU iterations against the current W
         (the reference's update_h, nmf.cu:118-146), from a seeded start;
      2. A <- rho A + (X_b / clamp(W H_b)) H_b^T       (M, K)
         c <- rho c + rowsum(H_b)                      (K,)
      3. W <- W * A / clamp(c, eps)

``rho`` in (0, 1] forgets old blocks (1: all history weighs the same).  The
device holds W, A, c and two blocks, whatever the stream's length.

Plain torch ops on every device, as in JAX (``backend="pallas"`` raises
there, ``online.py:202-208``): K1 computes the inner ``update_h``, but a
kernel would change the bits of the reference's plain step (ROADMAP.md,
"Later speed work").  The blocks come through the solve's double-buffered
``_BlockStream``, so the next block's fill overlaps this block's compute,
and each block's cost (taken after its H fit, before its W step) is read
back one block late.  Activations are not kept: run
:func:`~nmf_tpu_torch.transform_out_of_core` for an H.  Not ported:
``mesh`` (ROADMAP.md Queue 1 step 12b).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.divergence import kl_divergence
from ..ops.elementwise import eps_clamp
from ..ops.mu import _recon_ratio, matmul, update_h
from ..utils.config import SolveConfig
from ..utils.device import resolve_device
from .solver import _MESH, to_state
from .streaming import (
    _BlockStream,
    _as_source,
    _dense,
    _qcache_budget,
    pick_block_n,
    seeded_block_h,
    upload_state,
)

__all__ = ["OnlineResult", "solve_online"]

_F32 = torch.float32


@dataclasses.dataclass
class OnlineResult:
    """The learned dictionary.  ``block_costs[p][j]`` is the KL divergence of
    pass p's block j after its H fit and before its W step: the online
    learning curve, which falls across blocks and passes as W improves."""

    w: np.ndarray                    # (M, K) float32
    block_costs: List[List[float]]   # per pass, per block
    blocks: List[Tuple[int, int]]
    passes: int

    @property
    def learning_curve(self) -> np.ndarray:
        return np.asarray([c for p in self.block_costs for c in p], np.float64)


def solve_online(
    x,
    w0,
    config: SolveConfig = SolveConfig(),
    *,
    block_n: Optional[int] = None,
    inner_iters: int = 20,
    rho: float = 1.0,
    passes: int = 1,
    seed: int = 0,
    mesh=None,
    device="cuda",
) -> OnlineResult:
    """One-pass streaming dictionary learning (see the module docstring).

    ``x`` is an array, memmap, ``.bin`` path or column source; the KL
    (beta = 1) MU family only.  Block ``idx`` starts from
    ``RandomState(seed + idx).rand(K, width)`` clamped to eps; ``passes >
    1`` streams the source again with the statistics carried over.  X is
    stored as ``precision.x_dtype`` (f32, bf16 or int8 on the wire).  With
    ``track_cost=False`` no block cost is taken, and ``block_costs`` holds
    one empty list a pass.  ``device`` is ``"cuda"`` by default (a CUDA
    request without a card raises) or ``"cpu"``.
    """
    config.validate()
    if mesh is not None:
        raise NotImplementedError(_MESH)
    if config.backend == "pallas":
        raise NotImplementedError(
            "online NMF's per-block statistics updates run as XLA ops "
            "(the fused MU kernels implement full W@H sweeps, not the "
            "A/B-folded updates) — backend='pallas' would be silently "
            "ignored; use backend='auto'"
        )
    if config.live_metrics:
        raise NotImplementedError(
            "online learning tracks per-block costs, not the global "
            "per-check divergence live_metrics streams; read "
            "OnlineResult.block_costs (track_cost=True) instead"
        )
    if config.beta != 1.0 or config.algorithm != "mu" or config.regularized:
        raise NotImplementedError("online NMF implements the reference KL (beta=1) MU family")
    if config.accelerate:
        raise NotImplementedError(
            "online learning's per-block statistics folding has no global "
            "cost to safeguard an extrapolated step against; accelerate=True "
            "applies to the full-solve families"
        )
    if not (0.0 < rho <= 1.0):
        raise ValueError(f"rho must be in (0, 1], got {rho}")
    if inner_iters < 1:
        raise ValueError("inner_iters must be >= 1")
    if passes < 1:
        raise ValueError("passes must be >= 1")
    source = _as_source(x)
    m, n = source.shape
    w0 = np.asarray(w0, np.float32)
    if w0.ndim != 2 or w0.shape[0] != m:
        raise ValueError(f"W0 {w0.shape} does not match X {(m, n)}")
    k = w0.shape[1]
    eps, prec = config.eps, config.precision
    bn = block_n if block_n is not None else pick_block_n(m, n)
    blocks: List[Tuple[int, int]] = [(j, min(j + bn, n)) for j in range(0, n, bn)]
    dev = resolve_device(device)

    w = to_state(w0, config, dev)
    a = torch.zeros((m, k), dtype=_F32, device=dev)
    c = torch.zeros((k,), dtype=_F32, device=dev)
    rho_t = torch.tensor(rho, dtype=_F32, device=dev)
    track = bool(config.track_cost)
    stream = _BlockStream(source, blocks, dev, prec.x_dtype, eps, prec.x_quant_rows,
                          _qcache_budget())

    def block_update(w, a, c, x_b, h):
        x_b = _dense(x_b)
        for _ in range(int(inner_iters)):
            h = update_h(w, h, x_b, eps, prec)
        cost = kl_divergence(x_b, w, h, eps) if track else None
        z = _recon_ratio(w, h, x_b, eps, prec)
        a = rho_t * a + matmul(z, h, prec, transpose_b=True)
        c = rho_t * c + torch.sum(h, dim=1, dtype=_F32)
        w = (w * (a / eps_clamp(c, eps)[None, :])).to(w.dtype)
        return w, a, c, cost

    all_costs: List[List[float]] = []
    for _ in range(passes):
        pass_costs: List[float] = []
        pend = None
        for idx, x_b in stream.sweep():
            j0, j1 = blocks[idx]
            h0 = upload_state(seeded_block_h(seed + idx, k, j1 - j0, eps), config, dev)
            w, a, c, cost = block_update(w, a, c, x_b, h0)
            if pend is not None:
                pass_costs.append(float(pend))   # block idx - 1, while idx computes
            pend = cost
        if track:
            pass_costs.append(float(pend))
        all_costs.append(pass_costs)
    return OnlineResult(w=w.to(_F32).cpu().numpy(), block_costs=all_costs, blocks=blocks,
                        passes=passes)
