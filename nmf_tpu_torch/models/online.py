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
:func:`~nmf_tpu_torch.transform_out_of_core` for an H.

On the card a block's whole update (JAX's one program a block,
``_online_jit``: the inner H loop, the cost, the folds of A and c, W)
replays a CUDA graph kept for the call (:class:`_OnlineGraph`, in a
``solver.StreamGraphs``): a graph per stream slot and block width, reading
X (int8's codes and scales) in the stream's fixed device buffers, W, A and
c in buffers of the call, the block's seeded H start copied in.  A width
graphs where its blocks, over all passes, number more than
``solver.MIN_REPLAYS`` and M x width x K is below
``solver.GRAPH_MAX_WORK``; each graph's first block runs eagerly on the
side stream, its second is captured and replayed, the later ones replay
(``solver.GRAPH_COUNTS``).  The graph's cost is cloned out after each
replay, as the next block's replay writes the same buffer before the host
reads the cost one block late.  ``solver.eager_loop()`` runs every block
eagerly; the two give the same bits.

``mesh=`` (``online.py:65-120, 242-306`` of the JAX package): W and A are
row-sharded, each block's X cut into the ranks' (M/r, width/c) pieces
(each rank copies only its own), H column-sharded, c replicated.  The
inner H loop is the plain ``update_h_sharded`` (sums over 'mr'), as in
JAX; A's and c's block terms are summed over 'mc' and the cost over both
axes; int8 X is dequantized block-locally.  The result's W is the global
one, on every rank.  A mesh's blocks run eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.divergence import kl_divergence
from ..ops.elementwise import eps_clamp
from ..ops.mu import _recon_ratio, matmul, update_h
from ..parallel.mesh import (
    BOTH,
    COL_AXIS,
    ROW_AXIS,
    Placement,
    axis_size,
    check_mesh,
    gather,
    mesh_coordinate,
    mesh_device,
    psum,
)
from ..parallel.sharded import _dequant_local, kl_partial, update_h_sharded
from ..utils.config import SolveConfig
from ..utils.device import resolve_device
from . import solver
from .solver import to_state
from .streaming import (
    _BlockStream,
    _as_source,
    _check_mesh_dims,
    _dense,
    _mesh_layout,
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


class _OnlineGraph(solver._PartGraphs):
    """One block's whole update as a CUDA graph over a stream slot's X
    (JAX's ``_online_jit``): the graph's H start buffer, the call's W, A
    and c (``state``, shared by every graph of the call) and the cost's
    buffer.  ``fold(x, h)`` is the update, writing W, A and c in place and
    returning the cost (None untracked).  The first block runs eagerly on
    the side stream, the second is captured there and replayed, the later
    ones replay (``solver._PartGraphs``)."""

    def __init__(self, h, state, fold, track: bool):
        super().__init__(h.device, 1)
        self.h = torch.empty_like(h)
        self.cost = torch.full((), float("nan"), dtype=_F32, device=h.device)
        self.w, self.a, self.c = state
        self.fold, self.track = fold, track
        self.x = None

    def state(self) -> Tuple[torch.Tensor, ...]:
        return self.w, self.a, self.c, self.h, self.cost

    def _update(self) -> None:
        cost = self.fold(self.x, self.h)
        if self.track:
            self.cost.copy_(cost)

    def block(self, x, h) -> Optional[torch.Tensor]:
        """Block ``x`` from the start ``h``: its cost (None untracked), a
        tensor of its own, which no later replay writes."""
        self.x = x
        self.h.copy_(h)
        self._part("update", self._update, None, 1, self.warm)
        solver.GRAPH_COUNTS["replays" if self.warm else "warm_ups"] += 1
        self.warm = True
        return self.cost.clone() if self.track else None


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
    request without a card raises) or ``"cpu"``.  ``mesh`` (module
    docstring): ``block_n`` must be a multiple of the mesh's column count,
    and every rank gets the global W.
    """
    config.validate()
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
    if mesh is not None:
        mesh = check_mesh(mesh)
        rounded, cdev = _check_mesh_dims(mesh, m, n, bn), axis_size(mesh, COL_AXIS)
        if block_n is not None and block_n % cdev:
            # rounding would cut the stream into other blocks than a
            # single-device run with the same arguments (online.py:258)
            raise ValueError(
                f"block_n={block_n} must be a multiple of the mesh column "
                f"count {cdev} (block partitions define the learning "
                f"trajectory)"
            )
        bn = rounded
    blocks: List[Tuple[int, int]] = [(j, min(j + bn, n)) for j in range(0, n, bn)]
    rows, local = None, blocks
    if mesh is not None:
        if mesh_coordinate(mesh) is None:
            return None
        dev = mesh_device(mesh)
        rows, local = _mesh_layout(mesh, m, n, blocks)
        w0 = w0[rows[0]:rows[1]]
    else:
        dev = resolve_device(device)

    w = to_state(w0, config, dev)
    a = torch.zeros((w0.shape[0], k), dtype=_F32, device=dev)
    c = torch.zeros((k,), dtype=_F32, device=dev)
    rho_t = torch.tensor(rho, dtype=_F32, device=dev)
    track = bool(config.track_cost)
    stream = _BlockStream(source, local, dev, prec.x_dtype, eps, prec.x_quant_rows,
                          _qcache_budget(), rows=rows)

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

    def block_update_sharded(w, a, c, x_b, h):
        # _online_sharded_jit's block_update (online.py:78-102 of JAX)
        if isinstance(x_b, tuple):
            x_b = _dequant_local(x_b, mesh)
        for _ in range(int(inner_iters)):
            h = update_h_sharded(w, h, x_b, eps, prec, mesh=mesh)
        cost = psum(kl_partial(x_b, w, h, eps), mesh, BOTH) if track else None
        z = _recon_ratio(w, h, x_b, eps, prec)
        a = rho_t * a + psum(matmul(z, h, prec, transpose_b=True), mesh, COL_AXIS)
        c = rho_t * c + psum(torch.sum(h, dim=1, dtype=_F32), mesh, COL_AXIS)
        w = (w * (a / eps_clamp(c, eps)[None, :])).to(w.dtype)
        return w, a, c, cost

    update = block_update if mesh is None else block_update_sharded

    def fold(x_b, h):
        """Block ``x_b``'s update from the H start ``h``: W, A and c written
        in place (the call's buffers), its cost returned (None untracked)."""
        w_n, a_n, c_n, cost = update(w, a, c, x_b, h)
        for buf, t in ((w, w_n), (a, a_n), (c, c_n)):
            buf.copy_(t)
        return cost

    widths = [j1 - j0 for j0, j1 in local]
    graphs = solver.StreamGraphs({wd: widths.count(wd) * passes for wd in set(widths)})

    def runner(x_b, h):
        """The block's graph, or None where its width runs eagerly."""
        width = h.shape[1]
        if mesh is not None or not (graphs.allows(width)
                                    and solver._graph_rule(dev, w.shape[0] * k * width)):
            return None
        return graphs.get(graphs.x_key(x_b),
                          lambda: _OnlineGraph(h, (w, a, c), fold, track))

    all_costs: List[List[float]] = []
    for _ in range(passes):
        pass_costs: List[float] = []
        pend = None
        for idx, x_b in stream.sweep():
            j0, j1 = blocks[idx]
            h0 = seeded_block_h(seed + idx, k, j1 - j0, eps)
            if mesh is not None:     # this rank's piece of the block's columns
                l0, l1 = local[idx]
                h0 = np.ascontiguousarray(h0[:, l0 - j0:l1 - j0])
            h0 = upload_state(h0, config, dev)
            graph = runner(x_b, h0)
            cost = fold(x_b, h0) if graph is None else graph.block(x_b, h0)
            if pend is not None:
                pass_costs.append(float(pend))   # block idx - 1, while idx computes
            pend = cost
        if track:
            pass_costs.append(float(pend))
        all_costs.append(pass_costs)
    del graphs, stream           # the graphs first: they read the stream's buffers
    if mesh is not None:
        w = gather(w, Placement(mesh, (ROW_AXIS, None)))
    return OnlineResult(w=w.to(_F32).cpu().numpy(), block_costs=all_costs, blocks=blocks,
                        passes=passes)
