"""Wrappers of the tile-sparse numerator sweeps, kernel K5 (``csrc/tile_sparse.cu``).

Counterpart of ``nmf_tpu.ops.pallas.tile_sparse``: the same functions and
results, computed on Hopper by a hand-written CUDA kernel instead of Pallas.
X is a list of occupied bm x bn tiles; a sweep plan (:func:`sweep_plan`)
lists them sorted by output block, with one sentinel (``perm = -1``) for
each output block that has no tile.

* :func:`h_numerator`: ``W^T (X / max(W H, eps))`` over the tiles, (K, Np) f32;
* :func:`w_numerator`: ``(X / max(W H, eps)) H^T`` over the tiles, (Mp, K) f32.

Every mode of the TPU kernel: W and H in f32 or bf16, tiles in f32 or bf16,
GEMMs in ``float32``, ``float32_fast`` (split3) or ``bfloat16``.  Per-tile
uint8 codes are not a mode of the kernel in either package: the solver
sends them to :func:`sweep_plain` on dequantized tiles.

On the card K5 runs K1's (H) or K2's (W) pass 1 over the plan: under
``bfloat16`` and ``float32_fast`` on the tensor cores, under ``float32``
on the SIMT units.  Its pass 1 cuts the plan into chunks of ``per``
consecutive entries, each cut again where the output block changes, and
runs one block per piece, 64-wide slice of the output block and K chunk;
each writes a raw f32 partial to its slot, and pass 2 sums each output
block's partials in plan order.  :func:`sweep_split` gives ``per`` and the
slot count from sizes the host knows without reading the plan (``steps``,
``n_out``, the slices, the K chunks): the largest ``per``, up to the mean
run length ``ceil(steps / n_out)``, at which the expected pieces
(``steps / per`` chunks, and the ``n_out (per - 1) / per`` runs that start
inside one) still launch ``SWEEP_BLOCKS`` = 264 working blocks, two an SM
of an H100 (3 at the main 8192^2 shape: about 300 blocks); and
``ceil(steps / per) + n_out`` slots.  The wrapper allocates the partials
from torch's caching allocator, ``slots * K * bn`` (H) or ``slots * bm *
K`` (W) f32, and never reads the plan back to the host, so a call can be
captured into a CUDA graph (the tiled solve's check blocks), the partials
then coming from the graph's pool.  A replay runs K5 without this
wrapper: the loop that replays it adds the launches its capture recorded
to ``LAUNCHES`` and to the library's per-Mode counts
(``fused_mu.count_snapshot`` and ``add_counts`` carry both).

Each wrapper takes its plain version (:func:`sweep_plain`) only when its
tensors lie on the CPU.  For CUDA tensors it launches K5 or raises: there
is no fallback on a failed build or launch.  Above the rank ceiling
(:func:`supported`) the call goes to the plain version by design, counted
in ``PLAIN_CALLS`` apart from the launches in ``LAUNCHES``.

The TPU rules of the JAX module are not carried over: ``supported`` there
also asks for a TPU and for (8|16, 128)-aligned tiles (K5 takes any tile
shape), and its ``preferred`` is a TPU v5e crossover (the scan beats the
Pallas kernel under ``bfloat16`` below K = 384), measured on that chip
alone.  :func:`preferred` here is the H100's rule, which the tile-sparse
solve consults under ``backend="auto"`` and ``"autotune"`` for CUDA
tensors (``models/sparse_tiled.sweep_route``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ...utils.config import Precision
from ..elementwise import eps_clamp
from ..mu import matmul
from .fused_mu import (
    MAX_FUSED_K,
    TILE,
    _GEMM,
    _STATE_BF16,
    _check_2d,
    _index,
    _lib,
    _on_cpu,
    _raise_on,
    _stream,
    chunk_width,
)

__all__ = [
    "LAUNCHES",
    "PLAIN_CALLS",
    "SweepLayout",
    "preferred",
    "reset_counts",
    "supported",
    "sweep_split",
    "sweep_plan",
    "sweep_layout",
    "sweep_plain",
    "h_numerator",
    "w_numerator",
]

# Launches of K5 on the card (one per wrapper call that launched), and calls
# sent to the plain version on the card by the rank rule.
LAUNCHES: Dict[str, int] = {"h_numerator": 0, "w_numerator": 0}
PLAIN_CALLS: Dict[str, int] = {"h_numerator": 0, "w_numerator": 0}

# Working pass-1 blocks K5 aims for: two an SM of a 132-SM H100.  A fixed
# number, not read from the card, so the split (and the bits) depend on the
# plan's sizes alone.  At the 8192^2 K=128 main shape 3 entries a chunk
# (~300 blocks) ran as fast as 1 (~640) or faster (to 25%) in every mode
# but f32's W target (6% slower), and 2 (~390) and 4 (~256) ran slower
# (probe_timings.py sweep-per on an H100; PERF.md section 6).
SWEEP_BLOCKS = 2 * 132

_F32 = torch.float32
_X_KIND = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for key in d:
            d[key] = 0


def supported(k: int) -> bool:
    """Whether K5 takes rank ``k``: the rank rule shared with K1/K2."""
    return k <= MAX_FUSED_K


def preferred(k: int, bm: int, bn: int, precision: Precision) -> bool:
    """The auto backend rule of the sweeps on an H100: whether K5 beats the
    plain sweep (:func:`sweep_plain`, cuBLAS batched GEMMs over the tiles)
    at rank ``k`` with ``bm`` x ``bn`` tiles under ``precision``.

    Measured by ``chip_smoke.py --phases card,backend`` in three sessions
    at 8192^2 with 128^2 tiles at occupancy 0.08, K = 128, 256 and 384,
    under ``float32``, ``float32_fast`` and ``bfloat16`` (PERF.md,
    "Backend rule"): K5 won and separated in every cell but the f32 one at
    K = 384, where the plain sweep won (K5 walks the plan once per K chunk
    of 256 above K = 256).  So the f32 sweeps on f32 tiles and state above
    the row's ``tiled_f32_max_k`` (256 on the H100) take the plain sweep,
    and K5 takes the rest.  JAX's v5e rule (the scan under ``bfloat16``
    below K = 384) is not carried over.  Per-tile uint8 codes are not a
    mode of K5 (the plain sweep by rule), and ranks above
    :func:`supported` take the plain sweep by the rank rule.  ``bm`` and
    ``bn`` are JAX's arguments; K5 takes any tile shape.

    Milliseconds a step (both sweeps and the epilogues), the median of each
    of three sessions (NVIDIA H100 80GB HBM3, power limit 700.00 W):

        shape                    K5 ms                plain sweep ms        rule
        tiled K=128 float32      0.343/0.337/0.337    0.839/0.582/0.565     pallas
        tiled K=128 float32_fast 0.316/0.309/0.309    1.722/1.676/1.678     pallas
        tiled K=128 bfloat16     0.263/0.282/0.263    0.788/1.013/0.771     pallas
        tiled K=256 float32      0.616/0.617/0.621    0.887/0.895/0.896     pallas
        tiled K=256 float32_fast 0.540/0.538/0.535    2.892/2.892/2.888     pallas
        tiled K=256 bfloat16     0.369/0.373/0.383    1.296/1.295/1.305     pallas
        tiled K=384 float32      1.766/1.766/1.767    1.204/1.200/1.199     jnp
        tiled K=384 float32_fast 1.819/1.817/1.809    3.979/3.978/3.974     pallas
        tiled K=384 bfloat16     1.141/1.145/1.150    1.761/1.767/1.766     pallas
    """
    from ...utils.device import chip_spec

    if not supported(k) or precision.x_dtype == "int8":
        return False
    cap = chip_spec().tiled_f32_max_k
    f32 = (precision.matmul_dtype, precision.x_dtype, precision.state_dtype) == ("float32",) * 3
    return not (f32 and cap is not None and k > cap)


def sweep_split(steps: int, n_out: int, slices: int, k_chunks: int) -> Tuple[int, int]:
    """``(per, slots)`` of K5's pass 1: plan entries a chunk, and partial
    slots (one a chunk, and one an output block for a piece that starts a
    run inside a chunk).  ``slices`` are the 64-wide slices of an output
    block, ``k_chunks`` the K chunks: a fixed rule on the shape, not read
    from the card or the plan.  ``per`` is the largest, up to the mean run
    ``ceil(steps / n_out)``, with ``(steps + n_out (per - 1)) * slices *
    k_chunks >= SWEEP_BLOCKS * per`` (the expected pieces' blocks)."""
    per = -(-steps // max(n_out, 1))
    spare = SWEEP_BLOCKS - n_out * slices * k_chunks
    if spare > 0:
        per = min(per, (steps - n_out) * slices * k_chunks // spare)
    per = max(1, per)
    return per, -(-steps // per) + n_out


def sweep_plan(
    rows: np.ndarray, cols: np.ndarray, n_out_blocks: int, by: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build one sweep's (perm, row_id, col_id) arrays, host-side.

    Sorts the occupied tiles by the OUTPUT block id (``by`` = 'col' for the
    H sweep, 'row' for the W sweep) so output blocks are visited in
    contiguous runs, and appends one ``perm = -1`` sentinel entry per output
    block with no tiles -- the kernel writes zeros there, initialising the
    block without any tile payload.  The arrays are ``nmf_tpu``'s.
    """
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    key = cols if by == "col" else rows
    missing = np.setdiff1d(
        np.arange(n_out_blocks, dtype=np.int32), key, assume_unique=False
    )
    perm = np.concatenate(
        [np.arange(len(key), dtype=np.int32),
         np.full(len(missing), -1, np.int32)]
    )
    rr = np.concatenate([rows, missing if by == "row" else np.zeros_like(missing)])
    cc = np.concatenate([cols, missing if by == "col" else np.zeros_like(missing)])
    order = np.argsort(cc if by == "col" else rr, kind="stable")
    return (
        perm[order],
        rr[order].astype(np.int32),
        cc[order].astype(np.int32),
    )


class SweepLayout(NamedTuple):
    """A sweep plan as the plain version walks it: the real entries (no
    sentinels) and, for each output block, the indices of its entries in
    plan order, padded with ``len(perm)`` (a zero contribution)."""

    perm: torch.Tensor    # (E,) int64 tile index
    rb: torch.Tensor      # (E,) int64 row block
    cb: torch.Tensor      # (E,) int64 column block
    slots: torch.Tensor   # (n_out, depth) int64


def sweep_layout(perm, rb, cb, n_out: int, target: str, device=None) -> SweepLayout:
    """The :class:`SweepLayout` of a plan (arrays or tensors, read on the
    host), on ``device``."""
    perm, rb, cb = (np.asarray(torch.as_tensor(a).cpu(), np.int64) for a in (perm, rb, cb))
    real = perm >= 0
    perm, rb, cb = perm[real], rb[real], cb[real]
    key = cb if target == "h" else rb
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    pos = np.arange(len(key)) - np.searchsorted(sorted_key, sorted_key)
    depth = int(pos.max()) + 1 if len(key) else 1
    slots = np.full((n_out, depth), len(key), np.int64)
    slots[sorted_key, pos] = order
    return SweepLayout(*(torch.from_numpy(a).to(device) for a in (perm, rb, cb, slots)))


def sweep_plain(
    w: torch.Tensor,
    h: torch.Tensor,
    tiles: torch.Tensor,
    layout: SweepLayout,
    eps: float,
    precision: Precision,
    target: str,
    scales: torch.Tensor = None,
) -> torch.Tensor:
    """The plain version of K5: the Pallas kernel's arithmetic in torch ops.

    Gathers ``W_r`` and ``H_c`` for each real entry, forms ``Y`` and
    ``Z = X / max(Y, eps)`` with each operand rounded or split as
    :func:`nmf_tpu_torch.ops.mu.matmul` does under ``precision`` (Z too,
    before the second product), and sums each output block's contributions
    by a dense reduction over its slots: a fixed order, no atomics, the
    same bits on every run.  ``scales`` (per tile) dequantize uint8 codes.
    Returns the (K, Np) or (Mp, K) f32 numerator.
    """
    k = w.shape[1]
    bm, bn = tiles.shape[1:]
    mb, nb = w.shape[0] // bm, h.shape[1] // bn
    wt = w.reshape(mb, bm, k)[layout.rb]                      # (E, bm, K)
    ht = h.reshape(k, nb, bn).permute(1, 0, 2)[layout.cb]     # (E, K, bn)
    x = tiles[layout.perm].to(_F32)
    if scales is not None:
        x = x * scales[layout.perm][:, None, None]
    z = x / eps_clamp(matmul(wt, ht, precision), eps)
    if target == "h":
        contrib = matmul(wt.transpose(1, 2), z, precision)     # (E, K, bn)
    else:
        contrib = matmul(z, ht.transpose(1, 2), precision)     # (E, bm, K)
    contrib = torch.cat([contrib, contrib.new_zeros((1, *contrib.shape[1:]))])
    blocks = contrib[layout.slots].sum(dim=1)
    if target == "h":
        return blocks.permute(1, 0, 2).reshape(k, nb * bn)
    return blocks.reshape(mb * bm, k)


def _check_cuda_operands(w, h, tiles, plan):
    """Dtypes, shapes and layout for K5: returns (mp, np, k, plan length)."""
    if w.dtype not in _STATE_BF16 or h.dtype != w.dtype:
        raise NotImplementedError(
            f"W is {w.dtype} and H {h.dtype}; K5 takes W and H both float32 "
            "or both bfloat16"
        )
    if tiles.dtype not in _X_KIND:
        raise NotImplementedError(
            f"tiles are {tiles.dtype}; K5 takes float32 or bfloat16 tiles "
            "(per-tile uint8 codes take the plain sweep, as in nmf_tpu)"
        )
    _check_2d("w", w)
    _check_2d("h", h)
    if tiles.dim() != 3 or not tiles.is_contiguous():
        raise ValueError(f"tiles must be a contiguous (T, bm, bn) tensor, got {tuple(tiles.shape)}")
    steps = plan[0].shape[0]
    for name, a in zip(("perm", "rb", "cb"), plan):
        if a.dtype != torch.int32 or a.dim() != 1 or a.shape[0] != steps or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor of the plan's length")
    mp, k = w.shape
    np_ = h.shape[1]
    if max(mp * k, k * np_, tiles.numel()) >= 2**31:
        raise ValueError("operands above 2**31 elements are not supported")
    return mp, np_, k, steps


def _sweep(target: str, w, h, tiles, perm, rb, cb, eps, precision):
    name = f"{target}_numerator"
    if tiles.shape[0] == 0:
        # the plan's sentinels would point into an empty payload
        raise ValueError(
            "tiles array is empty: the sweep needs at least one tile "
            "(an all-zero X should keep one zero tile -- see tiles_from_coo)"
        )
    k = w.shape[1]
    bm, bn = tiles.shape[1:]
    if h.shape[0] != k or w.shape[0] % bm or h.shape[1] % bn:
        raise ValueError(
            f"W{tuple(w.shape)} and H{tuple(h.shape)} must share K and be padded "
            f"to the {bm}x{bn} block grid"
        )
    n_out = h.shape[1] // bn if target == "h" else w.shape[0] // bm
    plan = (perm, rb, cb)
    if _on_cpu(w, h, tiles, *plan):
        layout = sweep_layout(*plan, n_out, target)
        return sweep_plain(w, h, tiles, layout, eps, precision, target)
    mp, np_, k, steps = _check_cuda_operands(w, h, tiles, plan)
    if not supported(k):
        # the rank rule of K1/K2 (nmf_tpu fused_mu.py:63), not a path taken
        # on failure; the plan is read on the host
        PLAIN_CALLS[name] += 1
        layout = sweep_layout(*plan, n_out, target, device=w.device)
        return sweep_plain(w, h, tiles, layout, eps, precision, target)
    kc = chunk_width(k)
    edge = bn if target == "h" else bm
    per, slots = sweep_split(steps, n_out, -(-edge // TILE), -(-k // kc))
    part = torch.empty((slots, k, bn) if target == "h" else (slots, bm, k), dtype=_F32,
                       device=w.device)
    out = torch.empty((k, np_) if target == "h" else (mp, k), dtype=_F32, device=w.device)
    lib = _lib()
    fn = lib.nmf_h_sweep if target == "h" else lib.nmf_w_sweep
    rc = fn(
        w.data_ptr(), h.data_ptr(), tiles.data_ptr(), perm.data_ptr(), rb.data_ptr(),
        cb.data_ptr(), part.data_ptr(), out.data_ptr(), mp, np_, k, bm, bn, tiles.shape[0],
        steps, per, kc, float(eps), _STATE_BF16[w.dtype], _X_KIND[tiles.dtype],
        _GEMM[precision.matmul_dtype], _index(w), _stream(w),
    )
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def h_numerator(
    w, h, tiles, perm, rb, cb, eps: float, precision: Precision = Precision(),
) -> torch.Tensor:
    """W^T @ (X / clamp(W@H)) over occupied tiles -> (K, Np) f32.

    ``(perm, rb, cb)`` must come from ``sweep_plan(..., by='col')``; W/H are
    the block-grid-padded factors (``models/sparse_tiled.py`` pads them).
    """
    return _sweep("h", w, h, tiles, perm, rb, cb, eps, precision)


def w_numerator(
    w, h, tiles, perm, rb, cb, eps: float, precision: Precision = Precision(),
) -> torch.Tensor:
    """(X / clamp(W@H)) @ H^T over occupied tiles -> (Mp, K) f32.

    ``(perm, rb, cb)`` must come from ``sweep_plan(..., by='row')``.
    """
    return _sweep("w", w, h, tiles, perm, rb, cb, eps, precision)
