"""Tile-sparse X: block-sparse KL-NMF that touches only occupied tiles.

Counterpart of ``nmf_tpu.models.sparse_tiled`` on one device.  X is kept as
its occupied (bm, bn) tiles, a dense (T, bm, bn) payload with (T,) row and
column BLOCK indices.  Per occupied tile t at block (i, j), with
W_i = W[i*bm:(i+1)*bm] and H_j = H[:, j*bn:(j+1)*bn]::

    Y_t = W_i @ H_j          Z_t = X_t / clamp(Y_t)
    H-numerator[j] += W_i^T @ Z_t        W-numerator[i] += Z_t @ H_j^T

Unoccupied tiles have X = 0, so Z = 0 there and skipping them is exact: the
solve equals the dense solve with exact zeros (``clamp_inputs=False``), not
the reference's load-time clamp.  The update denominators are the X-free
colsum(W) / rowsum(H), and the KL cost splits as
``sum_tiles(x log x - x log y - x) + colsum(W) . rowsum(H)``.

The numerator sweeps run in kernel K5 (:mod:`nmf_tpu_torch.ops.kernels.tile_sparse`)
on CUDA tensors, or in its plain version (:func:`~nmf_tpu_torch.ops.kernels.tile_sparse.sweep_plain`)
by the route rules of :func:`sweep_route`.  The cost is the JAX scan's math
in torch ops, chunk by chunk.

:func:`solve_sparse_tiled_batched` solves B problems of one shape in one
batched loop: each member's tile list padded with inert zero tiles to a
common count, the plain sweeps member by member (JAX vmaps its XLA scan
here, never its Pallas kernel, so the port launches no K5 there either).

A checkpointed tile-sparse solve runs through
:func:`nmf_tpu_torch.utils.checkpoint.solve_with_checkpoints`, whose
segments are :func:`_run_tiled` calls on the factors prepared once.  Not in
the port yet: the mesh path (ROADMAP.md Queue 1 step 12b).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.elementwise import eps_clamp
from ..ops.kernels import tile_sparse as ts
from ..utils import autotune
from ..utils.config import SolveConfig
from ..utils.convert import to_tensor
from ..utils.device import resolve_device
from ..parallel.batched import per_member_cost, per_member_step, run_batched_loop
from .solver import SolveResult, run_checked_loop

__all__ = [
    "TileSparseX",
    "solve_sparse_tiled",
    "solve_sparse_tiled_batched",
    "sweep_route",
    "tiles_from_coo",
    "tiles_from_dense",
]

_CHUNK = 64      # tiles per cost step, and the multiple the tile list is padded to
_TILE = 128      # default (bm, bn)
_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TileSparseX:
    """Occupied (bm, bn) tiles of X with their block coordinates.

    ``tiles[t]`` (a NumPy array or a tensor) is the dense payload of block
    (rows[t], cols[t]); exact-zero tiles are inert padding.  ``shape`` is the
    LOGICAL (m, n); the block grid covers ceil(m/bm) x ceil(n/bn) with
    zero-padded edges.
    """

    tiles: object      # (T, bm, bn) f32 (or bf16)
    rows: object       # (T,) i32 row-block index
    cols: object       # (T,) i32 col-block index
    shape: Tuple[int, int]

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return tuple(self.tiles.shape[1:])

    def occupancy(self) -> float:
        """Stored fraction of the dense M x N footprint."""
        t, bm, bn = self.tiles.shape
        m, n = self.shape
        return t * bm * bn / float(m * n)


def tiles_from_coo(
    data, rows, cols, shape: Tuple[int, int], tile: Tuple[int, int] = (_TILE, _TILE)
) -> TileSparseX:
    """Bucket COO nonzeros into dense occupied tiles (host-side NumPy; the
    payload stays on the host until the solver places it)."""
    bm, bn = int(tile[0]), int(tile[1])
    m, n = int(shape[0]), int(shape[1])
    data = np.asarray(data, np.float32).ravel()
    rows = np.asarray(rows, np.int64).ravel()
    cols = np.asarray(cols, np.int64).ravel()
    if not (data.shape == rows.shape == cols.shape):
        raise ValueError("data/rows/cols must have identical lengths")
    if data.size and (
        rows.min() < 0 or cols.min() < 0 or rows.max() >= m or cols.max() >= n
    ):
        raise ValueError(f"indices out of bounds for shape {(m, n)}")
    if data.size and data.min() < 0:
        # NMF requires nonnegative data; the dense path's load-time clamp
        # would hide this, but sparse values are used as they are
        raise ValueError(
            f"tile-sparse data must be nonnegative (min {data.min()})"
        )
    nb = -(-n // bn)
    key = (rows // bm) * nb + (cols // bn)
    uniq = np.unique(key)
    t = max(len(uniq), 1)
    tiles = np.zeros((t, bm, bn), np.float32)
    if data.size:
        slot = np.searchsorted(uniq, key)
        # duplicates sum (standard COO semantics)
        np.add.at(tiles, (slot, rows % bm, cols % bn), data)
    trows = (uniq // nb).astype(np.int32) if len(uniq) else np.zeros(1, np.int32)
    tcols = (uniq % nb).astype(np.int32) if len(uniq) else np.zeros(1, np.int32)
    return TileSparseX(tiles=tiles, rows=trows, cols=tcols, shape=(m, n))


def tiles_from_dense(x, tile: Tuple[int, int] = (_TILE, _TILE)) -> TileSparseX:
    """Build a TileSparseX from a dense array's nonzeros."""
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)
    rows, cols = np.nonzero(x)
    return tiles_from_coo(x[rows, cols], rows, cols, x.shape, tile)


def _quantize_tiles_np(tiles, eps: float):
    """Per-TILE uint8 quantization: codes + one f32 scale per tile such that
    ``tile ~= codes * scale``.  All-zero (padding) tiles get scale eps/255
    and all-zero codes, so they dequantize to exact zeros.  Byte for byte
    ``nmf_tpu``'s."""
    tiles = np.asarray(tiles, np.float32)
    tmax = tiles.max(axis=(1, 2))
    scales = (np.maximum(tmax, np.float32(eps)) / np.float32(255.0)).astype(
        np.float32
    )
    v = tiles * (np.float32(1.0) / scales)[:, None, None]
    v += np.float32(0.5)
    np.clip(v, 0, 255, out=v)
    return v.astype(np.uint8), scales


def _pad_tiles_np(tiles, rows, cols, multiple: int):
    """Pad the tile list to a count multiple with zero tiles at block (0,0)."""
    t = tiles.shape[0]
    padded = -(-max(t, 1) // multiple) * multiple
    if padded == t:
        return tiles, rows, cols
    p = padded - t
    return (
        np.concatenate([tiles, np.zeros((p, *tiles.shape[1:]), tiles.dtype)]),
        np.concatenate([rows, np.zeros(p, rows.dtype)]),
        np.concatenate([cols, np.zeros(p, cols.dtype)]),
    )


def _host(a) -> np.ndarray:
    """An index array or tensor as a NumPy array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _validate_hand_built(tx: TileSparseX, mb: int, nb: int) -> None:
    """Boundary checks for a (possibly hand-built) TileSparseX: block ids
    in the grid (element indices would be gathered from the wrong blocks)
    and, for a host-resident payload, no negative values (the updates would
    drift negative or NaN)."""
    m, n = tx.shape
    bm, bn = tx.tile_shape
    rows_chk = _host(tx.rows).astype(np.int64)
    cols_chk = _host(tx.cols).astype(np.int64)
    if rows_chk.size and (
        rows_chk.min() < 0 or cols_chk.min() < 0
        or rows_chk.max() >= mb or cols_chk.max() >= nb
    ):
        raise ValueError(
            f"TileSparseX block ids out of range for the {mb}x{nb} block "
            f"grid (tile {bm}x{bn}, shape {(m, n)}): rows in "
            f"[{rows_chk.min()}, {rows_chk.max()}], cols in "
            f"[{cols_chk.min()}, {cols_chk.max()}] -- ids are BLOCK indices, "
            "not element indices (tiles_from_coo builds them)"
        )
    tiles = tx.tiles
    host = isinstance(tiles, np.ndarray) or (
        isinstance(tiles, torch.Tensor) and tiles.device.type == "cpu"
    )
    if host and tiles.shape[0] and float(tiles.min()) < 0:
        raise ValueError(
            f"TileSparseX tiles contain negative values (min {float(tiles.min()):g}); "
            "NMF requires non-negative data -- the multiplicative updates "
            "would silently drift negative/NaN (f32) or clip to zero (int8)"
        )


def _refuse_unported(config: SolveConfig, mesh) -> None:
    later = {
        "mesh (ROADMAP.md Queue 1 step 12b: the tiled mesh path)": mesh is not None,
    }
    missing = [name for name, on in later.items() if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not in the PyTorch port's tile-sparse solve yet"
        )
    if config.beta != 1.0 or config.regularized or config.algorithm != "mu":
        # nmf_tpu refuses these too (sparse_tiled.py:633-636)
        raise NotImplementedError(
            "tile-sparse solve implements the KL (beta=1) MU family"
        )


def sweep_route(config: SolveConfig, k: int = 0, tile: Tuple[int, int] = (_TILE, _TILE),
                device=None) -> str:
    """Where the numerator sweeps go: ``"k5"`` (the wrappers, which launch
    K5 on CUDA tensors and send K > 2048 to the plain sweep by the rank
    rule) or ``"plain"`` (:func:`sweep_plain` directly).

    ``jnp`` means the plain sweep; int8 tiles (per-tile uint8 codes) take it
    under every backend, as in ``nmf_tpu``, since the kernel has no uint8
    mode.  ``pallas`` means K5.  ``auto`` and ``autotune`` consult
    :func:`~nmf_tpu_torch.ops.kernels.tile_sparse.preferred` at rank ``k``
    and ``tile`` for a CUDA ``device`` (JAX's ``sparse_tiled.py:747-755``
    consults its rule on a TPU); for CPU tensors (``device`` None or the
    CPU) they mean K5's wrappers, which take the plain sweep there.  A
    choice on CUDA is counted in ``autotune.CHOICES`` under ``"tiled"``.
    """
    if config.precision.x_dtype == "int8" or config.backend == "jnp":
        return "plain"
    if config.backend == "pallas" or device is None or torch.device(device).type != "cuda":
        return "k5"
    choice = "pallas" if ts.preferred(k, *tile, config.precision) else "jnp"
    autotune.CHOICES[("tiled", choice)] += 1
    return "k5" if choice == "pallas" else "plain"


def _shape(a) -> Tuple[int, ...]:
    return tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))


def _prepare_tiled(x, w0, h0, config: SolveConfig, chunk: int, tile, dev, pad_to=None):
    """One-time preparation: tile bucketing, chunk padding (to a multiple
    of ``pad_to`` where given), per-tile quantization, factor padding and
    clamp, the sweep plans, and one upload of each to ``dev``.  Returns
    ``(xarg, w, h, info)``."""
    tx = x if isinstance(x, TileSparseX) else tiles_from_dense(x, tile)
    m, n = tx.shape
    bm, bn = tx.tile_shape
    shape_w, shape_h = _shape(w0), _shape(h0)
    if (m, n) != (shape_w[0], shape_h[1]) or shape_w[1] != shape_h[0]:
        raise ValueError(
            f"shape mismatch: X{(m, n)} vs W{shape_w} @ H{shape_h}"
        )
    k = shape_w[1]
    mb, nb = -(-m // bm), -(-n // bn)
    _validate_hand_built(tx, mb, nb)
    mp, np_ = mb * bm, nb * bn
    prec = config.precision
    sd = _DTYPES[prec.state_dtype]
    eps = float(config.eps)

    # W and H clamped in f32 and then cast to the state dtype (not the dense
    # path's clamp in the state dtype).  In a ragged problem only the logical
    # region is clamped: the padded W rows and H columns are exactly zero,
    # see zero numerators and stay zero, and add nothing to any sum.
    w_pad = torch.zeros((mp, k), dtype=_F32)
    h_pad = torch.zeros((k, np_), dtype=_F32)
    w_pad[:m] = torch.clamp_min(to_tensor(w0, "cpu").to(_F32), eps)
    h_pad[:, :n] = torch.clamp_min(to_tensor(h0, "cpu").to(_F32), eps)

    # the tile list padded to a multiple of chunk with zero tiles at block
    # (0, 0), on every route, so the tile list is nmf_tpu's
    tiles = to_tensor(tx.tiles, "cpu")   # f32, or bf16 bit for bit
    rows = _host(tx.rows).astype(np.int32)
    cols = _host(tx.cols).astype(np.int32)
    pad_to = pad_to or chunk
    if tiles.shape[0] % pad_to:
        t_np, rows, cols = _pad_tiles_np(tiles.to(_F32).numpy(), rows, cols, pad_to)
        tiles = torch.from_numpy(t_np)
    scales = None
    if prec.x_dtype == "int8":
        codes, scales = _quantize_tiles_np(tiles.to(_F32).numpy(), eps)
        tiles, scales = torch.from_numpy(codes).to(dev), torch.from_numpy(scales).to(dev)
    else:
        tiles = tiles.to(_DTYPES[prec.x_dtype]).contiguous().to(dev)
    tx_dev = TileSparseX(
        tiles=tiles,
        rows=torch.from_numpy(rows).to(dev),
        cols=torch.from_numpy(cols).to(dev),
        shape=(mp, np_),
    )
    # the sweep plans: host-side index metadata, built and uploaded once
    plan_h = ts.sweep_plan(rows, cols, nb, "col")
    plan_w = ts.sweep_plan(rows, cols, mb, "row")
    route = sweep_route(config, k, (bm, bn), dev)
    if route == "k5":
        xarg = (
            tx_dev,
            tuple(torch.from_numpy(a).to(dev) for a in plan_h),
            tuple(torch.from_numpy(a).to(dev) for a in plan_w),
        )
    else:
        xarg = (
            tx_dev,
            ts.sweep_layout(*plan_h, nb, "h", device=dev),
            ts.sweep_layout(*plan_w, mb, "w", device=dev),
            scales,
        )
    info = dict(m=m, n=n, mp=mp, np_=np_, route=route, chunk=chunk)
    return xarg, w_pad.to(sd).to(dev), h_pad.to(sd).to(dev), info


def _tiled_fns(config: SolveConfig, chunk: int, route: str):
    """(step, cost) of the tile-sparse solve on the route's payload."""
    eps = config.eps
    prec = config.precision

    if route == "k5":

        def numerator(target, w, h, xarg):
            tx, plan_h, plan_w = xarg
            fn, plan = (ts.h_numerator, plan_h) if target == "h" else (ts.w_numerator, plan_w)
            return fn(w, h, tx.tiles, *plan, eps, prec)

    else:

        def numerator(target, w, h, xarg):
            tx, lay_h, lay_w, scales = xarg
            lay = lay_h if target == "h" else lay_w
            return ts.sweep_plain(w, h, tx.tiles, lay, eps, prec, target, scales)

    def step(w, h, xarg):
        """One full MU iteration in reference order (H half, then W half
        with the new H), in the JAX tiled step's order on the f32
        numerator: ``h * (numer / sum_w)``, not K1's ``h * acc / sum``."""
        numer = numerator("h", w, h, xarg)
        sum_w = eps_clamp(torch.sum(w, dim=0, dtype=_F32), eps)
        h = (h * (numer / sum_w[:, None])).to(h.dtype)

        numer = numerator("w", w, h, xarg)
        sum_h = eps_clamp(torch.sum(h, dim=1, dtype=_F32), eps)
        w = (w * (numer / sum_h[None, :])).to(w.dtype)
        return w, h

    def cost(xarg, w, h):
        """KL with the x -> 0 limit at zeros: the '+y' mass of the whole
        matrix is colsum(W) . rowsum(H); occupied tiles add
        x * log(x / y) - x, summed chunk by chunk as the JAX scan does, with
        a true f32 recon."""
        tx = xarg[0]
        scales = xarg[3] if route == "plain" else None
        k = w.shape[1]
        bm, bn = tx.tiles.shape[1:]
        mb, nb = w.shape[0] // bm, h.shape[1] // bn
        wb = w.reshape(mb, bm, k).to(_F32)
        hb = h.reshape(k, nb, bn).permute(1, 0, 2).to(_F32)
        x_part = torch.zeros((), dtype=_F32, device=w.device)
        for c0 in range(0, tx.tiles.shape[0], chunk):
            r, c = tx.rows[c0:c0 + chunk].long(), tx.cols[c0:c0 + chunk].long()
            y = eps_clamp(torch.bmm(wb[r], hb[c]), eps)
            tf = tx.tiles[c0:c0 + chunk].to(_F32)
            if scales is not None:
                tf = tf * scales[c0:c0 + chunk][:, None, None]
            term = torch.where(
                tf > 0, tf * (torch.log(torch.clamp_min(tf, eps)) - torch.log(y)) - tf, 0.0
            )
            x_part = x_part + torch.sum(term)
        total_y = torch.dot(torch.sum(w, dim=0, dtype=_F32), torch.sum(h, dim=1, dtype=_F32))
        return x_part + total_y

    return step, cost


def solve_sparse_tiled(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    chunk: int = _CHUNK,
    tile: Tuple[int, int] = (_TILE, _TILE),
    mesh=None,
    initial_cost: float = float("nan"),
    device="cuda",
) -> SolveResult:
    """Factorize a tile-sparse X (a :class:`TileSparseX`, or anything dense
    whose nonzeros define one).  Zero entries are exact zeros (module
    docstring); W and H are dense; compute scales with the occupied tiles.

    ``precision.x_dtype='int8'`` stores the tiles as uint8 codes with
    per-tile f32 scales (each tile's own max/510 error bound), swept by the
    plain version.  ``initial_cost`` seeds the convergence baseline.  The
    inputs go to ``device`` (``"cuda"`` by default; a CUDA request without
    a card raises).  ``accelerate=True`` runs the accelerated loop on the
    PADDED factors, as ``nmf_tpu`` does: its eps clamp lifts the padded W
    rows and H columns of the extrapolated point from 0 to eps, so on a
    ragged problem they enter the next step's sums (by O(pad * eps)); they
    see zero numerators, so the iterate's padding stays 0.
    ``live_metrics`` emits each check, as the dense solve does.
    ``backend="auto"`` and ``"autotune"`` take :func:`sweep_route`'s rule.
    Refused with ``NotImplementedError``: ``mesh``, ``beta != 1``,
    penalties and ``algorithm != 'mu'``.
    """
    config.validate()
    _refuse_unported(config, mesh)
    dev = resolve_device(device)
    xarg, w, h, info = _prepare_tiled(x, w0, h0, config, int(chunk), tile, dev)
    return _crop_tiled(_run_tiled(xarg, w, h, config, info, initial_cost), info)


def _run_tiled(xarg, w, h, config: SolveConfig, info, initial_cost=float("nan"),
               initial_momentum: float = float("nan"), initial_extrap=None) -> SolveResult:
    """One solve (or one segment of a checkpointed one) on the prepared
    payload and the PADDED factors of :func:`_prepare_tiled`
    (``sparse_tiled.py:782-817`` of the JAX package).  ``initial_momentum``
    and ``initial_extrap`` (padded like the factors) resume the accelerated
    loop's state, as the dense solve's parameters do; the result stays
    padded (:func:`_crop_tiled`)."""
    step, cost = _tiled_fns(config, info["chunk"], info["route"])
    c0 = None if np.isnan(initial_cost) else initial_cost
    return run_checked_loop(xarg, w, h, config, step, cost, c0,
                            float(initial_momentum), initial_extrap)


def _crop_tiled(res: SolveResult, info) -> SolveResult:
    """De-pad the factors to the logical shape."""
    if (info["mp"], info["np_"]) != (info["m"], info["n"]):
        return dataclasses.replace(
            res,
            w=res.w[: info["m"]].contiguous(),
            h=res.h[:, : info["n"]].contiguous(),
        )
    return res


def solve_sparse_tiled_batched(
    xs,
    w0s,
    h0s,
    config: SolveConfig = SolveConfig(),
    chunk: int = _CHUNK,
    tile: Tuple[int, int] = (_TILE, _TILE),
    device="cuda",
) -> SolveResult:
    """B independent tile-sparse factorizations in one batched loop
    (``nmf_tpu/models/sparse_tiled.py:866-985``).

    ``xs`` is a sequence of problems (TileSparseX or dense-like) of one
    logical and tile shape; ``w0s``/``h0s`` are ``(B, M, K)`` / ``(B, K,
    N)``.  Member tile lists are padded with inert zero tiles to a common
    count that is a multiple of ``chunk``, and the plain sweeps run member
    by member (module docstring).  Returns the batched
    :class:`SolveResult` (member axis first), with the batched solver's
    per-member convergence.  ``backend="pallas"`` is refused, as in JAX.
    """
    config.validate()
    if config.live_metrics:
        # as the dense batched solve: per-member streams are noise
        config = dataclasses.replace(config, live_metrics=False)
    if config.beta != 1.0 or config.regularized or config.algorithm != "mu":
        raise NotImplementedError("tile-sparse solve implements the KL (beta=1) MU family")
    if config.backend == "pallas":
        raise NotImplementedError(
            "the batched tile-sparse solve runs the vmapped XLA scan (the "
            "Pallas scalar-prefetch kernels are single-problem); drop "
            "backend='pallas' or batch"
        )
    _refuse_unported(config, None)
    txs = [x if isinstance(x, TileSparseX) else tiles_from_dense(x, tile) for x in xs]
    if not txs:
        raise ValueError("xs must be non-empty")
    shape, tshape = txs[0].shape, txs[0].tile_shape
    if any(t.shape != shape or t.tile_shape != tshape for t in txs):
        raise ValueError("all members must share one logical and tile shape")
    w0s = np.asarray(w0s.detach().cpu() if isinstance(w0s, torch.Tensor) else w0s, np.float32)
    h0s = np.asarray(h0s.detach().cpu() if isinstance(h0s, torch.Tensor) else h0s, np.float32)
    b, (m, n) = len(txs), shape
    if w0s.ndim != 3 or h0s.ndim != 3:
        raise ValueError(
            "solve_sparse_tiled_batched expects 3-D [batch, rows, cols] "
            f"factors, got W{w0s.shape} H{h0s.shape}"
        )
    k = w0s.shape[2]
    if w0s.shape != (b, m, k) or h0s.shape != (b, k, n):
        raise ValueError(
            f"member shapes disagree: {b} problems of X{shape} vs "
            f"W{w0s.shape} @ H{h0s.shape}"
        )
    mb, nb = -(-m // tshape[0]), -(-n // tshape[1])
    for t in txs:
        _validate_hand_built(t, mb, nb)
    t_max = max(max(int(t.tiles.shape[0]) for t in txs), 1)
    t_max = -(-t_max // int(chunk)) * int(chunk)
    dev = resolve_device(device)
    plain = dataclasses.replace(config, backend="jnp")   # the plain sweeps
    preps = [_prepare_tiled(t, w0s[i], h0s[i], plain, int(chunk), tile, dev, pad_to=t_max)
             for i, t in enumerate(txs)]
    step, cost = _tiled_fns(plain, int(chunk), "plain")
    res = run_batched_loop([p[0] for p in preps], torch.stack([p[1] for p in preps]),
                           torch.stack([p[2] for p in preps]), config,
                           per_member_step(step), per_member_cost(cost))
    info = preps[0][3]
    if (info["mp"], info["np_"]) != (m, n):
        res = dataclasses.replace(res, w=res.w[:, :m].contiguous(), h=res.h[:, :, :n].contiguous())
    return res
