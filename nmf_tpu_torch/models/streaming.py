"""Out-of-core NMF: X streamed from the host in column blocks, double-buffered.

Counterpart of ``nmf_tpu.models.streaming`` for the reference KL-MU family
on one device.  X stays on the host (a NumPy array, a memmap, or a ``.bin``
file, whose column-major payload makes a column block one contiguous read)
and crosses to the device once per iteration, block by block; W, the H
blocks and the (M, K) accumulator stay on the device.

Why one stream of X per iteration suffices (``streaming.py:12-29`` of the
JAX package): H's update for block j reads only X_j and the global
colsum(W), and W's numerator is a sum of block contributions that use the
new H_j, available as soon as block j's H update is done::

    H_j <- H_j * (W^T (X_j / clamp(W H_j))) / colsum(W)        (K1, in full)
    a1  += (X_j / clamp(W H_j_new)) H_j_new^T                  (K2, numerator_only)
    a2  += rowsum(H_j_new)
    W   <- W * (a1 / clamp(a2))                                 (after the sweep)

Only the f32 summation order of W's numerator differs from the in-memory
solve.  The cost check streams X once more, on check iterations only.

Double buffering in PyTorch's idiom: two pinned host staging buffers and two
device buffers, each sized to the widest block in X's storage dtype, and one
copy stream.  Events order the three resources: a block's compute waits for
its copy; a copy into a device buffer waits for the compute that last read
it; the host refills a pinned buffer only once its last copy has finished.
The host gathers each block's columns straight into the pinned buffer while
the card works on the block before.  Nothing else syncs the host: with
``thresh == 0`` no value is read back until a cost pass or the end.

The bytes on the wire are X's storage bytes: f32 (clamped on the card, in
place, after the copy: ``max`` is exact, so the bits are the host clamp's),
bf16 (clamped and cast on the host), or uint8 codes with per-column f32
scales (quantized once on the host by ``quantize_policy_np``; the codes are
kept on the host up to ``NMF_TPU_QCACHE_BYTES``, the scales on the host,
and each block's scales cross beside its codes into the slot's scales
buffer).

Device memory: W + H + the accumulators + two blocks (and two mask blocks,
two blocks' scales) + the kernels' scratch, independent of N (``accelerate``: W and H twice
more, the extrapolated point and the block-start snapshot).

``accelerate=True`` runs the safeguarded Nesterov loop over the same sweep
(:func:`_accel_loop`): a seed cost pass, then a cost pass at every check,
and a rejected block re-streams X ``chunk + 1`` times more.

Every family of the JAX package streams (``streaming.py:192-400`` there):
the KL MU above, through the kernels; the beta MU, whose W denominator is a
GEMM that also sums over blocks, so it carries a second (M, K) accumulator;
the penalized KL MU, whose W penalty joins the epilogue and whose cost adds
it once a pass; HALS, whose H row sweep is column-local and whose W sweep
takes X H^T and H H^T summed over blocks (a (K, K) second accumulator); and
the masked KL MU (``mask=``), whose mask streams beside X in a second pair
of pinned and device buffers under the same events, on the wire as bf16
when X is bf16 and as f32 otherwise (int8 X included), and whose
denominators are GEMMs summed over blocks.  The unobserved entries of X are
zeroed before anything reads them (NaN and Inf too): on the card after the
copy for f32 X, on the host before the cast or quantization for bf16 and
int8 X.  The families other than KL take plain torch ops, as in JAX.
``n_frozen`` puts the first columns of W back after each W epilogue (the
streamed :func:`~nmf_tpu_torch.solve_semi`; MU families), so the KL family
stays on K1, K2 ``numerator_only`` and K3.

:func:`transform_out_of_core` is the inference pass: W fixed, each block
visited once and solved in full by the H-only solve
(:func:`nmf_tpu_torch.solve_h_only`'s step and loop, or with ``mask=`` the
masked H-only solve's) while the next block is copied in, so X crosses the
link once per run.  On the card its blocks replay CUDA graphs kept for the
call (``solver.StreamGraphs``, JAX's per-block program ``_h_only_jit``): a
graph per stream slot and block width, reading X, the mask and int8's
scales in the stream's fixed device buffers, where the width's full check
blocks pass ``solver.MIN_REPLAYS``; a mesh's blocks run eagerly.

``checkpoint_dir`` writes a checkpoint of W, H, the iteration, the cost
history and (``accelerate``) the momentum and the extrapolated pair every
``checkpoint_every`` iterations and at the end, in the ``.bin`` and
``meta.json`` format of :mod:`nmf_tpu_torch.utils.checkpoint` (JAX's, byte
for byte), and with ``resume`` continues from the newest one: a resumed
run gives the bits of the uninterrupted one.  ``live_metrics`` emits each
check (``utils.metrics.emit_live``).

``backend="auto"`` and ``"autotune"`` resolve per block width, for the
solve and the transform (JAX's ``streaming.py:218-228, 1415-1430``): each
distinct width (the full blocks, and a ragged last block, which may resolve
otherwise) takes :func:`nmf_tpu_torch.utils.autotune.resolve_config` on
(M, K, width) once, and its blocks run the chosen step and cost.

``mesh=`` (``streaming.py:402-660, 839-960, 1401-1560`` of the JAX
package) streams onto the ('mr', 'mc') mesh of
:mod:`nmf_tpu_torch.parallel.mesh`: the block width is rounded to a
multiple of the column count, and each rank reads whole columns on the
host and copies to its device only its (M/r, width/c) piece of each block,
so no device holds a whole block.  W's rows, the H pieces and the (M/r, K)
accumulators stay on the rank for the whole run; per block the K-sized
sums cross ranks as in the in-memory sharded step
(:func:`_sharded_block_fns`), and the KL family takes K1 and K2
``numerator_only`` where ``sharded._use_fused`` keeps them at the rank's
piece of a full block (one decision a run, as JAX makes it).  A cost pass
sums the ranks' partials once.  The result holds the global W and H on
every rank (gathered once at the end); the transform's result is global
on every rank too.  A mesh run checkpoints in the port's sharded format
(:func:`~nmf_tpu_torch.utils.checkpoint.save_checkpoint_sharded`), each
rank its own blocks.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Tuple, Union

import numpy as np
import torch

from ..io import binio, native
from ..ops.divergence import beta_partial, kl_divergence
from ..ops.elementwise import eps_clamp
from ..ops.hals import cd_sweep_h, cd_sweep_w
from ..ops.kernels import fused_mu
from ..ops.mu import _beta_ratios, matmul, numerator_w, update_h, update_h_kl_reg
from ..ops.quant import dequantize, quantize_policy_np
from ..utils import checkpoint as ckpt
from ..utils.autotune import resolve_config
from ..utils.config import SolveConfig
from ..utils.device import resolve_device
from ..utils.metrics import emit_live
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
from ..parallel.sharded import (
    _dequant_local,
    _emit_live_origin,
    _use_fused,
    build_sharded_h_solver,
    build_sharded_masked_h_solver,
    hals_update_h_sharded,
    kl_partial,
    masked_kl_partial,
    update_h_sharded,
    update_h_sharded_beta,
    update_h_sharded_masked,
    update_h_sharded_reg,
)
from .masked import masked_h_step_cost, masked_kl, masked_update_h, masked_w_terms
from .nmf import _h_only_step_cost
from .solver import (
    SolveResult,
    StreamGraphs,
    _use_kernels,
    extrapolate,
    run_checked_loop,
    to_state,
)

__all__ = [
    "ArrayColumnSource",
    "BinColumnSource",
    "TransformResult",
    "solve_out_of_core",
    "pick_block_n",
    "transform_out_of_core",
]

_F32 = torch.float32
# Default device-side budget for one streamed X block; two are in flight.
_DEFAULT_BLOCK_BYTES = 256 * 1024 * 1024
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.uint8}
# Edge of the tiles of the host transpose of a .bin block (128 x 128 f32,
# 64 KB a tile, stays in cache; 5x a plain strided copy on one core).
_TRANSPOSE_TILE = 128
# Columns of a block the plain families' ops take at once: their
# block-sized temporaries (W H, the ratios, the cost's terms) stay near
# 16 MiB of f32 each, so that the device holds two blocks and H and little
# more, as on the kernel path.
_PLAIN_CHUNK_BYTES = 16 * 1024 * 1024


def _copy_into(out: np.ndarray, src: np.ndarray) -> None:
    """``src`` into the f32 array ``out``, on torch's intra-op threads where
    torch can view ``src`` (native f32, writeable), else by NumPy."""
    if src.dtype == np.float32 and src.dtype.isnative and src.flags.writeable:
        torch.from_numpy(out).copy_(torch.from_numpy(src))
    else:
        np.copyto(out, src, casting="unsafe")


class ArrayColumnSource:
    """Column-block reader over an in-host-memory array (or np.memmap)."""

    def __init__(self, a):
        if a.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {a.shape}")
        self._a = a
        self.shape = tuple(a.shape)

    def columns(self, j0: int, j1: int) -> np.ndarray:
        return np.ascontiguousarray(self._a[:, j0:j1], dtype=np.float32)

    def columns_into(self, j0: int, j1: int, out: np.ndarray) -> None:
        """Columns [j0, j1) as f32 into ``out`` (rows, j1 - j0): one pass."""
        _copy_into(out, self._a[:, j0:j1])


class BinColumnSource:
    """Column-block reader over a reference-format ``.bin`` file.

    The payload is column-major (nmf.cu:189), so columns [j0, j1) are one
    contiguous span at byte offset ``8 + j0*rows*4``: X never needs to fit
    in host memory either.  The span is read by the native C++ reader
    (:func:`nmf_tpu_torch.io.native.read_columns_native`: one bulk read and
    a cache-blocked transpose, straight into the caller's buffer) when the
    library is built and ``NMF_TPU_NO_NATIVE`` is not ``"1"``, as in JAX
    (``streaming.py:106-113`` there), else by NumPy; both give the same
    bytes, and a short file the same error.  ``native.READS["columns"]``
    counts the native reads.
    """

    def __init__(self, path: Union[str, os.PathLike]):
        self._path = os.fspath(path)
        with open(self._path, "rb") as f:
            rows, cols = binio.read_header(f)
        expected = 8 + rows * cols * 4
        actual = os.path.getsize(self._path)
        if actual < expected:
            raise ValueError(
                f"truncated .bin payload in {self._path}: expected "
                f"{expected} bytes, got {actual}"
            )
        self.shape = (rows, cols)

    def _native(self) -> bool:
        """Whether this read takes the native reader, the file checked to
        hold the span first (the native error would name no column)."""
        return os.environ.get("NMF_TPU_NO_NATIVE") != "1" and native.has_read_columns()

    def _short_read(self, j0: int, count: int, got: int) -> ValueError:
        return ValueError(
            f"short read in {self._path}: wanted {count} words at column "
            f"{j0}, got {got}"
        )

    def _check_span(self, j0: int, j1: int) -> None:
        """The NumPy path's short-read error, before a native read."""
        rows = self.shape[0]
        count = (j1 - j0) * rows
        got = max(0, (os.path.getsize(self._path) - 8 - j0 * rows * 4) // 4)
        if got < count:
            raise self._short_read(j0, count, got)

    def _payload(self, j0: int, j1: int) -> np.ndarray:
        """Columns [j0, j1) as they lie in the file: (j1 - j0, rows)."""
        rows = self.shape[0]
        count = (j1 - j0) * rows
        with open(self._path, "rb") as f:
            f.seek(8 + j0 * rows * 4)
            payload = np.fromfile(f, dtype="<f4", count=count)
        if payload.size != count:
            raise self._short_read(j0, count, payload.size)
        return payload.reshape((j1 - j0, rows))

    def columns(self, j0: int, j1: int) -> np.ndarray:
        if self._native():
            self._check_span(j0, j1)
            return native.read_columns_native(self._path, *self.shape, j0, j1)
        return np.ascontiguousarray(self._payload(j0, j1).T)

    def columns_into(self, j0: int, j1: int, out: np.ndarray) -> None:
        """Columns [j0, j1) as f32 into ``out`` (rows, j1 - j0): read
        natively straight into it, or the payload transposed in tile by
        tile."""
        if self._native() and out.dtype == np.float32 and out.flags.c_contiguous:
            self._check_span(j0, j1)
            native.read_columns_native(self._path, *self.shape, j0, j1, out=out)
            return
        payload, t = self._payload(j0, j1), _TRANSPOSE_TILE
        for c in range(0, payload.shape[0], t):
            for r in range(0, payload.shape[1], t):
                out[r:r + t, c:c + t] = payload[c:c + t, r:r + t].T


def _as_source(x):
    if isinstance(x, (ArrayColumnSource, BinColumnSource)):
        return x
    if isinstance(x, (str, os.PathLike)):
        return BinColumnSource(x)
    return ArrayColumnSource(np.asarray(x))


def pick_block_n(m: int, n: int, block_bytes: int = _DEFAULT_BLOCK_BYTES) -> int:
    """Columns per streamed block: ~block_bytes of f32, lane-aligned (128)
    when the budget allows a whole lane tile.  For very tall X the budget
    wins over alignment: the memory contract (two in-flight blocks) must
    hold even when 128 columns alone would blow it."""
    if n < 1 or m < 1:
        raise ValueError(f"X must be non-empty to stream, got shape ({m}, {n})")
    bn = max(1, block_bytes // (4 * m))
    if bn >= 128:
        bn = (bn // 128) * 128
    return min(n, bn)


def wire_itemsize(x_dtype: str) -> int:
    """Bytes one X element takes on the host-to-device wire."""
    return _WIRE_DTYPES[x_dtype].itemsize


def mask_wire_dtype(x_dtype: str) -> torch.dtype:
    """The dtype a streamed mask takes on the wire: bf16 beside bf16 X
    (lossless for 0/1 masks), f32 beside f32 and int8 X (JAX's
    ``_cast_mask``, ``streaming.py:149-156``)."""
    return torch.bfloat16 if x_dtype == "bfloat16" else torch.float32


def _zero_unobserved(x: torch.Tensor, mask: torch.Tensor) -> None:
    """``x <- where(mask > 0, x, 0)`` in place: the masked prep's invariant
    that unobserved entries, NaN and Inf included, are exact zeros."""
    x.masked_fill_(~(mask > 0), 0.0)


def _host_prep(blk: np.ndarray, eps: float, x_dtype: str, qrows: int = 0, out=None,
               mask=None):
    """The load-time clamp (nmf.cu:211) and the storage cast of an f32 block
    of bf16 or int8 X, on the host so that the wire carries the final bytes
    (``streaming.py:709-733`` of the JAX package; f32 X is clamped on the
    device instead).  With ``mask`` (the block's f32 mask) the unobserved
    entries are zeroed after the clamp and before the cast or quantization,
    which keeps NaN out of the int8 scales.

    Clamps ``blk`` IN PLACE (it is the caller's scratch); bf16: casts it
    into the bf16 tensor ``out`` and returns ``out``; int8: returns the
    uint8 codes and f32 scales of ``quantize_policy_np``.
    """
    t = torch.from_numpy(blk).clamp_min_(eps)   # np.maximum's bits, on torch's threads
    if mask is not None:
        _zero_unobserved(t, torch.from_numpy(mask))
    if x_dtype == "int8":
        return quantize_policy_np(blk, eps, qrows)
    return out.copy_(t)


_NUMBER = re.compile(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\s*")


def _qcache_budget() -> int:
    """The int8 code cache's budget in bytes: ``NMF_TPU_QCACHE_BYTES``, 8 GiB
    by default, any decimal number (``2e9``) taken as an int."""
    raw = os.environ.get("NMF_TPU_QCACHE_BYTES", str(8 * 1024**3))
    if not _NUMBER.fullmatch(raw):
        raise ValueError(
            f"NMF_TPU_QCACHE_BYTES must be a number of bytes, got {raw!r}"
        )
    return int(float(raw))


class _BlockStream:
    """X's column blocks on their way to ``dev``, double-buffered.

    :meth:`sweep` yields ``(idx, x_j)`` for every block in order, ``x_j`` on
    the device in its storage form (an f32 or bf16 tensor, or a ``(uint8
    codes, f32 scales)`` pair), or ``(x_j, mask_j)`` when a ``mask_source``
    streams beside X (``mask_j`` in :func:`mask_wire_dtype`).  A block is
    valid until the caller asks for the next one; the work the caller
    enqueued on the current stream by then is what the buffer's next copy
    waits for.

    On the CPU the staging buffers are the blocks themselves: the same
    loop, with no pinned memory, no stream and no events.
    """

    def __init__(self, source, blocks, dev: torch.device, x_dtype: str,
                 eps: float, qrows: int, qcache_budget: int, mask_source=None, rows=None):
        self.source, self.blocks, self.dev = source, blocks, dev
        self.x_dtype, self.eps, self.qrows = x_dtype, float(eps), qrows
        self.mask_source = mask_source
        self.cuda = dev.type == "cuda"
        # ``rows``: a mesh rank's row span; the host reads whole columns and
        # the wire carries the span only (int8's scales read every row)
        self.m_full = source.shape[0]
        self.rows = (0, self.m_full) if rows is None else tuple(rows)
        self.partial = self.rows != (0, self.m_full)
        self.m = self.rows[1] - self.rows[0]
        width = max(j1 - j0 for j0, j1 in blocks)
        size = self.m * width
        self._host, self._dev = self._buffers(size, _WIRE_DTYPES[x_dtype])
        # bf16 and int8 are made from an f32 gather, a row span is cut from one
        gather = x_dtype != "float32" or self.partial
        self._scratch = np.empty(self.m_full * width, np.float32) if gather else None
        if mask_source is not None:
            self._mhost, self._mdev = self._buffers(size, mask_wire_dtype(x_dtype))
            # a bf16 mask is cast from an f32 gather, which bf16 X's prep
            # reads; a row span is cut from a whole-height one
            cut = x_dtype == "bfloat16" or self.partial
            self._mscratch = np.empty(self.m_full * width, np.float32) if cut else None
        self._next = 0
        if self.cuda:
            self._copy_stream = torch.cuda.Stream(dev)
            self._copied = [torch.cuda.Event() for _ in range(2)]   # copy into slot done
            self._read = [torch.cuda.Event() for _ in range(2)]     # compute on slot done
        # int8: codes quantized once, kept on the host up to the budget
        # (re-quantizing a block beyond it gives the same codes); every
        # block's scales kept on the host (pinned on the card) and copied
        # with its codes into the slot's scales buffer, so a block's scales
        # lie at a fixed address a slot, as its codes do.  A stream holds
        # one mask for its whole life, so codes made from masked blocks
        # stay valid.
        self.qcache = {}
        self.qcache_bytes = 0
        self.qcache_budget = qcache_budget
        self.scales = {}
        self._width = width
        self._sdev = None           # the two slots' scales buffers, made at the first block

    def _buffers(self, size: int, dtype: torch.dtype):
        """Two pinned staging buffers and two device buffers of ``size``
        elements (on the CPU the staging buffers serve as both); a failed
        pinned allocation raises."""
        host = [torch.empty(size, dtype=dtype, pin_memory=self.cuda) for _ in range(2)]
        dev = [torch.empty(size, dtype=dtype, device=self.dev) for _ in range(2)] if self.cuda else host
        return host, dev

    def _view(self, buf, idx: int, m=None):
        j0, j1 = self.blocks[idx]
        m = self.m if m is None else m
        return buf[: m * (j1 - j0)].reshape(m, j1 - j0)

    def _gather(self, idx: int) -> np.ndarray:
        """Block ``idx``'s whole columns, every row, as f32."""
        j0, j1 = self.blocks[idx]
        blk = self._view(self._scratch, idx, self.m_full)
        self.source.columns_into(j0, j1, blk)
        return blk

    def _span(self, a: np.ndarray) -> np.ndarray:
        """The row span of a whole-height block (contiguous: C order)."""
        return a[self.rows[0]:self.rows[1]] if self.partial else a

    def _fill_mask(self, idx: int, slot: int):
        """Host side: block ``idx``'s mask into staging buffer ``slot``;
        returns it as an f32 array for the host prep of bf16 X (the row
        span) and int8 X (every row: the scales read them all)."""
        j0, j1 = self.blocks[idx]
        dst = self._view(self._mhost[slot], idx)
        if self._mscratch is None:   # f32 on the wire, whole height: gathered straight in
            self.mask_source.columns_into(j0, j1, dst.numpy())
            return dst.numpy()
        blk = self._view(self._mscratch, idx, self.m_full)
        self.mask_source.columns_into(j0, j1, blk)
        dst.copy_(torch.from_numpy(self._span(blk)))
        return blk if self.x_dtype == "int8" else self._span(blk)

    def _fill(self, idx: int, slot: int):
        """Host side: block ``idx`` (and its mask) in wire form into staging
        buffer ``slot``; returns the block's new f32 scales (int8, first
        sweep) or None."""
        mask = self._fill_mask(idx, slot) if self.mask_source is not None else None
        dst = self._view(self._host[slot], idx)
        if self.x_dtype == "float32":   # clamped (and masked) on the device after the copy
            if self.partial:
                dst.copy_(torch.from_numpy(self._span(self._gather(idx))))
            else:
                j0, j1 = self.blocks[idx]
                self.source.columns_into(j0, j1, dst.numpy())
            return None
        if self.x_dtype == "bfloat16":
            _host_prep(self._span(self._gather(idx)), self.eps, "bfloat16", out=dst, mask=mask)
            return None
        codes, new_scales = self.qcache.get(idx), None
        if codes is None:
            codes, scales = _host_prep(self._gather(idx), self.eps, "int8", self.qrows, mask=mask)
            codes = np.ascontiguousarray(self._span(codes))
            if idx not in self.scales:
                new_scales = torch.from_numpy(scales)
            if self.qcache_bytes + codes.nbytes <= self.qcache_budget:
                self.qcache[idx] = codes
                self.qcache_bytes += codes.nbytes
        dst.copy_(torch.from_numpy(codes))
        return new_scales

    def _slot_scales(self, idx: int, slot: int) -> torch.Tensor:
        """Block ``idx``'s scales' place in slot ``slot``'s scales buffer:
        per column, or per row block of every row (``(R, width)``),
        contiguous at the buffer's start."""
        shape = self.scales[idx].shape
        if self._sdev is None:
            size = shape.numel() // shape[-1] * self._width
            self._sdev = [torch.empty(size, dtype=_F32, device=self.dev) for _ in range(2)]
        return self._sdev[slot][: shape.numel()].view(shape)

    def _put(self, idx: int) -> int:
        """Stage block ``idx`` and start its copy; returns its slot."""
        slot, self._next = self._next, self._next ^ 1
        if not self.cuda:
            scales = self._fill(idx, slot)
            if scales is not None:
                self.scales[idx] = scales
            if self.x_dtype == "int8":
                self._slot_scales(idx, slot).copy_(self.scales[idx])
            return slot
        self._copied[slot].synchronize()   # the pinned buffers' last copies are done
        scales = self._fill(idx, slot)
        if scales is not None:
            self.scales[idx] = scales.pin_memory()
        pairs = [(self._dev, self._host)]
        if self.mask_source is not None:
            pairs.append((self._mdev, self._mhost))
        # (made on the compute stream, which reads it after the copy)
        s_dev = self._slot_scales(idx, slot) if self.x_dtype == "int8" else None
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._read[slot])
            n = self._view(self._host[slot], idx).numel()
            for dev_bufs, host_bufs in pairs:
                dev_bufs[slot][:n].copy_(host_bufs[slot][:n], non_blocking=True)
            if s_dev is not None:
                s_dev.copy_(self.scales[idx], non_blocking=True)
            self._copied[slot].record(self._copy_stream)
        return slot

    def _ready(self, idx: int, slot: int):
        """Compute side: block ``idx`` once its copy has landed."""
        if self.cuda:
            torch.cuda.current_stream(self.dev).wait_event(self._copied[slot])
        x = self._view(self._dev[slot], idx)
        mask = None if self.mask_source is None else self._view(self._mdev[slot], idx)
        if self.x_dtype == "float32":
            x.clamp_min_(self.eps)    # in place: no third block-sized buffer
            if mask is not None:
                _zero_unobserved(x, mask)
        elif self.x_dtype == "int8":
            x = (x, self._slot_scales(idx, slot))
        return x if mask is None else (x, mask)

    def sweep(self):
        """Yield ``(idx, x_j)`` for every block; the next block is gathered
        on the host while the card runs the caller's work on this one."""
        slot = self._put(0)
        for idx in range(len(self.blocks)):
            yield idx, self._ready(idx, slot)
            if self.cuda:
                self._read[slot].record(torch.cuda.current_stream(self.dev))
            if idx + 1 < len(self.blocks):
                slot = self._put(idx + 1)


def _dense(x_j):
    return dequantize(*x_j) if isinstance(x_j, tuple) else x_j


def _column_chunks(step_acc, cost_block, masked: bool, chunk_step: bool = True):
    """``step_acc`` and ``cost_block`` over a block's columns in chunks of
    ``_PLAIN_CHUNK_BYTES`` of f32 at W's height: the new H is the chunks'
    H joined, the accumulators take one fold a chunk, the cost is the sum
    of the chunks' costs (every family's H update and cost are
    column-separable).  A block within one chunk runs unsplit.  Under
    ``chunk_step=False`` only the cost is chunked: for a step that makes no
    (M, width) temporary, chunks would only multiply its launches."""

    def x_cols(x, c0, c1):
        if isinstance(x, tuple):          # (codes, scales (N,) or (R, N))
            return x[0][:, c0:c1], x[1][..., c0:c1]
        return x[:, c0:c1]

    def cols(d, c0, c1):
        return (x_cols(d[0], c0, c1), d[1][:, c0:c1]) if masked else x_cols(d, c0, c1)

    def spans(w, h_j):
        width = max(1, _PLAIN_CHUNK_BYTES // (4 * w.shape[0]))
        n = h_j.shape[1]
        return [(c, min(c + width, n)) for c in range(0, n, width)]

    def step(w, h_j, x_j, a1, a2):
        parts = spans(w, h_j) if chunk_step else [(0, h_j.shape[1])]
        if len(parts) == 1:
            return step_acc(w, h_j, x_j, a1, a2)
        return torch.cat([step_acc(w, h_j[:, c0:c1], cols(x_j, c0, c1), a1, a2)
                          for c0, c1 in parts], dim=1)

    def cost(w, h_j, x_j):
        parts = spans(w, h_j)
        if len(parts) == 1:
            return cost_block(w, h_j, x_j)
        return torch.sum(torch.stack([cost_block(w, h_j[:, c0:c1], cols(x_j, c0, c1))
                                      for c0, c1 in parts]))

    return step, cost


def _sum_parts(parts) -> torch.Tensor:
    """A cost pass's sum of the block partials, in block order."""
    return torch.sum(torch.stack(parts))


def _penalty_fns(config: SolveConfig):
    """(masked_epilogue, reg_epilogue, cost_extra) of the penalized families
    (``streaming.py:159-190`` of the JAX package): the W epilogues whose
    denominators take the W penalty gradients, and the W penalty a cost
    pass adds once (None without penalties)."""
    eps = config.eps
    l1_w, l2_w = config.l1_w, config.l2_w

    def masked_epilogue(w, a1, a2):
        den = eps_clamp(a2, eps) + l1_w + l2_w * w.to(_F32)
        return (w * (a1 / den)).to(w.dtype)

    def reg_epilogue(w, a1, a2):
        den = eps_clamp(a2, eps)[None, :] + l1_w + l2_w * w.to(_F32)
        return (w * (a1 / den)).to(w.dtype)

    cost_extra = None
    if config.regularized:
        def cost_extra(w):
            wf = w.to(_F32)
            return l1_w * torch.sum(torch.abs(wf)) + 0.5 * l2_w * torch.sum(wf * wf)

    return masked_epilogue, reg_epilogue, cost_extra


def _h_penalty(config: SolveConfig, h_j) -> torch.Tensor:
    """Block j's share of the H penalty in a cost pass."""
    hf = h_j.to(_F32)
    return config.l1_h * torch.sum(torch.abs(hf)) + 0.5 * config.l2_h * torch.sum(hf * hf)


def _block_fns(config: SolveConfig, kernels: bool, masked: bool = False):
    """(step_acc, w_epilogue, cost_block, cost_extra, a2_shape) of the
    config's family (``streaming.py:192-400`` of the JAX package), as plain
    functions.

    ``step_acc(w, h_j, x_j, a1, a2)`` updates H_j and folds block j's W-side
    terms into the accumulators in place; it returns the new H_j.  ``a1`` is
    (M, K) f32; ``a2_shape`` names the second accumulator: "mk" (M, K) for
    the beta and masked families (their W denominators are GEMMs summed
    over blocks), "kk" (K, K) for HALS (H H^T), None for rowsum(H) (K,).
    ``cost_extra`` is the W penalty a cost pass adds once, or None.

    ``kernels`` (the KL family alone): K1 in full, K2 ``numerator_only`` and
    K3, each taking its plain version for CPU tensors; under
    ``kernels=False`` the same family takes plain ops on whole dequantized
    blocks.  Every other family takes plain ops over column chunks
    (:func:`_column_chunks`; HALS chunks only its cost).  Under ``masked``
    the data operand is ``(x_j, mask_j)``.
    """
    eps, prec = config.eps, config.precision
    beta = float(config.beta)
    l1_h, l2_h = config.l1_h, config.l2_h
    # the cost's recon is always true f32 (streaming.py:357-362)
    cost_prec = dataclasses.replace(prec, matmul_dtype="float32")
    masked_epilogue, reg_epilogue, cost_extra = _penalty_fns(config)

    def plain(step_acc, w_epilogue, cost_block, a2_shape, chunk_step=True):
        step_acc, cost_block = _column_chunks(step_acc, cost_block, masked, chunk_step)
        return step_acc, w_epilogue, cost_block, cost_extra, a2_shape

    def kl_epilogue(w, a1, a2):
        # JAX's order w * (a1 / sum), not K2's w * acc / sum
        return (w * (a1 / eps_clamp(a2, eps)[None, :])).to(w.dtype)

    if config.algorithm == "hals":
        # the H row sweep is column-local; W's sweep takes X H^T and H H^T
        # summed over blocks (W^T W is recomputed a block, as in JAX).  The
        # step's temporaries are (K, width) at most, so it takes the whole
        # block; only the cost, which builds W H, runs over chunks
        def step_acc(w, h_j, x_j, a1, a2):
            x_j = _dense(x_j)
            wtx = matmul(w, x_j, prec, transpose_a=True)
            wtw = matmul(w, w, prec, transpose_a=True)
            h_new = cd_sweep_h(h_j, wtx, wtw, eps)
            a1 += matmul(x_j, h_new, prec, transpose_b=True)
            a2 += matmul(h_new, h_new, prec, transpose_b=True)
            return h_new

        def cost_block(w, h_j, x_j):
            return beta_partial(_dense(x_j), w, h_j, 2.0, eps)

        return plain(step_acc, lambda w, a1, a2: cd_sweep_w(w, a1, a2, eps), cost_block, "kk",
                     chunk_step=False)

    if masked:
        # the masked step restated per block: both W-side GEMMs accumulate
        def step_acc(w, h_j, xm_j, a1, a2):
            x_j, m_j = xm_j
            x_j = _dense(x_j)
            h_new = masked_update_h(w, h_j, x_j, m_j, eps, prec, l1_h, l2_h)
            zh, mh = masked_w_terms(w, h_new, x_j, m_j, eps, prec)
            a1 += zh
            a2 += mh
            return h_new

        def cost_block(w, h_j, xm_j):
            x_j, m_j = xm_j
            return masked_kl(_dense(x_j), w, h_j, m_j, eps) + _h_penalty(config, h_j)

        return plain(step_acc, masked_epilogue, cost_block, "mk")

    if beta == 1.0 and config.regularized:
        # the penalty gradients join H's denominator and W's epilogue
        def step_acc(w, h_j, x_j, a1, a2):
            x_j = _dense(x_j)
            h_new = update_h_kl_reg(w, h_j, x_j, eps, prec, l1_h, l2_h)
            a1 += numerator_w(w, h_new, x_j, eps, prec)
            a2 += torch.sum(h_new, dim=1, dtype=_F32)
            return h_new

        def cost_block(w, h_j, x_j):
            return kl_divergence(_dense(x_j), w, h_j, eps) + _h_penalty(config, h_j)

        return plain(step_acc, reg_epilogue, cost_block, None)

    if beta == 1.0 and kernels:
        def step_acc(w, h_j, x_j, a1, a2):
            h_new = fused_mu.update_h_fused(w, h_j, x_j, eps, prec)
            a1 += fused_mu.update_w_fused(w, h_new, x_j, eps, prec, numerator_only=True)
            a2 += torch.sum(h_new, dim=1, dtype=_F32)
            return h_new

        def cost_block(w, h_j, x_j):
            return fused_mu.kl_cost_fused(x_j, w, h_j, eps, cost_prec)

        return step_acc, kl_epilogue, cost_block, cost_extra, None

    if beta == 1.0:
        # the reference the kernels are held against: whole blocks, unsplit
        def step_acc(w, h_j, x_j, a1, a2):
            x_j = _dense(x_j)
            h_new = update_h(w, h_j, x_j, eps, prec)
            a1 += numerator_w(w, h_new, x_j, eps, prec)
            a2 += torch.sum(h_new, dim=1, dtype=_F32)
            return h_new

        def cost_block(w, h_j, x_j):
            return kl_divergence(_dense(x_j), w, h_j, eps)

        return step_acc, kl_epilogue, cost_block, cost_extra, None

    # the beta MU: H_j's update, then both W-side GEMMs of block j
    def step_acc(w, h_j, x_j, a1, a2):
        x_j = _dense(x_j)
        num, den = _beta_ratios(w, h_j, x_j, beta, eps, prec)
        h_num = matmul(w, num, prec, transpose_a=True)
        h_den = eps_clamp(matmul(w, den, prec, transpose_a=True), eps)
        h_new = (h_j * (h_num / h_den)).to(h_j.dtype)
        num, den = _beta_ratios(w, h_new, x_j, beta, eps, prec)
        a1 += matmul(num, h_new, prec, transpose_b=True)
        a2 += matmul(den, h_new, prec, transpose_b=True)
        return h_new

    return plain(step_acc, lambda w, a1, a2: (w * (a1 / eps_clamp(a2, eps))).to(w.dtype),
                 lambda w, h_j, x_j: beta_partial(_dense(x_j), w, h_j, beta, eps), "mk")


def _sharded_block_fns(config: SolveConfig, mesh, fused: bool = False, masked: bool = False):
    """The mesh variant of :func:`_block_fns` (``streaming.py:402-660`` of
    the JAX package), on a rank's (M/r, width/c) piece of each block, and
    the cost pass's sum.

    Per block the H_j update is the in-memory sharded step's H half
    (:mod:`nmf_tpu_torch.parallel.sharded`: its K-sized terms summed over
    'mr'), and the block's W-side terms are summed over 'mc' into the
    row-sharded (M/r, K) accumulators: KL carries (numerator, rowsum), beta
    and masked (numerator, denominator), HALS (X H^T, H H^T).  ``fused``
    (the KL family): the H update on K1 ``numerator_only`` and the W
    numerator K2 ``numerator_only``.  ``cost_block`` is the rank's partial
    (its H penalty divided by the r copies of H); ``total`` sums a pass's
    partials over both axes once, and ``cost_extra`` is the W penalty,
    summed over 'mr'.  int8 X is dequantized block-locally
    (``sharded._dequant_local``)."""
    eps, prec = config.eps, config.precision
    beta = float(config.beta)
    l1_h, l2_h = config.l1_h, config.l2_h
    n_row = axis_size(mesh, ROW_AXIS)
    quant = prec.x_dtype == "int8"
    masked_epilogue, reg_epilogue, cost_extra = _penalty_fns(config)

    def local_x(x):
        return _dequant_local(x, mesh) if quant else x

    def over_mc(t):
        return psum(t, mesh, COL_AXIS)

    if config.algorithm == "hals":
        def step_acc(w, h, x, a1, a2):
            x = local_x(x)
            h_new = hals_update_h_sharded(w, h, x, eps, prec, mesh=mesh)
            a1 += over_mc(matmul(x, h_new, prec, transpose_b=True))
            a2 += over_mc(matmul(h_new, h_new, prec, transpose_b=True))
            return h_new

        def cost_block(w, h, x):
            return beta_partial(local_x(x), w, h, 2.0, eps)

        w_epilogue, a2_shape = (lambda w, a1, a2: cd_sweep_w(w, a1, a2, eps)), "kk"
    elif masked:
        def step_acc(w, h, xm, a1, a2):
            x, mk = local_x(xm[0]), xm[1]
            h_new = update_h_sharded_masked(w, h, x, mk, eps, prec, l1_h, l2_h, mesh=mesh)
            zh, mh = masked_w_terms(w, h_new, x, mk, eps, prec)
            a1 += over_mc(zh)
            a2 += over_mc(mh)
            return h_new

        def cost_block(w, h, xm):
            return masked_kl_partial(local_x(xm[0]), w, h, xm[1], eps) + \
                _h_penalty(config, h) / n_row

        w_epilogue, a2_shape = masked_epilogue, "mk"
    elif beta == 1.0:
        def step_acc(w, h, x, a1, a2):
            x = local_x(x)
            if config.regularized:
                h_new = update_h_sharded_reg(w, h, x, eps, prec, l1_h, l2_h, mesh=mesh)
            else:
                h_new = update_h_sharded(w, h, x, eps, prec, fused, mesh=mesh)
            if fused:
                num = fused_mu.update_w_fused(w, h_new, x, eps, prec, numerator_only=True)
            else:
                num = numerator_w(w, h_new, x, eps, prec)
            a1 += over_mc(num)
            a2 += over_mc(torch.sum(h_new, dim=1, dtype=_F32))
            return h_new

        def cost_block(w, h, x):
            part = kl_partial(local_x(x), w, h, eps)
            return part + _h_penalty(config, h) / n_row if config.regularized else part

        def kl_epilogue(w, a1, a2):
            return (w * (a1 / eps_clamp(a2, eps)[None, :])).to(w.dtype)

        w_epilogue = reg_epilogue if config.regularized else kl_epilogue
        a2_shape = None
    else:
        def step_acc(w, h, x, a1, a2):
            x = local_x(x)
            h_new = update_h_sharded_beta(w, h, x, beta, eps, prec, mesh=mesh)
            num, den = _beta_ratios(w, h_new, x, beta, eps, prec)
            a1 += over_mc(matmul(num, h_new, prec, transpose_b=True))
            a2 += over_mc(matmul(den, h_new, prec, transpose_b=True))
            return h_new

        def cost_block(w, h, x):
            return beta_partial(local_x(x), w, h, beta, eps)

        w_epilogue = lambda w, a1, a2: (w * (a1 / eps_clamp(a2, eps))).to(w.dtype)  # noqa: E731
        a2_shape = "mk"

    extra = None
    if cost_extra is not None:
        def extra(w):
            return psum(cost_extra(w), mesh, ROW_AXIS)

    def total(parts):
        return psum(_sum_parts(parts), mesh, BOTH)

    return step_acc, w_epilogue, cost_block, extra, a2_shape, total


def _mesh_layout(mesh, m: int, n: int, blocks):
    """(rows, local blocks) of this rank: its row span of X and its
    (width / c)-column piece of each block."""
    ri, ci = mesh_coordinate(mesh)
    r, c = axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)
    ml = m // r
    local = []
    for j0, j1 in blocks:
        wl = (j1 - j0) // c
        local.append((j0 + ci * wl, j0 + (ci + 1) * wl))
    return (ri * ml, (ri + 1) * ml), local


def _check_mesh_dims(mesh, m: int, n: int, bn: int) -> int:
    """JAX's divisibility refusal; the block width rounded to shard evenly
    over 'mc' (``streaming.py:839-848``)."""
    r, c = axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)
    if m % r or n % c:
        raise ValueError(
            f"global dims (M={m}, N={n}) must divide the mesh "
            f"{ {ROW_AXIS: r, COL_AXIS: c} }"
        )
    return max(c, (bn // c) * c)


def _gather_blocks_h(h_loc: torch.Tensor, mesh, blocks, local_blocks) -> torch.Tensor:
    """The global (K, N) H on every rank from each rank's pieces of the
    blocks joined in block order: one gather over 'mc', then the columns
    put back in block order."""
    c = axis_size(mesh, COL_AXIS)
    g = gather(h_loc, Placement(mesh, (None, COL_AXIS)))
    if c == 1:
        return g
    n_loc = h_loc.shape[1]
    order = np.empty(g.shape[1], np.int64)
    off = 0
    for (j0, j1), (l0, l1) in zip(blocks, local_blocks):
        wl = l1 - l0
        for q in range(c):
            order[j0 + q * wl: j0 + (q + 1) * wl] = q * n_loc + off + np.arange(wl)
        off += wl
    return g[:, torch.from_numpy(order).to(g.device)].contiguous()


def solve_out_of_core(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    block_n=None,
    checkpoint_dir=None,
    checkpoint_every: int = 100,
    resume: bool = True,
    mesh=None,
    mask=None,
    n_frozen: int = 0,
    device="cuda",
) -> SolveResult:
    """Factorize ``x ~= w @ h`` with X streamed from the host per iteration.

    ``x`` may be a NumPy array or memmap, a path to a reference-format
    ``.bin`` file, or a column source.  Semantics match
    :func:`nmf_tpu_torch.solve` (the same update order, clamp sites and
    convergence rule) and ``nmf_tpu.solve_out_of_core``'s plain loop: a
    cost pass every ``check_every`` iterations and at ``max_iter`` when
    ``track_cost or thresh > 0``, ``rel = |prev - cost| / cost``.

    ``device`` is ``"cuda"`` by default (a CUDA request without a card
    raises) or ``"cpu"``.  ``w`` and ``h`` of the result stay on it; the
    history (NaN-padded to at least one slot) and the scalars are CPU
    tensors, known on the host.

    Every family: KL MU (through K1, K2 ``numerator_only`` and K3 on the
    card), beta MU, penalized KL, HALS, and masked KL with ``mask`` (an
    array, memmap, ``.bin`` path or column source of X's shape, streamed
    beside X; 0 = missing, or real-valued weights).  ``n_frozen`` keeps the
    first columns of W at their clamped initial values (MU families).

    ``checkpoint_dir`` checkpoints every ``checkpoint_every`` iterations and
    at the end (``streaming.py:758-792, 903-981`` of the JAX package: the
    plain loop after any iteration, the accelerated one at its checks),
    and with ``resume`` the run continues from the newest checkpoint there,
    its shapes checked against ``w0``/``h0`` and its config fingerprint
    against ``config``; the saved factors (and the accelerated pair) go in
    unclamped, so the resumed run is the uninterrupted one bit for bit
    (``nmf_tpu`` clamps them again).  X is not checkpointed: it is the
    input.

    ``mesh`` (module docstring): every rank calls with the same inputs and
    ``device`` is not read; the result's W and H are the global factors on
    every rank, and a rank outside the mesh gets None.  A mesh run
    checkpoints each rank's blocks in the sharded format.
    """
    config.validate()
    if config.precision.x_quant_rows and config.backend == "pallas":
        raise NotImplementedError(
            "per-row-block int8 scales (x_quant_rows) take the jnp path — "
            "the fused kernels' scales operand is per-column; drop "
            "backend='pallas' or x_quant_rows"
        )
    if mask is not None and config.beta != 1.0:
        raise NotImplementedError(
            "masked streaming implements the (optionally penalized) KL family"
        )
    if checkpoint_every <= 0:
        raise ValueError("checkpoint_every must be >= 1")
    if n_frozen and config.algorithm == "hals":
        raise NotImplementedError(
            "HALS's in-place W sweep reads columns mid-update; frozen "
            "columns need the MU families (see models.semi)"
        )

    source = _as_source(x)
    m, n = source.shape
    mask_source = None
    if mask is not None:
        mask_source = _as_source(mask)
        if mask_source.shape != (m, n):
            raise ValueError(f"mask shape {mask_source.shape} != X shape {(m, n)}")
    w0 = np.asarray(w0, np.float32)
    h0 = np.asarray(h0, np.float32)
    if (m, n) != (w0.shape[0], h0.shape[1]) or w0.shape[1] != h0.shape[0]:
        raise ValueError(
            f"shape mismatch: X{(m, n)} vs W{w0.shape} @ H{h0.shape}"
        )
    k = w0.shape[1]
    if block_n is not None and int(block_n) < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    bn = int(block_n) if block_n is not None else pick_block_n(m, n)
    if mesh is not None:
        mesh = check_mesh(mesh)
        bn = _check_mesh_dims(mesh, m, n, bn)
    blocks: List[Tuple[int, int]] = [(j, min(j + bn, n)) for j in range(0, n, bn)]
    qcache_budget = _qcache_budget()
    rows, local, emit, layout = None, blocks, emit_live, None
    if mesh is not None:
        if mesh_coordinate(mesh) is None:
            return None
        dev = mesh_device(mesh)
        rows, local = _mesh_layout(mesh, m, n, blocks)
        emit, layout = _emit_live_origin(mesh), f"streamed:{bn}"
    else:
        dev = resolve_device(device)
    m_loc = m if rows is None else rows[1] - rows[0]

    it, converged = 0, False
    hist_list: List[float] = []
    labels: List[int] = []          # the global iteration of each check
    resumed = None
    if checkpoint_dir and resume:
        latest = ckpt.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            if mesh is None:
                resumed = ckpt.load_checkpoint(latest, config)
                want_w, want_h = w0.shape, h0.shape
            else:
                # each rank reads its own blocks: W's rows, H's pieces joined
                resumed = ckpt.load_checkpoint_sharded(latest, mesh, config, layout=layout)
                want_w = (m_loc, k)
                want_h = (k, sum(l1 - l0 for l0, l1 in local))
            if np.shape(resumed.w) != want_w or np.shape(resumed.h) != want_h:
                raise ValueError(
                    f"checkpoint shapes {np.shape(resumed.w)}/{np.shape(resumed.h)} "
                    f"do not match inputs {want_w}/{want_h}"
                )
            w0, h0 = resumed.w, resumed.h
            it, converged = resumed.iteration, resumed.converged
            hist_list = list(resumed.cost_history)
            labels = list(resumed.check_iterations or [])

    def h_pieces(h_arr):
        """The run's H blocks (this rank's pieces on a mesh) of a global H,
        or of a mesh checkpoint's pieces joined in block order."""
        if mesh is not None and resumed is not None:
            cuts = np.cumsum([0] + [l1 - l0 for l0, l1 in local])
            return [h_arr[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        return [h_arr[:, j0:j1] for j0, j1 in local]

    # factors resident on the device for the whole run, clamped once; a
    # resumed run's go in as they were saved (utils.checkpoint's docstring)
    fresh = resumed is None
    if mesh is not None and fresh:
        w0 = w0[rows[0]:rows[1]]
    w = to_state(w0, config, dev, clamp=fresh)
    freeze = None
    if n_frozen:
        # the template columns (models.semi) stream too: put back after
        # every W epilogue, from the prepped W, which nothing writes into
        if not (0 <= int(n_frozen) <= k):
            raise ValueError(f"n_frozen must be in [0, {k}], got {n_frozen}")
        mk = (torch.arange(k, device=dev) < int(n_frozen))[None, :]
        w_frz = w

        def freeze(w_new):
            return torch.where(mk, w_frz, w_new).to(w_new.dtype)

    h_blocks = [to_state(hb, config, dev, clamp=fresh) for hb in h_pieces(h0)]
    masked = mask_source is not None
    block_fns = {}
    total_fn = _sum_parts
    if mesh is not None:
        # one decision for every block, at the rank's piece of a full block
        # (streaming.py:858-872 of the JAX package)
        r, c = axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)
        fused = (config.beta == 1.0 and not config.regularized and not masked
                 and fused_mu.supported(k)
                 and _use_fused(config, m // r, k, max(1, bn // c), dev,
                                config.precision.x_dtype == "int8", "streamed_sharded"))
        *mesh_fns, total_fn = _sharded_block_fns(config, mesh, fused, masked)

    def fns_of(idx: int):
        """The block functions of block idx's width, resolved once a width
        (on a mesh: the one set of the run)."""
        if mesh is not None:
            return mesh_fns
        width = blocks[idx][1] - blocks[idx][0]
        if width not in block_fns:
            cfg = config if masked else resolve_config(config, m, k, width, dev, "streamed")
            block_fns[width] = _block_fns(cfg, _use_kernels(cfg), masked=masked)
        return block_fns[width]

    _, w_epilogue, _, cost_extra, a2_shape = fns_of(0)
    a2_dims = {"mk": (m_loc, k), "kk": (k, k)}.get(a2_shape, (k,))
    prec = config.precision
    stream = _BlockStream(source, local, dev, prec.x_dtype, config.eps,
                          prec.x_quant_rows, qcache_budget, mask_source, rows)

    max_iter = int(config.max_iter)
    check_every = int(config.check_every)
    thresh = float(config.thresh)
    need_cost = config.track_cost or thresh > 0.0

    def sweep(w_src, get_h, set_h):
        """One iteration: one double-buffered sweep over the blocks, reading
        each block's H through ``get_h`` and committing the new one through
        ``set_h`` (``streaming.py:1108-1125`` of the JAX package); the plain
        and the accelerated loops run this one body.  Returns the new W."""
        # the accumulators are made on the device each sweep, not uploaded
        a1 = torch.zeros((m_loc, k), dtype=_F32, device=dev)
        a2 = torch.zeros(a2_dims, dtype=_F32, device=dev)
        for idx, x_j in stream.sweep():
            set_h(idx, fns_of(idx)[0](w_src, get_h(idx), x_j, a1, a2))
        w_new = w_epilogue(w_src, a1, a2)
        return w_new if freeze is None else freeze(w_new)

    def cost_pass(w_c, h_list) -> float:
        """Stream X once more; per-block costs stay on the device, summed in
        block order, and the W penalty added once: one host read per cost
        pass (two with penalties, as JAX reads them)."""
        parts = [fns_of(idx)[2](w_c, h_list[idx], x_j) for idx, x_j in stream.sweep()]
        total = float(total_fn(parts))
        return total if cost_extra is None else total + float(cost_extra(w_c))

    save = None
    if checkpoint_dir:
        def save(it, converged, w_c, h_list, mom=float("nan"), w_ex=None, h_ex=None):
            """A checkpoint of the run so far (``_save`` of the JAX loop): on
            a mesh each rank writes its own blocks (its H pieces joined)."""
            state = ckpt.CheckpointState(
                w=w_c, h=torch.cat(h_list, dim=1), iteration=it, cost_history=hist_list,
                converged=converged, check_iterations=labels, momentum=mom,
                w_ex=w_ex, h_ex=None if h_ex is None else torch.cat(h_ex, dim=1),
            )
            if mesh is None:
                ckpt.save_checkpoint(checkpoint_dir, state, config)
            else:
                ckpt.save_checkpoint_sharded(checkpoint_dir, state, config, mesh=mesh,
                                             layout=layout)

    prev_cost = hist_list[-1] if hist_list else float("nan")
    mom = float("nan")
    if config.accelerate:
        ex = None
        if resumed is not None and resumed.w_ex is not None:
            ex = (to_state(resumed.w_ex, config, dev, clamp=False),
                  [to_state(hb, config, dev, clamp=False) for hb in h_pieces(resumed.h_ex)])
        w, prev_cost, mom, it, converged = _accel_loop(
            config, sweep, cost_pass, w, h_blocks, hist_list, labels, it, converged,
            prev_cost, float("nan") if resumed is None else resumed.momentum, ex,
            save, checkpoint_every, emit)
    else:
        start_iter = it
        while it < max_iter and not converged:
            w = sweep(w, h_blocks.__getitem__, h_blocks.__setitem__)
            it += 1
            if need_cost and (it % check_every == 0 or it == max_iter):
                total = cost_pass(w, h_blocks)
                hist_list.append(total)
                labels.append(it)
                rel = abs(prev_cost - total) / abs(total) if total else float("nan")
                if config.live_metrics:
                    emit(it, total, rel)
                if thresh > 0.0 and rel < thresh:
                    converged = True
                prev_cost = total
            if save is not None and ((it - start_iter) % checkpoint_every == 0
                                     or it == max_iter or converged):
                save(it, converged, w, h_blocks)
    del stream   # the block buffers go before H is joined

    h = torch.cat(h_blocks, dim=1)
    if mesh is not None:   # the global factors on every rank, gathered once
        w = gather(w, Placement(mesh, (ROW_AXIS, None)))
        h = _gather_blocks_h(h, mesh, blocks, local)
    hist = np.full((max(len(hist_list), 1),), np.nan, np.float32)
    hist[: len(hist_list)] = hist_list
    return SolveResult(
        w=w,
        h=h,
        iterations=torch.tensor(it, dtype=torch.int32),
        cost=torch.tensor(prev_cost, dtype=_F32),
        cost_history=torch.from_numpy(hist),
        num_checks=torch.tensor(len(hist_list), dtype=torch.int32),
        converged=torch.tensor(converged, dtype=torch.bool),
        momentum=torch.tensor(mom, dtype=_F32),
    )


def _accel_loop(config: SolveConfig, sweep, cost_pass, w, h_blocks, hist_list, labels,
                it: int, converged: bool, baseline: float, mom: float, ex, save,
                checkpoint_every: int, emit=emit_live):
    """The safeguarded Nesterov-accelerated streamed loop
    (``streaming.py:1152-1262`` of the JAX package): the in-memory
    ``_run_accel_loop`` restated over streamed blocks (on a mesh, a rank's
    pieces of them: ``cost_pass`` gives every rank the same cost, so every
    rank accepts and rejects alike; ``emit`` is the live emitter).

    Each sweep runs from the extrapolated ``(w_ex, h_ex)`` and commits the
    plain iterate; the cost is taken at every check, against ``baseline``
    (a resumed run's last check) or a seed cost pass made up front.  A block
    whose cost rose (or is NaN) restores the block-start snapshot and is
    redone with plain sweeps, and the carry restarts at the iterate.  The
    momentum is a Python float (float64), as in JAX's host loop; ``mom``
    resumes it (NaN: ``config.accel_momentum``) and ``ex``, a ``(w_ex,
    h_ex blocks)`` pair, the carry (None: at the iterate).
    :func:`~nmf_tpu_torch.models.solver.extrapolate` rounds the momentum to
    f32.  The snapshot copies the LIST of H blocks: the sweep replaces list
    entries and never writes a tensor in place, so holding the tensors is
    enough.  ``save`` (or None) is called at a check at least
    ``checkpoint_every`` iterations after the last save, at the end and on
    convergence, with the whole resume state.  Updates ``h_blocks``,
    ``hist_list`` and ``labels`` in place; returns ``(w, cost, momentum,
    iterations, converged)``.
    """
    max_iter = int(config.max_iter)
    check_every = int(config.check_every)
    thresh = float(config.thresh)
    eps = config.eps
    if mom != mom:   # NaN: a fresh run
        mom = float(config.accel_momentum)
    m_hi = float(config.accel_momentum_max)
    grow = float(config.accel_grow)
    shrink = float(config.accel_shrink)
    if baseline != baseline and it < max_iter and not converged:
        baseline = cost_pass(w, h_blocks)
    w_ex, h_ex = (w, list(h_blocks)) if ex is None else (ex[0], list(ex[1]))
    w_snap, h_snap = w, list(h_blocks)
    last_save = it

    def set_h_extrapolated(idx, h_new):
        # commit the plain iterate; the next sweep runs from the
        # extrapolated point (at the momentum of the current block)
        h_ex[idx] = extrapolate(h_new, h_blocks[idx], mom, eps)
        h_blocks[idx] = h_new

    while it < max_iter and not converged:
        chunk = min(check_every, max_iter - it)
        for _ in range(chunk):
            w_new = sweep(w_ex, h_ex.__getitem__, set_h_extrapolated)
            w_ex = extrapolate(w_new, w, mom, eps)
            w = w_new
        it += chunk
        total = cost_pass(w, h_blocks)
        if total <= baseline:
            mom = min(mom * grow, m_hi)
        else:
            w = w_snap
            h_blocks[:] = h_snap
            for _ in range(chunk):
                w = sweep(w, h_blocks.__getitem__, h_blocks.__setitem__)
            total = cost_pass(w, h_blocks)
            w_ex, h_ex[:] = w, h_blocks
            mom = mom * shrink
        w_snap, h_snap = w, list(h_blocks)
        rel = abs(baseline - total) / abs(total) if total else float("nan")
        hist_list.append(total)
        labels.append(it)
        baseline = total
        if config.live_metrics:
            emit(it, total, rel)
        if thresh > 0.0 and rel < thresh:
            converged = True
        if save is not None and (it - last_save >= checkpoint_every or it == max_iter
                                 or converged):
            save(it, converged, w, h_blocks, mom, w_ex, h_ex)
            last_save = it
    return w, baseline, mom, it, converged


def seeded_block_h(seed: int, k: int, width: int, eps) -> np.ndarray:
    """A block's start H: ``RandomState(seed).rand(k, width)`` in f32,
    clamped to eps like every random init (an exact zero is an absorbing
    state under multiplicative updates)."""
    h = np.random.RandomState(seed).rand(k, width).astype(np.float32)
    return np.maximum(h, np.float32(eps))


def upload_state(h: np.ndarray, config: SolveConfig, dev: torch.device) -> torch.Tensor:
    """A host factor cast to the state dtype on ``dev`` without a clamp; on
    the card through pinned memory without blocking, so that the upload
    does not wait for the block that is solving."""
    t = torch.from_numpy(h)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return to_state(t, config, dev, clamp=False)


@dataclasses.dataclass
class TransformResult:
    """Out-of-core H-only result.  ``h`` lives on the host (N may exceed
    device memory); the per-block fields are aligned with ``blocks``."""

    h: np.ndarray                # (K, N) float32
    cost: float                  # total divergence over all columns (NaN if untracked)
    iterations: np.ndarray       # i32 [n_blocks]: solve iterations per block
    converged: np.ndarray        # bool [n_blocks]
    block_costs: np.ndarray      # f32 [n_blocks]
    blocks: List[Tuple[int, int]]


class _Fetch:
    """One block's H (as f32) and cost on their way to the host: copied
    without blocking (into pinned memory on the card), read by
    :meth:`result` once the copy has landed."""

    def __init__(self, res: SolveResult):
        h, cost = res.h.to(_F32), res.cost
        self.iterations, self.converged = int(res.iterations), bool(res.converged)
        if h.device.type == "cuda":
            self.h = torch.empty(h.shape, dtype=_F32, pin_memory=True)
            self.cost = torch.empty((), dtype=_F32, pin_memory=True)
            self.h.copy_(h, non_blocking=True)
            self.cost.copy_(cost, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.h, self.cost, self.done = h, cost, None

    def result(self):
        if self.done is not None:
            self.done.synchronize()
        return self.h.numpy(), float(self.cost), self.iterations, self.converged


def transform_out_of_core(
    x,
    w,
    h0=None,
    config: SolveConfig = SolveConfig(),
    block_n=None,
    mesh=None,
    seed: int = 0,
    mask=None,
    device="cuda",
) -> TransformResult:
    """Solve H against a fixed W with X streamed from the host (inference).

    H's update is column-local, so each block needs one visit: it is copied
    in (double-buffered, as :func:`solve_out_of_core` streams it), solved in
    full by the H-only step and loop of :func:`nmf_tpu_torch.solve_h_only`
    (per-block convergence), and its H copied back while the next block
    solves (``streaming.py:1306-1574`` of the JAX package).

    ``x`` is an array, memmap, ``.bin`` path or column source; ``h0`` an
    optional (K, N) start, sliced per block, else block ``i`` starts from
    ``RandomState(seed + i).rand(K, width)``, clamped to eps.  W is clamped
    to eps in f32, then cast to the state dtype.  ``cost`` is the sum of the
    block costs (divergences are column-separable), NaN when the cost is not
    tracked.  Every H-only family (KL through K1 and K3, beta, penalized,
    HALS), f32, bf16 and int8 X.  ``mask`` (an array, ``.bin`` path or
    column source of X's shape) streams beside X and each block runs the
    masked H-only solve (:func:`~nmf_tpu_torch.solve_masked_h_only`'s step
    and cost: the KL MU family, f32 or bf16 X).  ``device`` as in
    :func:`solve_out_of_core`.  ``mesh``: each block is the sharded H-only
    solve of the ranks' pieces, and the result is global on every rank.
    """
    config.validate()
    if config.live_metrics:
        # per-block restarts of the iteration counter are noise, not signal
        config = dataclasses.replace(config, live_metrics=False)
    if config.precision.x_quant_rows and config.backend == "pallas":
        raise NotImplementedError(
            "per-row-block int8 scales (x_quant_rows) take the jnp path — "
            "the fused kernels' scales operand is per-column; drop "
            "backend='pallas' or x_quant_rows"
        )
    source = _as_source(x)
    m, n = source.shape
    mask_source = None
    if mask is not None:
        if config.beta != 1.0 or config.algorithm != "mu":
            raise NotImplementedError("masked transforms implement the KL (beta=1) MU family")
        if config.precision.x_dtype == "int8":
            raise NotImplementedError("masked transforms take dense f32/bf16 X")
        mask_source = _as_source(mask)
        if mask_source.shape != (m, n):
            raise ValueError(f"mask shape {mask_source.shape} != X shape {(m, n)}")
    w = np.asarray(w, np.float32)
    if w.ndim != 2 or w.shape[0] != m:
        raise ValueError(f"W {w.shape} does not match X {(m, n)}")
    k = w.shape[1]
    if h0 is not None:
        h0 = np.asarray(h0, np.float32)
        if h0.shape != (k, n):
            raise ValueError(f"h0 {h0.shape} must be ({k}, {n})")
    eps = np.float32(config.eps)
    if block_n is not None and int(block_n) < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    bn = int(block_n) if block_n is not None else pick_block_n(m, n)
    if mesh is not None:
        mesh = check_mesh(mesh)
        bn = _check_mesh_dims(mesh, m, n, bn)
    blocks: List[Tuple[int, int]] = [(j, min(j + bn, n)) for j in range(0, n, bn)]
    rows, local, solver = None, blocks, None
    if mesh is not None:
        if mesh_coordinate(mesh) is None:
            return None
        dev = mesh_device(mesh)
        rows, local = _mesh_layout(mesh, m, n, blocks)
        # the sharded H-only solve a block (streaming.py:1497-1560 of JAX):
        # its KL step is the plain numerator, and H is gathered over 'mc'
        solver = (build_sharded_masked_h_solver if mask_source is not None
                  else build_sharded_h_solver)(config, mesh)
    else:
        dev = resolve_device(device)
    step_costs = {}

    def step_cost(idx: int):
        """The H-only step and cost of block idx's width, resolved once a width."""
        width = blocks[idx][1] - blocks[idx][0]
        if width not in step_costs:
            if mask_source is not None:
                step_costs[width] = masked_h_step_cost(config)
            else:
                cfg = resolve_config(config, m, k, width, dev, "transform")
                step_costs[width] = _h_only_step_cost(cfg)
        return step_costs[width]

    # JAX's per-block program, kept for the call: a graph a stream slot and
    # width over the stream's fixed buffers (the mesh's blocks run eagerly)
    widths = [j1 - j0 for j0, j1 in blocks]
    per_block = int(config.max_iter) // int(config.check_every)
    graphs = StreamGraphs({wd: widths.count(wd) * per_block for wd in set(widths)})

    def solve_block(idx, x_j, h_j):
        if solver is None:
            return run_checked_loop(x_j, w_dev, h_j, config, *step_cost(idx), graphs=graphs)
        res = solver(x_j, w_dev, h_j)
        return dataclasses.replace(res, h=gather(res.h, Placement(mesh, (None, COL_AXIS))))

    w_c = np.maximum(w, eps)
    w_dev = to_state(w_c if rows is None else w_c[rows[0]:rows[1]], config, dev, clamp=False)
    prec = config.precision

    def h_start(idx: int) -> torch.Tensor:
        j0, j1 = blocks[idx]
        if h0 is not None:
            h = np.maximum(h0[:, j0:j1], eps)
        else:
            h = seeded_block_h(seed + idx, k, j1 - j0, eps)
        if rows is not None:     # this rank's piece of the block's columns
            l0, l1 = local[idx]
            h = np.ascontiguousarray(h[:, l0 - j0:l1 - j0])
        return upload_state(h, config, dev)

    # one visit a block: the codes are never read twice, so none are cached
    stream = _BlockStream(source, local, dev, prec.x_dtype, config.eps,
                          prec.x_quant_rows, 0, mask_source, rows)
    parts = []
    pending = None
    for idx, x_j in stream.sweep():
        fetch = _Fetch(solve_block(idx, x_j, h_start(idx)))
        if pending is not None:
            parts.append(pending.result())   # block idx - 1, while idx solves
        pending = fetch
    parts.append(pending.result())
    del graphs, stream           # the graphs first: they read the stream's buffers

    h_parts, costs, iters, convs = zip(*parts)
    need_cost = config.track_cost or config.thresh > 0.0
    return TransformResult(
        h=np.concatenate(h_parts, axis=1),
        cost=float(np.sum(costs)) if need_cost else float("nan"),
        iterations=np.asarray(iters, np.int32),
        converged=np.asarray(convs, np.bool_),
        block_costs=np.asarray(costs, np.float32),
        blocks=blocks,
    )
