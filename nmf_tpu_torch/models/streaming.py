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
kept on the host up to ``NMF_TPU_QCACHE_BYTES``, the scales on the card).

Device memory: W + H + the accumulators + two blocks + the kernels'
scratch, independent of N (``accelerate``: W and H twice more, the
extrapolated point and the block-start snapshot).

``accelerate=True`` runs the safeguarded Nesterov loop over the same sweep
(:func:`_accel_loop`): a seed cost pass, then a cost pass at every check,
and a rejected block re-streams X ``chunk + 1`` times more.

:func:`transform_out_of_core` is the inference pass: W fixed, each block
visited once and solved in full by the H-only solve
(:func:`nmf_tpu_torch.solve_h_only`'s step and loop) while the next block is
copied in, so X crosses the link once per run.

Not ported yet, and refused with ``NotImplementedError`` naming its
ROADMAP.md item: ``mesh``, ``mask``, ``n_frozen``, ``checkpoint_dir``,
``live_metrics``, the beta, penalized and HALS families of the streamed
solve (the transform takes them), ``backend="autotune"``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Tuple, Union

import numpy as np
import torch

from ..io import binio
from ..ops.divergence import kl_divergence
from ..ops.elementwise import eps_clamp
from ..ops.kernels import fused_mu
from ..ops.mu import numerator_w, update_h
from ..ops.quant import dequantize, quantize_policy_np
from ..utils.config import SolveConfig
from ..utils.device import resolve_device
from .nmf import _h_only_step_cost
from .solver import SolveResult, _use_kernels, extrapolate, run_checked_loop, to_state
from .solver import _refuse_unported as _refuse_solver

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
    in host memory either.  The NumPy read only (the ``native`` fast path
    of the JAX package is not ported).
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

    def _payload(self, j0: int, j1: int) -> np.ndarray:
        """Columns [j0, j1) as they lie in the file: (j1 - j0, rows)."""
        rows = self.shape[0]
        count = (j1 - j0) * rows
        with open(self._path, "rb") as f:
            f.seek(8 + j0 * rows * 4)
            payload = np.fromfile(f, dtype="<f4", count=count)
        if payload.size != count:
            raise ValueError(
                f"short read in {self._path}: wanted {count} words at column "
                f"{j0}, got {payload.size}"
            )
        return payload.reshape((j1 - j0, rows))

    def columns(self, j0: int, j1: int) -> np.ndarray:
        return np.ascontiguousarray(self._payload(j0, j1).T)

    def columns_into(self, j0: int, j1: int, out: np.ndarray) -> None:
        """The payload transposed into ``out`` tile by tile."""
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


def _host_prep(blk: np.ndarray, eps: float, x_dtype: str, qrows: int = 0, out=None):
    """The load-time clamp (nmf.cu:211) and the storage cast of an f32 block
    of bf16 or int8 X, on the host so that the wire carries the final bytes
    (``streaming.py:709-733`` of the JAX package, without the mask; f32 X is
    clamped on the device instead).

    Clamps ``blk`` IN PLACE (it is the caller's scratch); bf16: casts it
    into the bf16 tensor ``out`` and returns ``out``; int8: returns the
    uint8 codes and f32 scales of ``quantize_policy_np``.
    """
    torch.from_numpy(blk).clamp_min_(eps)   # np.maximum's bits, on torch's threads
    if x_dtype == "int8":
        return quantize_policy_np(blk, eps, qrows)
    return out.copy_(torch.from_numpy(blk))


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
    codes, f32 scales)`` pair).  A block is valid until the caller asks for
    the next one; the work the caller enqueued on the current stream by
    then is what the buffer's next copy waits for.

    On the CPU the staging buffers are the blocks themselves: the same
    loop, with no pinned memory, no stream and no events.
    """

    def __init__(self, source, blocks, dev: torch.device, x_dtype: str,
                 eps: float, qrows: int, qcache_budget: int):
        self.source, self.blocks, self.dev = source, blocks, dev
        self.x_dtype, self.eps, self.qrows = x_dtype, float(eps), qrows
        self.cuda = dev.type == "cuda"
        m = source.shape[0]
        size = m * max(j1 - j0 for j0, j1 in blocks)
        wire = _WIRE_DTYPES[x_dtype]
        # pinned staging; a failed pinned allocation raises
        self._host = [torch.empty(size, dtype=wire, pin_memory=self.cuda) for _ in range(2)]
        self._dev = ([torch.empty(size, dtype=wire, device=dev) for _ in range(2)]
                     if self.cuda else self._host)
        # bf16 and int8 are made from an f32 gather
        self._scratch = None if x_dtype == "float32" else np.empty(size, np.float32)
        self._next = 0
        if self.cuda:
            self._copy_stream = torch.cuda.Stream(dev)
            self._copied = [torch.cuda.Event() for _ in range(2)]   # copy into slot done
            self._read = [torch.cuda.Event() for _ in range(2)]     # compute on slot done
        # int8: codes quantized once, kept on the host up to the budget
        # (re-quantizing a block beyond it gives the same codes); the
        # per-column scales always on the device
        self.qcache = {}
        self.qcache_bytes = 0
        self.qcache_budget = qcache_budget
        self.scales = {}

    def _view(self, buf: torch.Tensor, idx: int) -> torch.Tensor:
        j0, j1 = self.blocks[idx]
        m = self.source.shape[0]
        return buf[: m * (j1 - j0)].view(m, j1 - j0)

    def _gather(self, idx: int) -> np.ndarray:
        j0, j1 = self.blocks[idx]
        blk = self._scratch[: self.source.shape[0] * (j1 - j0)].reshape(-1, j1 - j0)
        self.source.columns_into(j0, j1, blk)
        return blk

    def _fill(self, idx: int, slot: int):
        """Host side: block ``idx`` in its wire form into staging buffer
        ``slot``; returns the block's new f32 scales (int8, first sweep) or
        None."""
        dst = self._view(self._host[slot], idx)
        if self.x_dtype == "float32":   # clamped on the device after the copy
            j0, j1 = self.blocks[idx]
            self.source.columns_into(j0, j1, dst.numpy())
            return None
        if self.x_dtype == "bfloat16":
            _host_prep(self._gather(idx), self.eps, "bfloat16", out=dst)
            return None
        codes, new_scales = self.qcache.get(idx), None
        if codes is None:
            codes, scales = _host_prep(self._gather(idx), self.eps, "int8", self.qrows)
            if idx not in self.scales:
                new_scales = torch.from_numpy(scales)
            if self.qcache_bytes + codes.nbytes <= self.qcache_budget:
                self.qcache[idx] = codes
                self.qcache_bytes += codes.nbytes
        dst.copy_(torch.from_numpy(codes))
        return new_scales

    def _put(self, idx: int) -> int:
        """Stage block ``idx`` and start its copy; returns its slot."""
        slot, self._next = self._next, self._next ^ 1
        if not self.cuda:
            scales = self._fill(idx, slot)
            if scales is not None:
                self.scales[idx] = scales
            return slot
        self._copied[slot].synchronize()   # the pinned buffer's last copy is done
        scales = self._fill(idx, slot)
        if scales is not None:
            # allocated on the compute stream, which reads it after the copy
            self.scales[idx] = torch.empty(scales.shape, dtype=_F32, device=self.dev)
            scales = scales.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._read[slot])
            n = self._view(self._host[slot], idx).numel()
            self._dev[slot][:n].copy_(self._host[slot][:n], non_blocking=True)
            if scales is not None:
                self.scales[idx].copy_(scales, non_blocking=True)
            self._copied[slot].record(self._copy_stream)
        return slot

    def _ready(self, idx: int, slot: int):
        """Compute side: block ``idx`` once its copy has landed."""
        if self.cuda:
            torch.cuda.current_stream(self.dev).wait_event(self._copied[slot])
        x = self._view(self._dev[slot], idx)
        if self.x_dtype == "float32":
            x.clamp_min_(self.eps)    # in place: no third block-sized buffer
        elif self.x_dtype == "int8":
            x = (x, self.scales[idx])
        return x

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


def _block_fns(config: SolveConfig, kernels: bool):
    """(step_acc, w_epilogue, cost_block) of the KL family
    (``streaming.py:330-364`` of the JAX package), as plain functions.

    ``kernels``: K1 in full, K2 ``numerator_only`` and K3 (each takes its
    plain version for CPU tensors); otherwise the plain ops on dequantized X.
    """
    eps, prec = config.eps, config.precision
    # the cost's recon is always true f32 (streaming.py:357-362)
    cost_prec = dataclasses.replace(prec, matmul_dtype="float32")

    def step_acc(w, h_j, x_j, a1, a2):
        """H_j's full update; block j's W numerator and rowsum(H_j) folded
        into ``a1`` and ``a2`` in place.  Returns the new H_j."""
        if kernels:
            h_new = fused_mu.update_h_fused(w, h_j, x_j, eps, prec)
            wnum = fused_mu.update_w_fused(w, h_new, x_j, eps, prec, numerator_only=True)
        else:
            x_j = _dense(x_j)
            h_new = update_h(w, h_j, x_j, eps, prec)
            wnum = numerator_w(w, h_new, x_j, eps, prec)
        a1 += wnum
        a2 += torch.sum(h_new, dim=1, dtype=_F32)
        return h_new

    def w_epilogue(w, a1, a2):
        # JAX's order w * (a1 / sum), not K2's w * acc / sum
        return (w * (a1 / eps_clamp(a2, eps)[None, :])).to(w.dtype)

    def cost_block(w, h_j, x_j):
        if kernels:
            return fused_mu.kl_cost_fused(x_j, w, h_j, eps, cost_prec)
        return kl_divergence(_dense(x_j), w, h_j, eps)

    return step_acc, w_epilogue, cost_block


def _refuse_unported(config: SolveConfig, mesh, mask, n_frozen, checkpoint_dir) -> None:
    later = {
        "mesh (ROADMAP.md Queue 1 item 12: sharded solves)": mesh is not None,
        "mask (ROADMAP.md Queue 1 item 8: masked streaming)": mask is not None,
        "n_frozen (ROADMAP.md Queue 1 item 8: semi-adaptive streaming)": bool(n_frozen),
        "checkpoint_dir (ROADMAP.md Queue 1 item 13: checkpoint/resume)": bool(checkpoint_dir),
        "live_metrics=True (ROADMAP.md Queue 1 item 13: live metrics)": config.live_metrics,
        f"beta={config.beta} (ROADMAP.md Queue 1 step 6, item 8c: beta streaming)":
            config.beta != 1.0,
        f"algorithm={config.algorithm!r} (ROADMAP.md Queue 1 step 6, item 8c: HALS streaming)":
            config.algorithm != "mu",
        "L1/L2 penalties (ROADMAP.md Queue 1 step 6, item 8c: penalized streaming)":
            config.regularized,
        "backend='autotune' (ROADMAP.md Queue 1 item 7: autotune)": config.backend == "autotune",
    }
    missing = [name for name, on in later.items() if on]
    if missing:
        raise NotImplementedError(
            f"solve_out_of_core: {', '.join(missing)} not in the PyTorch port yet"
        )


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
    """
    config.validate()
    if config.precision.x_quant_rows and config.backend == "pallas":
        raise NotImplementedError(
            "per-row-block int8 scales (x_quant_rows) take the jnp path — "
            "the fused kernels' scales operand is per-column; drop "
            "backend='pallas' or x_quant_rows"
        )
    _refuse_unported(config, mesh, mask, n_frozen, checkpoint_dir)
    if checkpoint_every <= 0:
        raise ValueError("checkpoint_every must be >= 1")
    kernels = _use_kernels(config)

    source = _as_source(x)
    m, n = source.shape
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
    blocks: List[Tuple[int, int]] = [(j, min(j + bn, n)) for j in range(0, n, bn)]
    qcache_budget = _qcache_budget()
    dev = resolve_device(device)

    # factors resident on the device for the whole run, clamped once
    w = to_state(w0, config, dev)
    h_blocks = [to_state(h0[:, j0:j1], config, dev) for j0, j1 in blocks]
    step_acc, w_epilogue, cost_block = _block_fns(config, kernels)
    prec = config.precision
    stream = _BlockStream(source, blocks, dev, prec.x_dtype, config.eps,
                          prec.x_quant_rows, qcache_budget)

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
        a1 = torch.zeros((m, k), dtype=_F32, device=dev)
        a2 = torch.zeros((k,), dtype=_F32, device=dev)
        for idx, x_j in stream.sweep():
            set_h(idx, step_acc(w_src, get_h(idx), x_j, a1, a2))
        return w_epilogue(w_src, a1, a2)

    def cost_pass(w_c, h_list) -> float:
        """Stream X once more; per-block costs stay on the device, summed in
        block order: one host read per cost pass."""
        parts = [cost_block(w_c, h_list[idx], x_j) for idx, x_j in stream.sweep()]
        return float(torch.sum(torch.stack(parts)))

    it, converged = 0, False
    hist_list: List[float] = []
    prev_cost = float("nan")
    mom = float("nan")
    if config.accelerate:
        w, prev_cost, mom, it, converged = _accel_loop(
            config, sweep, cost_pass, w, h_blocks, hist_list)
    else:
        while it < max_iter and not converged:
            w = sweep(w, h_blocks.__getitem__, h_blocks.__setitem__)
            it += 1
            if need_cost and (it % check_every == 0 or it == max_iter):
                total = cost_pass(w, h_blocks)
                hist_list.append(total)
                rel = abs(prev_cost - total) / abs(total) if total else float("nan")
                if thresh > 0.0 and rel < thresh:
                    converged = True
                prev_cost = total
    del stream   # the block buffers go before H is joined

    hist = np.full((max(len(hist_list), 1),), np.nan, np.float32)
    hist[: len(hist_list)] = hist_list
    return SolveResult(
        w=w,
        h=torch.cat(h_blocks, dim=1),
        iterations=torch.tensor(it, dtype=torch.int32),
        cost=torch.tensor(prev_cost, dtype=_F32),
        cost_history=torch.from_numpy(hist),
        num_checks=torch.tensor(len(hist_list), dtype=torch.int32),
        converged=torch.tensor(converged, dtype=torch.bool),
        momentum=torch.tensor(mom, dtype=_F32),
    )


def _accel_loop(config: SolveConfig, sweep, cost_pass, w, h_blocks, hist_list):
    """The safeguarded Nesterov-accelerated streamed loop
    (``streaming.py:1152-1262`` of the JAX package, without its checkpoint
    and mesh branches): the in-memory ``_run_accel_loop`` restated over
    streamed blocks.

    Each sweep runs from the extrapolated ``(w_ex, h_ex)`` and commits the
    plain iterate; the cost is taken at every check, against a seed cost
    pass made up front.  A block whose cost rose (or is NaN) restores the
    block-start snapshot and is redone with plain sweeps, and the carry
    restarts at the iterate.  The momentum is a Python float (float64), as
    in JAX's host loop; :func:`~nmf_tpu_torch.models.solver.extrapolate`
    rounds it to f32.  The snapshot copies the LIST of H blocks: the sweep
    replaces list entries and never writes a tensor in place, so holding the
    tensors is enough.  Updates ``h_blocks`` and ``hist_list`` in place;
    returns ``(w, cost, momentum, iterations, converged)``.
    """
    max_iter = int(config.max_iter)
    check_every = int(config.check_every)
    thresh = float(config.thresh)
    eps = config.eps
    mom = float(config.accel_momentum)
    m_hi = float(config.accel_momentum_max)
    grow = float(config.accel_grow)
    shrink = float(config.accel_shrink)
    it, converged = 0, False
    baseline = cost_pass(w, h_blocks) if max_iter > 0 else float("nan")
    w_ex, h_ex = w, list(h_blocks)
    w_snap, h_snap = w, list(h_blocks)

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
        baseline = total
        if thresh > 0.0 and rel < thresh:
            converged = True
    return w, baseline, mom, it, converged


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
    HALS), f32, bf16 and int8 X.  ``device`` as in :func:`solve_out_of_core`.
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
    if mask is not None:
        raise NotImplementedError(
            "transform_out_of_core: mask (ROADMAP.md Queue 1 step 6, item 8c: "
            "masked streaming) not in the PyTorch port yet"
        )
    if mesh is not None:
        raise NotImplementedError(
            "transform_out_of_core: mesh (ROADMAP.md Queue 1 step 12, item 12: "
            "sharded solves) not in the PyTorch port yet"
        )
    _refuse_solver(config)
    source = _as_source(x)
    m, n = source.shape
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
    blocks: List[Tuple[int, int]] = [(j, min(j + bn, n)) for j in range(0, n, bn)]
    dev = resolve_device(device)
    step, cost = _h_only_step_cost(config)
    w_dev = to_state(np.maximum(w, eps), config, dev, clamp=False)
    prec = config.precision

    def h_start(idx: int) -> torch.Tensor:
        j0, j1 = blocks[idx]
        if h0 is not None:
            h = np.maximum(h0[:, j0:j1], eps)
        else:
            # clamped like every random init: an exact zero is an absorbing
            # state under multiplicative updates
            h = np.maximum(np.random.RandomState(seed + idx).rand(k, j1 - j0)
                           .astype(np.float32), eps)
        h = torch.from_numpy(h)
        if dev.type == "cuda":   # no wait on the block that is solving
            h = h.pin_memory().to(dev, non_blocking=True)
        return to_state(h, config, dev, clamp=False)

    # one visit a block: the codes are never read twice, so none are cached
    stream = _BlockStream(source, blocks, dev, prec.x_dtype, config.eps,
                          prec.x_quant_rows, qcache_budget=0)
    parts = []
    pending = None
    for idx, x_j in stream.sweep():
        fetch = _Fetch(run_checked_loop(x_j, w_dev, h_start(idx), config, step, cost))
        if pending is not None:
            parts.append(pending.result())   # block idx - 1, while idx solves
        pending = fetch
    parts.append(pending.result())
    del stream

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
