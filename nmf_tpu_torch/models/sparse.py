"""Sparse-X KL-NMF over COO nonzeros: memory proportional to nnz(X).

Counterpart of ``nmf_tpu.models.sparse`` (deprecated there, and here, in
favour of :func:`~nmf_tpu_torch.solve_sparse_tiled`).  KL-MU admits a sparse
data path because:

* the update numerators read X only through ``Z = X / clamp(W H, eps)``,
  which vanishes wherever X is exactly zero, so both numerator GEMMs
  (``W^T Z`` and ``Z H^T``) touch only X's nonzeros;
* the denominators are ``colsum(W)`` / ``rowsum(H)``, X-free;
* the KL cost splits as ``sum_nnz(x log x - x log y - x) + colsum(W) .
  rowsum(H)``, an O(K) dot in place of a dense reconstruction.

Zero entries are EXACT zeros (their ``x log(x / y)`` limit is 0 and only
the ``+y`` mass remains): the solve equals the dense solve with
``clamp_inputs=False``, not the reference's load-time clamp of zeros to
eps (``sparse.py:13-17`` of the JAX package).

There is no TPU kernel to port here: JAX runs ``lax.scan`` over fixed-size
chunks of nonzeros with ``.at[].add`` scatters, and so this module runs
plain torch ops on every device.  A float scatter-add on the card
(``index_add_``, ``scatter_add_``) adds with atomics in no fixed order, so
the reduction is restated to give the same bits on every run:

* the nonzeros are padded to a multiple of ``chunk`` with zero-data
  entries at (0, 0) (:func:`_pad_chunks`, JAX's padding; they add exact
  zeros), then sorted once on the host, stably, by column (the H
  numerator's output index) and by row (the W numerator's);
* each chunk's ``(chunk, K)`` contributions are reduced per run of equal
  index by ``torch.segment_reduce`` (each output entry summed in the
  chunk's order), and each chunk's partials, whose indices are distinct,
  are added into the accumulator in chunk order.

The summation order therefore differs from JAX's scatter, and the CPU
parity with ``nmf_tpu.solve_sparse`` is by tolerance.  H is gathered as one
contiguous ``H^T`` a half-step; every intermediate is one chunk's worth.
The loop is :func:`~nmf_tpu_torch.models.solver.run_checked_loop`, as
JAX's is, so ``thresh``, ``check_every``, ``accelerate`` and
``live_metrics`` behave as in :func:`~nmf_tpu_torch.solve`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, NamedTuple, Tuple, Union

import numpy as np
import torch

from ..ops.elementwise import eps_clamp
from ..utils.config import SolveConfig
from ..utils.device import resolve_device
from .solver import SolveResult, run_checked_loop, to_state

__all__ = ["SparseX", "solve_sparse", "sparse_from_dense"]

_CHUNK = 1 << 16  # nonzeros a chunk: (chunk, K) f32 intermediates
_F32 = torch.float32

Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class SparseX:
    """COO nonzeros of X (data may be any nonnegative values; exact zeros in
    ``data`` are inert padding): NumPy arrays or tensors."""

    data: Array      # (nnz,) f32
    rows: Array      # (nnz,) i32
    cols: Array      # (nnz,) i32
    shape: Tuple[int, int]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def sparse_from_dense(x) -> SparseX:
    """A :class:`SparseX` of a dense array's or tensor's nonzeros (row-major
    order), as NumPy arrays."""
    x = _host(x).astype(np.float32, copy=False)
    rows, cols = np.nonzero(x)
    if rows.size and x[rows, cols].min() < 0:
        # NMF requires nonnegative data; sparse values are used as-is
        raise ValueError(
            f"sparse data must be nonnegative (min {x[rows, cols].min()})"
        )
    return SparseX(
        data=x[rows, cols],
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        shape=tuple(x.shape),
    )


def _pad_chunks(sx: SparseX, chunk: int) -> SparseX:
    """Pad nnz to a chunk multiple with zero-data entries at (0, 0):
    ``z = 0 / clamp(y) = 0``, so padding contributes nothing anywhere."""
    nnz = int(sx.data.shape[0])
    padded = -(-max(nnz, 1) // chunk) * chunk
    if padded == nnz:
        return sx
    p = padded - nnz
    if isinstance(sx.data, torch.Tensor):
        def pad(a):
            return torch.cat([a, a.new_zeros(p)])
    else:
        def pad(a):
            return np.pad(np.asarray(a), (0, p))
    return SparseX(data=pad(sx.data), rows=pad(sx.rows), cols=pad(sx.cols), shape=sx.shape)


class _Order(NamedTuple):
    """The padded nonzeros sorted by one index, on the device, and the runs
    of equal index in each chunk: ``keys[a:b]`` and ``lengths[a:b]`` for
    chunk c, with ``(a, b) = bounds[c], bounds[c + 1]`` (host ints)."""

    data: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    keys: torch.Tensor
    lengths: torch.Tensor
    bounds: List[int]


def _order(data: np.ndarray, rows: np.ndarray, cols: np.ndarray, by: np.ndarray,
           chunk: int, dev: torch.device) -> _Order:
    """Sort the padded nonzeros stably by ``by`` and cut each chunk into its
    runs of equal index."""
    perm = np.argsort(by, kind="stable")
    key = by[perm]
    total = key.shape[0]
    pos = np.arange(1, total)
    start = np.concatenate([[True], (key[1:] != key[:-1]) | (pos % chunk == 0)])
    starts = np.flatnonzero(start)
    lengths = np.diff(np.append(starts, total))
    bounds = np.searchsorted(starts // chunk, np.arange(total // chunk + 1)).tolist()

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return _Order(up(data[perm], _F32), up(rows[perm], torch.int64), up(cols[perm], torch.int64),
                  up(key[starts], torch.int64), up(lengths, torch.int64), bounds)


def _numerator(o: _Order, w32: torch.Tensor, ht: torch.Tensor, target: str, chunk: int,
               eps: float) -> torch.Tensor:
    """``sum over nonzeros of z * gather``, per output index, chunk by chunk:
    target ``"h"`` sums ``z W[row]`` into column indices, (N, K); ``"w"``
    sums ``z H[:, col]^T`` into row indices, (M, K)."""
    k = w32.shape[1]
    dim = ht.shape[0] if target == "h" else w32.shape[0]
    acc = torch.zeros((dim, k), dtype=_F32, device=w32.device)
    for c in range(len(o.bounds) - 1):
        s = slice(c * chunk, (c + 1) * chunk)
        wr, hc = w32[o.rows[s]], ht[o.cols[s]]
        z = o.data[s] / eps_clamp(torch.sum(wr * hc, dim=1), eps)
        contrib = z[:, None] * (wr if target == "h" else hc)
        a, b = o.bounds[c], o.bounds[c + 1]
        part = torch.segment_reduce(contrib, "sum", lengths=o.lengths[a:b], axis=0)
        keys = o.keys[a:b]          # distinct within a chunk
        acc[keys] = acc[keys] + part
    return acc


def _sparse_fns(config: SolveConfig, chunk: int):
    """(step, cost) on the sorted nonzeros ``(by_col, by_row)``."""
    eps = config.eps

    def step(w, h, xs):
        """One full MU iteration in reference order (H half, then W half
        with the new H), X read only at its nonzeros."""
        by_col, by_row = xs
        w32 = w.to(_F32)
        numer = _numerator(by_col, w32, h.t().to(_F32).contiguous(), "h", chunk, eps)  # (N, K)
        sum_w = eps_clamp(torch.sum(w, dim=0, dtype=_F32), eps)
        h = (h * (numer.t() / sum_w[:, None])).to(h.dtype)

        numer = _numerator(by_row, w32, h.t().to(_F32).contiguous(), "w", chunk, eps)  # (M, K)
        sum_h = eps_clamp(torch.sum(h, dim=1, dtype=_F32), eps)
        w = (w * (numer / sum_h[None, :])).to(w.dtype)
        return w, h

    def cost(xs, w, h):
        """KL with the x -> 0 limit at zeros: the '+y' mass of the whole
        matrix is colsum(W) . rowsum(H); the nonzeros add x log(x / y) - x
        with y at the nonzeros only, summed chunk by chunk."""
        o = xs[0]
        w32, ht = w.to(_F32), h.t().to(_F32).contiguous()
        nnz_part = torch.zeros((), dtype=_F32, device=w.device)
        for c in range(len(o.bounds) - 1):
            s = slice(c * chunk, (c + 1) * chunk)
            dd = o.data[s]
            y = eps_clamp(torch.sum(w32[o.rows[s]] * ht[o.cols[s]], dim=1), eps)
            term = torch.where(
                dd > 0, dd * (torch.log(eps_clamp(dd, eps)) - torch.log(y)) - dd, 0.0
            )
            nnz_part = nnz_part + torch.sum(term)
        total_y = torch.dot(torch.sum(w, dim=0, dtype=_F32), torch.sum(h, dim=1, dtype=_F32))
        return nnz_part + total_y

    return step, cost


def solve_sparse(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    chunk: int = _CHUNK,
    device="cuda",
) -> SolveResult:
    """Factorize a sparse X (:class:`SparseX`, or anything dense-like whose
    nonzeros define it).  Zero entries are exact zeros (module docstring);
    W and H are dense tensors on ``device`` (``"cuda"`` by default; a CUDA
    request without a card raises), W0 and H0 clamped to eps in the state
    dtype first.

    .. deprecated::
        The COO path gathers K-length rows per nonzero and is dominated by
        :func:`~nmf_tpu_torch.solve_sparse_tiled`, which runs the kernel K5
        over occupied tiles; ``tiles_from_coo`` converts the same triplets.
        It stays for truly unclustered nonzeros and as an independent
        equivalence oracle.
    """
    warnings.warn(
        "solve_sparse (COO) is deprecated: use solve_sparse_tiled "
        "(tiles_from_coo accepts the same triplets); the tiled path is "
        "6-8x faster and composes with mesh/batch/int8/checkpointing",
        DeprecationWarning,
        stacklevel=2,
    )
    config.validate()
    if config.beta != 1.0 or config.regularized or config.algorithm != "mu":
        raise NotImplementedError(
            "sparse solve implements the KL (beta=1) MU family"
        )
    sx = x if isinstance(x, SparseX) else sparse_from_dense(x)
    m, n = sx.shape
    dev = resolve_device(device)
    w0, h0 = to_state(w0, config, dev), to_state(h0, config, dev)
    if (m, n) != (w0.shape[0], h0.shape[1]) or w0.shape[1] != h0.shape[0]:
        raise ValueError(
            f"shape mismatch: X{(m, n)} vs W{tuple(w0.shape)} @ H{tuple(h0.shape)}"
        )
    chunk = int(chunk)
    sx = _pad_chunks(sx, chunk)
    data = _host(sx.data).astype(np.float32, copy=False)
    rows = _host(sx.rows).astype(np.int64)
    cols = _host(sx.cols).astype(np.int64)
    xs = (_order(data, rows, cols, cols, chunk, dev), _order(data, rows, cols, rows, chunk, dev))
    step, cost = _sparse_fns(config, chunk)
    return run_checked_loop(xs, w0, h0, config, step, cost)
