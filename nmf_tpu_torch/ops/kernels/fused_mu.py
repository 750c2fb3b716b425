"""Wrappers of the fused multiplicative-update kernels K1-K3 (``csrc/fused_mu.cu``).

Counterpart of ``nmf_tpu.ops.pallas.fused_mu``: the same functions and
results, computed on Hopper by hand-written CUDA kernels instead of Pallas.

* ``update_h_fused`` (K1) and ``update_w_fused`` (K2): one half-update each,
  without materialising ``W@H`` or ``X / W@H`` in device memory; with
  ``numerator_only=True`` the f32 numerator alone, no epilogue.
* ``kl_cost_fused`` (K3): the KL cost, K1's walk with the cost's terms
  summed in place of the contraction, one partial a block.
* ``extrapolate_into``: the accelerated loop's extrapolation of both
  factors against a momentum that stays on the device, one momentum a
  member on a member axis (``csrc/extrapolate.cu``, one launch, counted
  in ``EXTRAP_LAUNCHES``); it replaces no Pallas kernel, but the JAX
  loop's ``_extrap``, which XLA fuses.

Every precision policy of the TPU kernels: W and H in f32 or bf16 (the
result takes their dtype); X as an f32 or bf16 tensor or a ``(uint8 codes,
per-column f32 scales)`` pair from :func:`nmf_tpu_torch.ops.quant.quantize_columns`;
GEMMs in ``float32``, ``float32_fast`` (split3) or ``bfloat16``.  Under
``bfloat16`` and ``float32_fast`` the two products of K1's and K2's first
pass run on the tensor cores (``mma.sync`` m16n8k16, bf16 in, f32
accumulate; ``csrc/mma_tile.cuh``; split3 as three products a step on bf16
hi and lo planes), in every state dtype, X storage and ``numerator_only``,
and under ``bfloat16`` K3's recon too; ``float32`` GEMMs, and K3's true-f32
recon under both f32 policies, run on the SIMT units.

Each wrapper takes its plain version (:mod:`nmf_tpu_torch.ops.mu` and
:func:`kl_cost_plain`, on dequantized X for a pair) only when its tensors lie
on the CPU.  For CUDA tensors it launches the kernel or raises: there is no
fallback on a failed build or launch, and a mode the kernels lack (per-row-
block scales) raises.  Above the rank ceiling (:func:`supported`) both
packages send the call to the plain ops by design; those calls are counted
in ``PLAIN_CALLS``, apart from the kernel launches in ``LAUNCHES``.  The
``numerator_only`` mode of K1 and K2 counts under its own keys
(``update_h_numerator``, ``update_w_numerator``).

A member axis, as ``jax.vmap`` gives the TPU kernels one (the batched,
restart and rank-sweep solves): W ``[B, M, K]`` and H ``[B, K, N]``, with X
per member (``[B, M, N]``, or codes ``[B, M, N]`` with scales ``[B, N]``)
or shared by all members (``[M, N]``, or codes with scales ``[N]``, the
counterpart of ``in_axes=None``).  The results take the member axis in
front (K3: ``[B]`` f32).  On CUDA tensors one batched call is one pass-1
and one pass-2 launch for all members (K3: one ``kl_partial``, one
``kl_final``), each member at the plan of its own shape, so member i gives
the bits of the 2-D call on member i; ``LAUNCHES`` counts the call once
and ``MEMBERS`` the members it served.  On CPU tensors the plain version
runs member by member.
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, Tuple

import torch

from ...utils.config import Precision
from ..divergence import kl_divergence, kl_divergence_from_recon
from ..elementwise import EPS, eps_clamp
from ..mu import matmul, numerator_h, numerator_w, update_h, update_w
from ..quant import dequantize

__all__ = [
    "LAUNCHES",
    "MEMBERS",
    "PLAIN_CALLS",
    "MAX_FUSED_K",
    "reset_counts",
    "count_snapshot",
    "count_delta",
    "add_counts",
    "supported",
    "plan_split",
    "kl_split",
    "update_h_fused",
    "update_w_fused",
    "mu_step_fused",
    "kl_cost_fused",
    "kl_cost_plain",
    "EXTRAP_LAUNCHES",
    "extrapolate_plain",
    "extrapolate_into",
]

# Launches of each kernel on the card (one per wrapper call that launched),
# and calls sent to the plain ops on the card by the rank rule.
_KEYS = ("update_h", "update_w", "kl_cost", "update_h_numerator", "update_w_numerator")
LAUNCHES: Dict[str, int] = dict.fromkeys(_KEYS, 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(_KEYS, 0)
# Members served by those launches: 1 a 2-D launch, B a batched one.
MEMBERS: Dict[str, int] = dict.fromkeys(_KEYS, 0)
# Launches of the extrapolation kernel (apart from K1-K3's, whose counts
# every solve's launch gates read).
EXTRAP_LAUNCHES: Dict[str, int] = {"extrapolate": 0}

# Largest rank the fused path takes, as in nmf_tpu (fused_mu.py:63).  Up to
# it the kernels chunk K by MAX_CHUNK and recompute W@H per chunk.
MAX_FUSED_K = 2048
TILE = 64          # output/recon tile edge of csrc/fused_mu.cu
MAX_CHUNK = 256    # widest K chunk a block accumulates
# Blocks the split planner aims for: 4 per SM of a 132-SM H100.  A fixed
# number, not read from the card, so the split (and so the bits of every
# result) depends on the shape alone.
TARGET_BLOCKS = 4 * 132

# The kernels' mode codes (csrc/fused_mu.cu: XKind, Gemm).
_STATE_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_X_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_GEMM = {"float32": 0, "float32_fast": 1, "bfloat16": 2}


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    for d in (LAUNCHES, PLAIN_CALLS, MEMBERS, EXTRAP_LAUNCHES):
        for key in d:
            d[key] = 0


# The library's pass-1 counters: K1 and K2 per Mode (``nmf_partial_launches``)
# and K3 per Mode (``nmf_kl_launches``) in ``csrc/fused_mu.cu``, K5's H and W
# targets per Mode (``nmf_sweep_launches``) in ``csrc/tile_sparse.cu``.
_LIB_MODES = 4
_COUNT_NAMES = ("LAUNCHES", "PLAIN_CALLS", "MEMBERS", "EXTRAP_LAUNCHES")


def _count_dicts() -> Dict[str, Dict[str, int]]:
    """The wrappers' counts by name: K1-K3's and the extrapolation's here,
    K5's (``tile_sparse.LAUNCHES`` and ``PLAIN_CALLS``) under their module's
    name."""
    from . import tile_sparse

    return {**{name: globals()[name] for name in _COUNT_NAMES},
            "tile_sparse.LAUNCHES": tile_sparse.LAUNCHES,
            "tile_sparse.PLAIN_CALLS": tile_sparse.PLAIN_CALLS}


def count_snapshot() -> Dict[tuple, int]:
    """Every launch count now: the entries of ``LAUNCHES``, ``PLAIN_CALLS``,
    ``MEMBERS``, ``EXTRAP_LAUNCHES`` and K5's ``tile_sparse.LAUNCHES`` and
    ``PLAIN_CALLS``, and, once the library is loaded, its pass-1 launches
    of K1, K2 and K3 (``"lib"``) and of K5's two targets (``"sweep"``) per
    Mode.  A replayed CUDA graph runs its kernels without their wrappers,
    so the loop that replays it adds what the capture recorded
    (:func:`count_delta`, :func:`add_counts`)."""
    snap = {(name, key): n for name, counts in _count_dicts().items()
            for key, n in counts.items()}
    if _lib.cache_info().currsize:
        lib = _lib()
        for mode in range(_LIB_MODES):
            snap["lib", 0, mode] = lib.nmf_partial_launches(1, mode)
            snap["lib", 1, mode] = lib.nmf_partial_launches(0, mode)
            snap["lib", 2, mode] = lib.nmf_kl_launches(mode)
            for target in (1, 0):
                snap["sweep", target, mode] = lib.nmf_sweep_launches(target, mode)
    return snap


def count_delta(before: Dict[tuple, int]) -> Dict[tuple, int]:
    """What the counts gained since the snapshot ``before``."""
    delta = {key: n - before.get(key, 0) for key, n in count_snapshot().items()}
    return {key: n for key, n in delta.items() if n}


def add_counts(delta: Dict[tuple, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (of :func:`count_delta`) to the counts:
    ``times=1`` at each replay of a graph, ``-1`` to take back its capture,
    which launched nothing."""
    dicts = _count_dicts()
    for key, n in delta.items():
        if key[0] in ("lib", "sweep"):
            lib = _lib()
            add = lib.nmf_add_launches if key[0] == "lib" else lib.nmf_add_sweep_launches
            if add(key[1], key[2], n * times) != 0:
                raise RuntimeError(f"the library refused {key[0]} counter {key[1]}, "
                                   f"Mode {key[2]}")
        else:
            dicts[key[0]][key[1]] += n * times


def supported(k=None) -> bool:
    """Whether the fused kernels take rank ``k`` (the JAX rank rule)."""
    return k is None or k <= MAX_FUSED_K


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunk_width(k: int) -> int:
    """K chunk one block accumulates: the smallest of 16, 32, ..., 256 that
    covers ``k``, or 256 (and several chunks) above that."""
    kc = 16
    while kc < k and kc < MAX_CHUNK:
        kc *= 2
    return kc


def plan_split(out_tiles: int, k_chunks: int, walk_tiles: int) -> Tuple[int, int]:
    """Split the contraction walk (M tiles for K1, N tiles for K2) across
    blocks: returns ``(splits, tiles_per_split)``.

    Enough splits that about ``TARGET_BLOCKS`` blocks run, each over an
    equal run of tiles, every split non-empty.
    """
    base = out_tiles * k_chunks
    want = min(walk_tiles, max(1, _cdiv(TARGET_BLOCKS, base)))
    per = _cdiv(walk_tiles, want)
    return _cdiv(walk_tiles, per), per


def kl_split(m: int, n: int, k: int) -> Tuple[int, int, int, int]:
    """K3's launch plan from the shape alone: ``(kc, splits,
    tiles_per_split, slots)``.

    A K3 block owns 64 columns of the cost and walks a run of M tiles, as
    K1's side does; the recon needs all of K, so there is no k-chunk axis
    (``kc`` covers K up to ``MAX_CHUNK``, above which W H streams both
    operands).  The runs are cut by K1's planner with one chunk; each block
    writes one partial, so ``slots`` is the grid's block count.
    """
    n_tiles = _cdiv(n, TILE)
    splits, per = plan_split(n_tiles, 1, _cdiv(m, TILE))
    return chunk_width(k), splits, per, splits * n_tiles


def _dense_x(x) -> torch.Tensor:
    """X itself, or a ``(codes, scales)`` pair dequantized (plain route)."""
    return dequantize(*x) if isinstance(x, tuple) else x


def _x_tensors(x) -> Tuple[torch.Tensor, ...]:
    return tuple(x) if isinstance(x, tuple) else (x,)


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (plain version); False when
    every operand lies on one CUDA device (kernel); raises otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check_2d(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def _check_cuda_operands(w, h, x):
    """Shapes, dtypes and layout for the kernels: returns (m, n, k, x data
    tensor, scales tensor or None)."""
    if w.dtype not in _STATE_BF16 or h.dtype != w.dtype:
        raise NotImplementedError(
            f"W is {w.dtype} and H {h.dtype}; the CUDA kernels take W and H "
            "both float32 or both bfloat16"
        )
    _check_2d("w", w)
    _check_2d("h", h)
    m, k = w.shape
    k2, n = h.shape
    scales = None
    if isinstance(x, tuple):
        x, scales = x
        if x.dtype != torch.uint8:
            raise NotImplementedError(f"int8 X codes are {x.dtype}; the kernels take uint8")
        if scales.dim() != 1:
            raise NotImplementedError(
                "per-row-block int8 scales (x_quant_rows > 0) are not in the "
                "CUDA kernels, whose scales are per column: the solver sends "
                "such X to the plain ops (nmf_tpu models/solver.py:137-143)"
            )
        if scales.dtype != torch.float32 or tuple(scales.shape) != (n,):
            raise ValueError(
                f"scales must be float32 of shape ({n},), got {scales.dtype} "
                f"{tuple(scales.shape)}"
            )
        scales = scales.contiguous()
    elif x.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"x is {x.dtype}; the CUDA kernels take float32, bfloat16, or "
            "(uint8 codes, scales)"
        )
    _check_2d("x", x)
    if k2 != k or tuple(x.shape) != (m, n):
        raise ValueError(
            f"shape mismatch: X{tuple(x.shape)} vs W{tuple(w.shape)} @ H{tuple(h.shape)}"
        )
    if min(m, n, k) < 1:
        raise ValueError(f"empty operand: m={m} n={n} k={k}")
    if max(m * n, m * k, k * n) >= 2**31:
        raise ValueError("operands above 2**31 elements are not supported")
    return m, n, k, x, scales


def _check_batched_operands(w, h, x):
    """A batched call's shapes, dtypes and layout: returns (b, m, n, k, x
    data tensor, scales tensor or None, x shared)."""
    if w.dtype not in _STATE_BF16 or h.dtype != w.dtype:
        raise NotImplementedError(
            f"W is {w.dtype} and H {h.dtype}; the CUDA kernels take W and H "
            "both float32 or both bfloat16"
        )
    for name, t in (("w", w), ("h", h)):
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, rows, cols] stack, "
                             f"got shape {tuple(t.shape)}")
    b, m, k = w.shape
    b2, k2, n = h.shape
    scales = None
    if isinstance(x, tuple):
        x, scales = x
        if x.dtype != torch.uint8:
            raise NotImplementedError(f"int8 X codes are {x.dtype}; the kernels take uint8")
    elif x.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"x is {x.dtype}; the CUDA kernels take float32, bfloat16, or "
            "(uint8 codes, scales)"
        )
    shared = x.dim() == 2
    want = (m, n) if shared else (b, m, n)
    if b2 != b or k2 != k or tuple(x.shape) != want:
        raise ValueError(
            f"shape mismatch: X{tuple(x.shape)} vs W{tuple(w.shape)} @ H{tuple(h.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major)")
    if scales is not None:
        want_s = (n,) if shared else (b, n)
        if scales.dim() == len(want_s) + 1:
            raise NotImplementedError(
                "per-row-block int8 scales (x_quant_rows > 0) are not in the "
                "CUDA kernels, whose scales are per column: the solver sends "
                "such X to the plain ops (nmf_tpu models/solver.py:137-143)"
            )
        if scales.dtype != torch.float32 or tuple(scales.shape) != want_s:
            raise ValueError(
                f"scales must be float32 of shape {want_s}, got {scales.dtype} "
                f"{tuple(scales.shape)}"
            )
        scales = scales.contiguous()
    if min(b, m, n, k) < 1:
        raise ValueError(f"empty operand: b={b} m={m} n={n} k={k}")
    if max(m * n, m * k, k * n) >= 2**31:
        raise ValueError("operands above 2**31 elements a member are not supported")
    return b, m, n, k, x, scales, shared


def _member_x(x, i: int):
    """Member i's X of a batched call: X itself when shared (2-D), else its
    slice, a ``(codes, scales)`` pair sliced together."""
    if isinstance(x, tuple):
        return x if x[0].dim() == 2 else (x[0][i], x[1][i])
    return x if x.dim() == 2 else x[i]


def _per_member(fn, w, h, x, *args):
    """The plain version member by member, stacked (the CPU route of a
    batched call, and the rank rule's)."""
    return torch.stack([fn(w[i], h[i], _member_x(x, i), *args) for i in range(w.shape[0])])


def _modes(w, x, precision: Precision) -> Tuple[int, int, int]:
    """(state_bf16, x_kind, gemm) codes of a checked call."""
    return _STATE_BF16[w.dtype], _X_KIND[x.dtype], _GEMM[precision.matmul_dtype]


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded kernel library, its tile constants checked once."""
    from ._build import load_library

    lib = load_library()
    if lib.nmf_tile() != TILE or lib.nmf_max_chunk() != MAX_CHUNK:
        raise RuntimeError("csrc/fused_mu.cu tile constants differ from the planner's")
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.nmf_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# The member sums of a batched call as CUDA graphs, keyed by the source's
# address and layout: a solve's W and H come back from the caching
# allocator at a few addresses, so its loop replays a few graphs.
_SUM_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_SUM_GRAPHS_MAX = 16


def _member_sums(t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.stack([torch.sum(t[i], dim=dim, dtype=torch.float32) for i in range(t.shape[0])])


def _sums(t: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 sums of ``t`` over ``dim`` (-2: W's columns, -1: H's rows), on a
    member axis member by member: torch's reduction of a stack may sum in
    another order than of one member (seen on the H100 at 513 x 32), and
    member i must take the 2-D call's bits.  The B sums of a stack run as
    one graph replay (B host calls a half-step made the batched call
    host-bound); the result is read before the next call replays it.
    Inside a capture (the batched loop's graphs) the B sums are captured
    into that graph with the rest of the step: no nested capture, and no
    replay of a cached graph whose output a later call would overwrite."""
    if t.dim() == 2:
        return torch.sum(t, dim=dim, dtype=torch.float32)
    if torch.cuda.is_current_stream_capturing():
        return _member_sums(t, dim)
    key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype, dim, t.device)
    entry = _SUM_GRAPHS.get(key)
    if entry is None:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _member_sums(t, dim)
        entry = _SUM_GRAPHS[key] = (graph, out)
        if len(_SUM_GRAPHS) > _SUM_GRAPHS_MAX:
            _SUM_GRAPHS.popitem(last=False)
    _SUM_GRAPHS.move_to_end(key)
    entry[0].replay()
    return entry[1]


_PLAIN = {
    ("update_h", False): update_h, ("update_h", True): numerator_h,
    ("update_w", False): update_w, ("update_w", True): numerator_w,
}


def _update_fused(kind: str, w, h, x, eps, precision, numerator_only):
    numerator_only = bool(numerator_only)
    plain = _PLAIN[kind, numerator_only]
    batched = w.dim() == 3

    def plain_call():
        if batched:
            return _per_member(lambda w_, h_, x_: plain(w_, h_, _dense_x(x_), eps, precision),
                               w, h, x)
        return plain(w, h, _dense_x(x), eps, precision)

    if _on_cpu(w, h, *_x_tensors(x)):
        return plain_call()
    key = f"{kind}_numerator" if numerator_only else kind
    if batched:
        b, m, n, k, xd, scales, shared = _check_batched_operands(w, h, x)
    else:
        b, shared = 1, False
        m, n, k, xd, scales = _check_cuda_operands(w, h, x)
    if not supported(k):
        # the documented rank rule of nmf_tpu (fused_mu.py:305-313), not a
        # path taken on failure
        PLAIN_CALLS[key] += 1
        return plain_call()
    kc = chunk_width(k)
    chunks = _cdiv(k, kc)
    m_tiles, n_tiles = _cdiv(m, TILE), _cdiv(n, TILE)
    # the numerator is f32 whatever the state dtype (fused_mu.py:357, :482),
    # and takes no denominator (the JAX wrapper ships a placeholder)
    f32 = dict(dtype=torch.float32, device=w.device)
    lead = (b,) if batched else ()
    if kind == "update_h":
        # f32 column sums outside the kernel, as the JAX wrapper takes them
        # (nmf_tpu fused_mu.py:319)
        denom = None if numerator_only else eps_clamp(_sums(w, -2), eps)
        splits, per = plan_split(n_tiles, chunks, m_tiles)
        part = torch.empty((*lead, splits, k, n), **f32)
        out = torch.empty((*lead, k, n), **f32) if numerator_only else torch.empty_like(h)
    else:
        denom = None if numerator_only else eps_clamp(_sums(h, -1), eps)  # (:444)
        splits, per = plan_split(m_tiles, chunks, n_tiles)
        part = torch.empty((*lead, splits, m, k), **f32)
        out = torch.empty((*lead, m, k), **f32) if numerator_only else torch.empty_like(w)
    lib = _lib()
    args = (
        w.data_ptr(), h.data_ptr(), xd.data_ptr(), _ptr(scales), _ptr(denom),
        part.data_ptr(), out.data_ptr(), m, n, k, kc, splits, per, float(eps),
        *_modes(w, xd, precision), int(numerator_only), _index(w), _stream(w),
    )
    if batched:
        fn = lib.nmf_h_update_batched if kind == "update_h" else lib.nmf_w_update_batched
        rc = fn(*args, b, int(shared))
    else:
        fn = lib.nmf_h_update if kind == "update_h" else lib.nmf_w_update
        rc = fn(*args)
    _raise_on(lib, rc, key)
    LAUNCHES[key] += 1
    MEMBERS[key] += b
    return out


def update_h_fused(
    w: torch.Tensor,
    h: torch.Tensor,
    x,
    eps: float = EPS,
    precision: Precision = Precision(),
    numerator_only: bool = False,
) -> torch.Tensor:
    """Fused H half-update (nmf.cu:118-146), kernel K1.

    ``H * (W^T (X / max(W H, eps))) / max(colsum W, eps)[:, None]``, the
    product taken as the TPU kernel takes it: ``h * acc / sum_w``, in the
    dtype of ``h``.  With ``numerator_only=True``, the numerator
    ``W^T (X / max(W H, eps))`` alone, (K, N) f32, for callers that sum it
    before the epilogue.
    """
    return _update_fused("update_h", w, h, x, eps, precision, numerator_only)


def update_w_fused(
    w: torch.Tensor,
    h: torch.Tensor,
    x,
    eps: float = EPS,
    precision: Precision = Precision(),
    numerator_only: bool = False,
) -> torch.Tensor:
    """Fused W half-update (nmf.cu:148-176), kernel K2; ``h`` is the new H.

    With ``numerator_only=True``, ``(X / max(W H, eps)) H^T`` alone, (M, K)
    f32.
    """
    return _update_fused("update_w", w, h, x, eps, precision, numerator_only)


def mu_step_fused(
    w: torch.Tensor,
    h: torch.Tensor,
    x,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full fused MU iteration: drop-in for :func:`ops.mu.mu_step`."""
    h = update_h_fused(w, h, x, eps, precision)
    w = update_w_fused(w, h, x, eps, precision)
    return w, h


def kl_cost_plain(
    x, w: torch.Tensor, h: torch.Tensor, eps: float = EPS,
    precision: Precision = Precision(),
) -> torch.Tensor:
    """The plain version of K3: the reconstruction on bf16-rounded inputs
    under ``bfloat16`` and true f32 under both f32 policies, as the TPU
    kernel takes it (nmf_tpu fused_mu.py:586-591); a pair is dequantized."""
    x = _dense_x(x)
    if precision.matmul_dtype == "bfloat16":
        return kl_divergence_from_recon(x, matmul(w, h, precision), eps)
    return kl_divergence(x, w, h, eps)


def kl_cost_fused(
    x,
    w: torch.Tensor,
    h: torch.Tensor,
    eps: float = EPS,
    precision: Precision = Precision(),
) -> torch.Tensor:
    """KL divergence D(X || max(W H, eps)) with W H kept on chip, kernel K3.

    Returns a 0-dim f32 tensor on the operands' device, with the recon of
    :func:`kl_cost_plain`; on a member axis, a ``[B]`` f32 tensor, one cost
    a member.
    """
    batched = w.dim() == 3

    def plain_call():
        if batched:
            return _per_member(lambda w_, h_, x_: kl_cost_plain(x_, w_, h_, eps, precision),
                               w, h, x)
        return kl_cost_plain(x, w, h, eps, precision)

    if _on_cpu(w, h, *_x_tensors(x)):
        return plain_call()
    if batched:
        b, m, n, k, xd, scales, shared = _check_batched_operands(w, h, x)
    else:
        b, shared = 1, False
        m, n, k, xd, scales = _check_cuda_operands(w, h, x)
    if not supported(k):
        PLAIN_CALLS["kl_cost"] += 1
        return plain_call()
    kc, splits, per, slots = kl_split(m, n, k)
    partials = torch.empty((b * slots,), dtype=torch.float32, device=w.device)
    # under bfloat16 on f32 state the kernel rounds W and H to bf16 once
    # into this scratch (each member's W and H copies starting on 16 bytes)
    scratch = None
    if precision.matmul_dtype == "bfloat16" and w.dtype == torch.float32:
        words = _cdiv(m * k, 8) * 8 + (_cdiv(k * n, 8) * 8 if batched else k * n)
        scratch = torch.empty((b * words,), dtype=torch.bfloat16, device=w.device)
    out = torch.empty((b,) if batched else (), dtype=torch.float32, device=w.device)
    lib = _lib()
    args = (
        w.data_ptr(), h.data_ptr(), xd.data_ptr(), _ptr(scales), partials.data_ptr(),
        _ptr(scratch), out.data_ptr(), m, n, k, kc, splits, per, float(eps),
        *_modes(w, xd, precision), _index(w), _stream(w),
    )
    rc = lib.nmf_kl_cost_batched(*args, b, int(shared)) if batched else lib.nmf_kl_cost(*args)
    _raise_on(lib, rc, "kl_cost")
    LAUNCHES["kl_cost"] += 1
    MEMBERS["kl_cost"] += b
    return out


def extrapolate_plain(new: torch.Tensor, old: torch.Tensor, m: torch.Tensor,
                      eps: float = EPS) -> torch.Tensor:
    """The plain version of the extrapolation kernel on one factor:
    ``max(f32(new) + m (f32(new) - f32(old)), f32(eps))`` in the dtype of
    ``new`` (bf16: rounded to nearest even), ``m`` a 0-d f32 tensor, or on
    a member axis (``new`` and ``old`` stacks ``[B, ...]``) a ``[B]`` one,
    member i taking ``m[i]``.  ``addcmul``'s multiply-add is one FMA on the
    CPU, so this gives ``models.solver.extrapolate``'s bits there, each
    member at its own momentum (its host momentum is ``torch.add``'s
    ``alpha``, which takes no tensor)."""
    n32 = new.to(torch.float32)
    if m.dim() == 1:
        m = m.view(-1, *([1] * (new.dim() - 1)))
    return torch.addcmul(n32, n32 - old.to(torch.float32), m).clamp_min_(float(eps)).to(new.dtype)


def extrapolate_into(pairs, m: torch.Tensor, eps: float = EPS) -> None:
    """One accelerated step's carry, in place: for each ``(next, prev,
    ex)`` of ``pairs`` (W's, then H's), ``ex`` <- the extrapolation of
    ``next`` against ``prev`` (:func:`extrapolate_plain`) and ``prev`` <-
    ``next``.  ``m`` is the momentum, a 0-d f32 tensor that no host reads,
    or on a member axis a ``[B]`` one, each pair then ``[B, ...]`` stacks
    whose member i takes ``m[i]``.  ``next`` may be ``ex`` (an H-only step
    returns its W).

    CPU tensors take the plain version; on the card one launch of
    ``csrc/extrapolate.cu`` does every pair (one or two, of one state
    dtype, each contiguous) of every member, or this raises."""
    tensors = [t for pair in pairs for t in pair]
    if _on_cpu(m, *tensors):
        for nxt, prev, ex in pairs:
            e = extrapolate_plain(nxt, prev, m, eps)
            prev.copy_(nxt)
            ex.copy_(e)
        return
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"one or two (next, prev, ex) pairs, got {len(pairs)}")
    dtype = pairs[0][0].dtype
    if dtype not in _STATE_BF16 or any(t.dtype != dtype for t in tensors):
        raise NotImplementedError(f"the extrapolation takes float32 or bfloat16 factors of one "
                                  f"dtype, got {sorted({str(t.dtype) for t in tensors})}")
    if m.dtype != torch.float32 or m.dim() > 1 or not m.is_contiguous():
        raise ValueError(f"the momentum must be a 0-d or [B] float32 tensor, got {m.dtype} "
                         f"{tuple(m.shape)}")
    members = m.numel()
    for nxt, prev, ex in pairs:
        if not (nxt.shape == prev.shape == ex.shape) or not all(
                t.is_contiguous() for t in (nxt, prev, ex)):
            raise ValueError("each (next, prev, ex) must be contiguous tensors of one shape")
        if not 1 <= nxt.numel() < 2**31:
            raise ValueError(f"a factor of {nxt.numel()} elements")
        if m.dim() == 1 and (nxt.dim() < 2 or nxt.shape[0] != members):
            raise ValueError(f"a [{members}] momentum takes [{members}, ...] stacks, got "
                             f"{tuple(nxt.shape)}")
    (n0, p0, e0), (n1, p1, e1) = pairs[0], pairs[-1]
    size1 = n1.numel() if len(pairs) == 2 else 0
    lib = _lib()
    rc = lib.nmf_extrapolate(n0.data_ptr(), p0.data_ptr(), e0.data_ptr(), n0.numel(),
                             n1.data_ptr(), p1.data_ptr(), e1.data_ptr(), size1, m.data_ptr(),
                             members, float(eps), _STATE_BF16[dtype], _index(m), _stream(m))
    _raise_on(lib, rc, "extrapolate")
    EXTRAP_LAUNCHES["extrapolate"] += 1
