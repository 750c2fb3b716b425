"""Device selection and the card's tuning row for the port.

A request for CUDA on a machine without a usable card raises: the port never
moves work to the CPU behind the caller's back.

:class:`ChipSpec` is the counterpart of ``nmf_tpu.utils.device``'s table,
keyed by ``torch.cuda.get_device_name()`` in place of JAX's
``device_kind``.  It has one measured row, the card this repo's kernels were
built and measured on (NVIDIA H100 80GB HBM3); every other name, and the
CPU, resolves to :data:`GENERIC`, whose peaks are ``None`` so that a
fraction-of-peak report reads "unknown" rather than wrong.  No number of the
JAX table's TPU rows is carried over.

The backend rule's fields (read by :func:`nmf_tpu_torch.utils.autotune.rule_pick`)
were measured on the H100 row alone; :data:`GENERIC` keeps them as the
default for other cards, where ``backend="autotune"`` measures per shape.
The kernels' planners do not read the row: ``TARGET_BLOCKS = 4 * 132``
(``ops/kernels/fused_mu.py``) and ``SWEEP_BLOCKS = 2 * 132``
(``ops/kernels/tile_sparse.py``) are fixed numbers taken from its
``sm_count``, because the split, and so the bits of every result, must
depend on the shape alone.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

__all__ = ["ChipSpec", "GENERIC", "chip_spec", "chip_spec_for", "resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The ``torch.device`` for ``device`` (``None`` means ``"cuda"``).

    For a CUDA device this also pins the f32 GEMM rules the port's plain
    path relies on: true IEEE f32, never TF32 (``allow_tf32 = False``,
    ``float32_matmul_precision = "highest"``; both are PyTorch's defaults,
    set here so that no earlier caller's choice leaks into a solve).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False (no usable NVIDIA card); pass device='cpu' for the "
                "plain CPU path"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A card's tuning and reporting constants.

    ``family``, ``measured``, ``bf16_tflops``, ``f32_tflops``,
    ``max_fused_k`` and :meth:`peak_tflops` are the fields of JAX's row:
    the dense bf16 tensor-core peak, the f32 peak (on the H100 the SIMT
    units' f32 FMA rate: the ``float32`` policy never runs on TF32), and
    the largest rank the fused kernels take.  ``sm_count`` and
    ``smem_bytes`` (shared memory an SM) describe the card the kernels'
    fixed launch plans were sized for.  The ``f32_jnp_*`` and
    ``batched_jnp_max_k`` fields are the measured backend rule of
    :func:`nmf_tpu_torch.utils.autotune.rule_pick`, ``tiled_f32_max_k``
    that of :func:`nmf_tpu_torch.ops.kernels.tile_sparse.preferred`.
    """

    family: str                      # short label ("h100", "generic")
    measured: bool                   # True only for rows measured in this repo
    bf16_tflops: Optional[float]     # dense bf16 tensor-core peak
    f32_tflops: Optional[float]      # f32 peak (SIMT FMA)
    max_fused_k: int = 2048          # largest rank the fused kernels take
    sm_count: Optional[int] = None   # streaming multiprocessors
    smem_bytes: Optional[int] = None  # shared memory an SM
    # rule_pick: a 2-D step with f32 GEMMs on f32 state (``float32``
    # policy; X f32, bf16 or int8) takes cuBLAS when K >= f32_jnp_min_k and
    # M * N >= f32_jnp_min_elements (None: never)
    f32_jnp_min_k: Optional[int] = None
    f32_jnp_min_elements: int = 0
    # rule_pick: a step over a member axis (batched, restarts, rank sweeps)
    # under float32 or bfloat16 GEMMs on f32 X and state takes cuBLAS's
    # batched GEMMs when K <= batched_jnp_max_k (None: never)
    batched_jnp_max_k: Optional[int] = None
    # preferred: the f32 sweeps (float32 policy, f32 tiles and state) take
    # the plain sweep above this rank (None: never)
    tiled_f32_max_k: Optional[int] = None

    def peak_tflops(self, matmul_dtype: str) -> Optional[float]:
        if matmul_dtype == "float32":
            return self.f32_tflops
        if matmul_dtype == "float32_fast":
            # 3-pass bf16 split-float: ceiling is a third of the bf16 peak
            return self.bf16_tflops / 3.0 if self.bf16_tflops else None
        return self.bf16_tflops


# The one measured row: NVIDIA H100 80GB HBM3 (SXM5, 700 W): 132 SMs, 228
# KiB of shared memory an SM, 989 TFLOP/s dense bf16, 67 TFLOP/s f32 (the
# peaks chip_smoke.py's bounds use).  The rule fields come from three
# sessions of ``chip_smoke.py --phases card,backend`` (PERF.md, "Backend
# rule"), each decision taken only where the loser's pooled median lay
# outside the winner's interquartile range, and bounded by the shapes
# measured: the flagship 10240^2 K=256 is the only f32 shape at K >= 256,
# config 4 (K=32) and 16 restarts (K=32) the member-axis shapes, and K5
# lost only at K=384 in f32 (won at 256).
_H100 = ChipSpec(
    family="h100", measured=True, bf16_tflops=989.0, f32_tflops=67.0,
    max_fused_k=2048, sm_count=132, smem_bytes=228 * 1024,
    f32_jnp_min_k=256, f32_jnp_min_elements=10240 * 10240,
    batched_jnp_max_k=32, tiled_f32_max_k=256,
)

# Every other card, and the CPU: no peak claims, no card facts; the H100's
# rule as the default (the only rule measured; "autotune" measures instead).
GENERIC = dataclasses.replace(
    _H100, family="generic", measured=False, bf16_tflops=None, f32_tflops=None,
    sm_count=None, smem_bytes=None,
)

# Ordered (substring of the lower-cased device name, spec); first match wins.
_TABLE = (
    ("h100 80gb hbm3", _H100),
)


def chip_spec_for(device_kind: str) -> ChipSpec:
    """Resolve a device name (``torch.cuda.get_device_name()``) to its row
    (:data:`GENERIC` if unknown)."""
    kind = (device_kind or "").lower()
    for needle, spec in _TABLE:
        if needle in kind:
            return spec
    return GENERIC


@functools.lru_cache(maxsize=None)
def _cached_spec(kind: str) -> ChipSpec:
    return chip_spec_for(kind)


def chip_spec(device=None) -> ChipSpec:
    """The row of ``device`` (a ``torch.device`` or its string; default:
    CUDA device 0 when a card is visible).  A CPU device, or no card,
    gives :data:`GENERIC`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return GENERIC
    return _cached_spec(torch.cuda.get_device_name(dev))
