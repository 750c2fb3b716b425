"""Configuration dataclasses, field for field those of ``nmf_tpu.utils.config``.

The reference's configuration is compile-time macros (``ITER_CHECK 25``,
``MAX_ITER 200``, ``CONVERGE_THRESH 0`` at nmf.cu:9-11); here they are
runtime fields with the reference values as :func:`reference_preset`.

Precision on the card.  The JAX package maps each policy to a
``jax.lax.Precision``; the port follows the H100 rules instead, and spells
each policy out in its own arithmetic (:func:`nmf_tpu_torch.ops.mu.matmul`
and ``csrc/fused_mu.cu``), never through a library precision flag:

* ``"float32"``: true IEEE f32, never TF32
  (``torch.backends.cuda.matmul.allow_tf32 = False`` and
  ``torch.set_float32_matmul_precision("highest")``, set by
  :func:`nmf_tpu_torch.utils.device.resolve_device`);
* ``"float32_fast"``: the 3-pass bf16 split ``hi*bh + hi*bl + lo*bh`` of
  the TPU kernels' ``_prep_operand``/``_kdot`` (on CUDA,
  ``float32_matmul_precision("high")`` would mean TF32, not this);
* ``"bfloat16"``: operands rounded to bf16 (nearest even), products summed
  in f32.

Accumulation is always f32.

``backend`` takes the JAX package's strings: ``"pallas"`` means the
hand-written CUDA kernels for CUDA tensors, ``"jnp"`` plain torch ops
(cuBLAS on the card); ``"auto"`` picks one of the two per shape by the
card's measured rule and ``"autotune"`` by a measurement cached on disk
(:mod:`nmf_tpu_torch.utils.autotune`).  CPU tensors keep the kernel
wrappers' plain versions under ``"auto"`` and ``"autotune"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Precision", "SolveConfig", "reference_preset", "EPS_DEFAULT"]

EPS_DEFAULT = float(np.float32(2.2204e-16))  # cuda/matrix.cu:10


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy for the update step.

    * ``matmul_dtype``: ``"float32"`` (true f32 GEMMs, reference parity),
      ``"float32_fast"`` (3-pass bf16 split) or ``"bfloat16"``.
    * ``state_dtype``: dtype W and H are carried in between iterations.
    * ``x_dtype``: storage dtype of X (``"float32"``, ``"bfloat16"``,
      ``"int8"`` codes with per-column scales).
    * ``x_quant_rows``: int8 scale granularity, 0 = one scale per column;
      N > 0 = one scale per (N-row block, column), which the kernels do not
      take: the solver sends such X to the plain ops on dequantized values.
    """

    matmul_dtype: str = "float32"
    state_dtype: str = "float32"
    x_dtype: str = "float32"
    x_quant_rows: int = 0

    def validate(self) -> None:
        if self.matmul_dtype not in ("float32", "float32_fast", "bfloat16"):
            raise ValueError(f"unsupported matmul_dtype {self.matmul_dtype!r}")
        if self.state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported state_dtype {self.state_dtype!r}")
        if self.x_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unsupported x_dtype {self.x_dtype!r}")
        if self.x_quant_rows < 0:
            raise ValueError("x_quant_rows must be >= 0")
        if self.x_quant_rows and self.x_dtype != "int8":
            raise ValueError("x_quant_rows requires x_dtype='int8'")

    @property
    def mm_input_dtype(self) -> str:
        """Dtype GEMM inputs are cast to (f32 for both f32 policies)."""
        return "bfloat16" if self.matmul_dtype == "bfloat16" else "float32"


FP32 = Precision("float32", "float32")
BF16 = Precision("bfloat16", "float32")
BF16_FULL = Precision("bfloat16", "float32", "bfloat16")  # bf16 X storage too


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Full solver configuration (the fields of ``nmf_tpu``'s, same defaults).

    ``thresh == 0`` guarantees exactly ``max_iter`` iterations (nmf.cu:11);
    ``check_every`` is the reference's ``ITER_CHECK`` (nmf.cu:9).
    """

    max_iter: int = 200
    thresh: float = 0.0
    check_every: int = 25
    eps: float = EPS_DEFAULT
    precision: Precision = FP32
    backend: str = "auto"                # "auto" | "jnp" | "pallas" | "autotune"
    track_cost: bool = True
    live_metrics: bool = False
    beta: float = 1.0
    algorithm: str = "mu"                # "mu" | "hals"
    l1_w: float = 0.0
    l1_h: float = 0.0
    l2_w: float = 0.0
    l2_h: float = 0.0
    accelerate: bool = False
    accel_momentum: float = 0.5
    accel_momentum_max: float = 0.95
    accel_grow: float = 1.05
    accel_shrink: float = 0.5

    def validate(self) -> None:
        if self.max_iter < 0:
            raise ValueError("max_iter must be >= 0")
        if self.check_every <= 0:
            raise ValueError("check_every must be >= 1")
        if self.thresh < 0:
            raise ValueError("thresh must be >= 0")
        if self.backend not in ("auto", "jnp", "pallas", "autotune"):
            raise ValueError(f"unsupported backend {self.backend!r}")
        if self.algorithm not in ("mu", "hals"):
            raise ValueError(f"unsupported algorithm {self.algorithm!r}")
        if self.algorithm == "hals" and self.beta != 2.0:
            raise ValueError("HALS minimizes the Frobenius cost: use beta=2.0")
        if self.algorithm == "hals" and self.regularized:
            raise ValueError("regularization is implemented for the MU algorithm")
        if min(self.l1_w, self.l1_h, self.l2_w, self.l2_h) < 0:
            raise ValueError("regularization strengths must be >= 0")
        if self.regularized and self.beta != 1.0:
            raise ValueError("regularization is implemented for the KL (beta=1) family")
        if self.accelerate:
            if not (0.0 <= self.accel_momentum <= self.accel_momentum_max):
                raise ValueError(
                    "need 0 <= accel_momentum <= accel_momentum_max"
                )
            if self.accel_momentum_max >= 1.0:
                raise ValueError("accel_momentum_max must be < 1")
            if self.accel_grow < 1.0:
                raise ValueError("accel_grow must be >= 1")
            if not (0.0 < self.accel_shrink <= 1.0):
                raise ValueError("accel_shrink must be in (0, 1]")
        if self.live_metrics and not (self.track_cost or self.thresh > 0):
            raise ValueError(
                "live_metrics streams the per-check cost; enable track_cost "
                "(or a nonzero thresh)"
            )
        self.precision.validate()

    @property
    def regularized(self) -> bool:
        return (self.l1_w + self.l1_h + self.l2_w + self.l2_h) > 0.0

    @property
    def num_checks(self) -> int:
        """Number of cost-check points over a full-length run."""
        return -(-self.max_iter // self.check_every) if self.max_iter else 0


def reference_preset() -> SolveConfig:
    """The reference binary's behaviour: 200 fixed iterations, fp32
    (nmf.cu:9-11: ITER_CHECK 25, MAX_ITER 200, CONVERGE_THRESH 0)."""
    return SolveConfig(
        max_iter=200,
        thresh=0.0,
        check_every=25,
        precision=FP32,
        backend="auto",
        track_cost=True,
    )
