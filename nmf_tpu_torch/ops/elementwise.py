"""Elementwise primitives with the reference's epsilon semantics.

The reference applies ``EPS = 2.2204E-16f`` (cuda/matrix.cu:10) as a
**clamp**, ``if (a[i] < EPS) a[i] = EPS`` (cuda/matrix.cu:182-188), never
as an add.  Counterpart of ``nmf_tpu.ops.elementwise``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["EPS", "eps_clamp"]

# float32(2.2204e-16), bit-identical to the reference constant; the
# kernels receive it as a C float, never as the double 2.2204e-16.
EPS = np.float32(2.2204e-16)


def eps_clamp(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """``max(x, eps)`` elementwise: the reference's ``set_epsilon``.

    NaN stays NaN, as in the reference (``NaN < EPS`` is false) and in
    ``jnp.maximum``; ``torch.clamp_min`` propagates NaN the same way.
    """
    return torch.clamp_min(x, float(eps))
