"""Factor initialization (NumPy), counterpart of ``nmf_tpu.models.init``.

Only the uniform random init is ported so far; the scaled and NNDSVD
variants come with the model families (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["random_init"]


def random_init(m: int, k: int, n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform[0,1) W and H from NumPy's legacy RandomState (matrix_export.py:4-7)."""
    rng = np.random.RandomState(seed)
    w = rng.rand(m, k).astype(np.float32)
    h = rng.rand(k, n).astype(np.float32)
    return w, h
