"""Hand-written CUDA kernels for Hopper, counterpart of ``nmf_tpu.ops.pallas``.

Sources live in ``nmf_tpu_torch/csrc/``; they are compiled with ``nvcc`` at
first use on a machine with a card (:mod:`._build`), never at import.
"""

from . import fused_mu, tile_sparse

__all__ = ["fused_mu", "tile_sparse"]
