"""nmf_tpu_torch — the PyTorch / CUDA port of ``nmf_tpu`` for NVIDIA Hopper.

KL-divergence Lee-Seung multiplicative updates with the reference's
semantics (``recoord/nmf-gpu``), byte-compatible ``.bin`` I/O and the
fixed-iteration determinism contract.  The update and cost hot path runs in
hand-written CUDA kernels (``csrc/fused_mu.cu``) on CUDA tensors and in
plain torch ops on CPU tensors; so do the numerator sweeps of the
tile-sparse solve (``csrc/tile_sparse.cu``).  ``solve_out_of_core`` streams
an X that the card cannot hold from the host in column blocks.  Each solve
takes ``accelerate=True`` (the safeguarded Nesterov loop); ``solve_strict``
replays the reference's padded-EPS numerics.  The beta-divergence, HALS and
penalized KL families run on plain torch ops, as in JAX.  ``NMF`` (fit /
transform), ``solve_h_only``, ``solve_w_only`` and ``transform_out_of_core``
are the inference path: H refit against a fixed W, through K1 and K3 on
the KL family.  Imports torch and NumPy, never JAX.

Quick start::

    import nmf_tpu_torch as nt
    res = nt.solve(X, W0, H0, nt.reference_preset(), device="cuda")
    nt.write_matrix(res.w.cpu().numpy(), "Wout.bin")
    est = nt.NMF(n_components=32, device="cuda").fit(X)
    H_new = est.transform(X_new)                  # W fixed, H refit
"""

from .io import fixtures
from .io.binio import read_matrix, write_matrix
from .models.init import nndsvd_init, random_init, scaled_random_init
from .models.nmf import NMF, normalize_factors, solve_h_only, solve_w_only
from .models.solver import SolveResult, solve
from .models.sparse_tiled import (
    TileSparseX,
    solve_sparse_tiled,
    tiles_from_coo,
    tiles_from_dense,
)
from .models.streaming import (
    ArrayColumnSource,
    BinColumnSource,
    TransformResult,
    pick_block_n,
    solve_out_of_core,
    transform_out_of_core,
)
from .models.strict import solve_strict
from .ops.divergence import beta_divergence, euclidean_cost, itakura_saito, kl_divergence
from .ops.elementwise import EPS, eps_clamp
from .ops.mu import mu_step, mu_step_beta, update_h, update_w
from .utils.config import Precision, SolveConfig, reference_preset

__version__ = "0.1.0"

__all__ = [
    "read_matrix",
    "write_matrix",
    "fixtures",
    "EPS",
    "eps_clamp",
    "kl_divergence",
    "euclidean_cost",
    "itakura_saito",
    "beta_divergence",
    "mu_step",
    "mu_step_beta",
    "update_h",
    "update_w",
    "solve",
    "solve_strict",
    "solve_h_only",
    "solve_w_only",
    "normalize_factors",
    "NMF",
    "SolveResult",
    "random_init",
    "scaled_random_init",
    "nndsvd_init",
    "TileSparseX",
    "solve_sparse_tiled",
    "tiles_from_coo",
    "tiles_from_dense",
    "solve_out_of_core",
    "ArrayColumnSource",
    "BinColumnSource",
    "pick_block_n",
    "transform_out_of_core",
    "TransformResult",
    "SolveConfig",
    "Precision",
    "reference_preset",
    "__version__",
]
