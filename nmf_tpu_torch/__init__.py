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
the KL family.  ``solve_semi`` freezes the first dictionary columns (the
paper's drum templates) and ``separate`` runs the paper's pipeline (STFT,
KL-NMF through K1-K3, Wiener masks, ISTFT); ``solve_masked`` and
``solve_masked_h_only`` fit the observed entries of X, and
``solve_online`` learns W in one pass over a column stream, on plain torch
ops as in JAX.  ``solve_batched`` factorizes a stack of problems, and
``solve_restarts``, ``solve_rank_sweep`` and ``rank_stability`` run model
selection, each as one batched solve whose K1-K3 launches (under
``backend="pallas"``, or where the rule keeps the kernels) serve every
member (``solve_sparse_tiled_batched`` on the plain sweeps).
``make_mesh`` and ``solve_sharded`` shard a solve over the ranks of a
``torch.distributed`` mesh (one process a card; K1/K2 ``numerator_only``
on each rank's block, K-sized all-reduces), and so do ``mesh=`` of
``solve_h_only``, ``solve_semi``, ``solve_masked``, ``solve_masked_h_only``
and ``NMF``; ``gather_result`` puts the global W and H on every rank.
``backend="auto"`` picks the kernels or cuBLAS per shape by the card's
measured rule, ``"autotune"`` by a measurement cached on disk
(``utils.autotune``).  ``solve_sparse`` (deprecated) factorizes COO
nonzeros on plain torch ops.
``BinDataset`` reads a directory of ``.bin`` files as one batch, through
the native C++ reader (``native/binio.cpp``) when it is built;
``utils.solve_with_checkpoints`` and ``solve_out_of_core(checkpoint_dir=)``
checkpoint and resume in JAX's format, ``live_metrics`` streams each check,
``utils.profiling`` times the stages and ``python -m nmf_tpu_torch doctor``
checks the card.  Imports torch and NumPy, never JAX.

Quick start::

    import nmf_tpu_torch as nt
    res = nt.solve(X, W0, H0, nt.reference_preset(), device="cuda")
    nt.write_matrix(res.w.cpu().numpy(), "Wout.bin")
    est = nt.NMF(n_components=32, device="cuda").fit(X)
    H_new = est.transform(X_new)                  # W fixed, H refit
"""

from .io import fixtures
from .io.binio import read_matrix, write_matrix
from .io.dataset import BinDataset
from .models.init import nndsvd_init, random_init, scaled_random_init
from .models.masked import solve_masked, solve_masked_h_only
from .models.nmf import NMF, normalize_factors, solve_h_only, solve_w_only
from .models.online import OnlineResult, solve_online
from .models.selection import SelectionResult, solve_rank_sweep, solve_restarts
from .models.semi import solve_semi
from .models.separation import separate
from .models.solver import SolveResult, solve
from .models.sparse import SparseX, solve_sparse, sparse_from_dense
from .models.sparse_tiled import (
    TileSparseX,
    solve_sparse_tiled,
    solve_sparse_tiled_batched,
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
from .models.stability import StabilityResult, consensus_matrix, rank_stability
from .models.strict import solve_strict
from .ops.divergence import beta_divergence, euclidean_cost, itakura_saito, kl_divergence
from .ops.elementwise import EPS, eps_clamp
from .ops.mu import mu_step, mu_step_beta, update_h, update_w
from .parallel.batched import solve_batched
from .parallel.mesh import COL_AXIS, ROW_AXIS, init_distributed, make_mesh, nmf_shardings, shard_problem
from .parallel.sharded import gather_result, mu_step_sharded, solve_sharded
from .utils.config import Precision, SolveConfig, reference_preset

__version__ = "0.1.0"

__all__ = [
    "read_matrix",
    "write_matrix",
    "BinDataset",
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
    "solve_semi",
    "solve_masked",
    "solve_masked_h_only",
    "separate",
    "solve_online",
    "OnlineResult",
    "solve_h_only",
    "solve_w_only",
    "normalize_factors",
    "NMF",
    "SolveResult",
    "random_init",
    "scaled_random_init",
    "nndsvd_init",
    "SparseX",
    "solve_sparse",
    "sparse_from_dense",
    "TileSparseX",
    "solve_sparse_tiled",
    "solve_sparse_tiled_batched",
    "tiles_from_coo",
    "tiles_from_dense",
    "solve_out_of_core",
    "ArrayColumnSource",
    "BinColumnSource",
    "pick_block_n",
    "transform_out_of_core",
    "TransformResult",
    "solve_batched",
    "make_mesh",
    "solve_sharded",
    "gather_result",
    "init_distributed",
    "ROW_AXIS",
    "COL_AXIS",
    "nmf_shardings",
    "shard_problem",
    "mu_step_sharded",
    "solve_restarts",
    "solve_rank_sweep",
    "SelectionResult",
    "rank_stability",
    "consensus_matrix",
    "StabilityResult",
    "SolveConfig",
    "Precision",
    "reference_preset",
    "__version__",
]
