"""Solvers: the dense solve of every family (plain or accelerated), the
strict reference-replication solve, the out-of-core streamed solve and
transform, the tile-sparse solve, the H-only and W-only solves and the
``NMF`` estimator; the semi-adaptive solve and source separation, the
masked solves and the online learner; restarts, rank sweeps and the
stability study, and the batched tile-sparse solve; the deprecated COO
sparse solve; the factor inits."""

from .init import nndsvd_init, random_init, scaled_random_init
from .masked import mu_step_masked, masked_kl, solve_masked, solve_masked_h_only
from .nmf import NMF, normalize_factors, solve_h_only, solve_w_only
from .online import OnlineResult, solve_online
from .selection import SelectionResult, solve_rank_sweep, solve_restarts
from .semi import solve_semi
from .separation import SeparationResult, istft, separate, stft
from .solver import SolveResult, resolve_step_fn, run_checked_loop, solve, solve_jit
from .sparse import SparseX, solve_sparse, sparse_from_dense
from .sparse_tiled import (
    TileSparseX,
    solve_sparse_tiled,
    solve_sparse_tiled_batched,
    tiles_from_coo,
    tiles_from_dense,
)
from .stability import StabilityResult, consensus_matrix, rank_stability
from .streaming import (
    ArrayColumnSource,
    BinColumnSource,
    TransformResult,
    pick_block_n,
    solve_out_of_core,
    transform_out_of_core,
)
from .strict import PAD_MULT, pad_to_mult, solve_strict

__all__ = [
    "NMF",
    "OnlineResult",
    "PAD_MULT",
    "ArrayColumnSource",
    "BinColumnSource",
    "SelectionResult",
    "SeparationResult",
    "SolveResult",
    "StabilityResult",
    "SparseX",
    "TileSparseX",
    "TransformResult",
    "pick_block_n",
    "consensus_matrix",
    "istft",
    "masked_kl",
    "mu_step_masked",
    "nndsvd_init",
    "normalize_factors",
    "pad_to_mult",
    "random_init",
    "rank_stability",
    "resolve_step_fn",
    "run_checked_loop",
    "scaled_random_init",
    "separate",
    "solve",
    "solve_h_only",
    "solve_masked",
    "solve_masked_h_only",
    "solve_online",
    "solve_out_of_core",
    "solve_rank_sweep",
    "solve_restarts",
    "solve_semi",
    "solve_sparse",
    "solve_sparse_tiled",
    "solve_sparse_tiled_batched",
    "solve_strict",
    "solve_jit",
    "solve_w_only",
    "sparse_from_dense",
    "stft",
    "tiles_from_coo",
    "tiles_from_dense",
    "transform_out_of_core",
]
