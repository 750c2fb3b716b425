"""Solvers: the dense solve of every family (plain or accelerated), the
strict reference-replication solve, the out-of-core streamed solve and
transform, the tile-sparse solve, the H-only and W-only solves and the
``NMF`` estimator; the factor inits."""

from .init import nndsvd_init, random_init, scaled_random_init
from .nmf import NMF, normalize_factors, solve_h_only, solve_w_only
from .solver import SolveResult, resolve_step_fn, run_checked_loop, solve
from .sparse_tiled import TileSparseX, solve_sparse_tiled, tiles_from_coo, tiles_from_dense
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
    "PAD_MULT",
    "ArrayColumnSource",
    "BinColumnSource",
    "SolveResult",
    "TileSparseX",
    "TransformResult",
    "pick_block_n",
    "nndsvd_init",
    "normalize_factors",
    "pad_to_mult",
    "random_init",
    "resolve_step_fn",
    "run_checked_loop",
    "scaled_random_init",
    "solve",
    "solve_h_only",
    "solve_out_of_core",
    "solve_sparse_tiled",
    "solve_strict",
    "solve_w_only",
    "tiles_from_coo",
    "tiles_from_dense",
    "transform_out_of_core",
]
