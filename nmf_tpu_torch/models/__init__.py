"""Solvers: the dense MU solve (plain or accelerated), the strict
reference-replication solve, the out-of-core streamed solve and the
tile-sparse solve; the factor inits."""

from .init import nndsvd_init, random_init, scaled_random_init
from .solver import SolveResult, resolve_step_fn, run_checked_loop, solve
from .sparse_tiled import TileSparseX, solve_sparse_tiled, tiles_from_coo, tiles_from_dense
from .streaming import ArrayColumnSource, BinColumnSource, pick_block_n, solve_out_of_core
from .strict import PAD_MULT, pad_to_mult, solve_strict

__all__ = [
    "PAD_MULT",
    "ArrayColumnSource",
    "BinColumnSource",
    "SolveResult",
    "TileSparseX",
    "pick_block_n",
    "nndsvd_init",
    "pad_to_mult",
    "random_init",
    "resolve_step_fn",
    "run_checked_loop",
    "scaled_random_init",
    "solve",
    "solve_out_of_core",
    "solve_sparse_tiled",
    "solve_strict",
    "tiles_from_coo",
    "tiles_from_dense",
]
