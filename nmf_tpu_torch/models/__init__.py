"""Solvers: the dense MU solve, the out-of-core streamed solve and the
tile-sparse solve."""

from .init import random_init
from .solver import SolveResult, resolve_step_fn, run_checked_loop, solve
from .sparse_tiled import TileSparseX, solve_sparse_tiled, tiles_from_coo, tiles_from_dense
from .streaming import ArrayColumnSource, BinColumnSource, pick_block_n, solve_out_of_core

__all__ = [
    "ArrayColumnSource",
    "BinColumnSource",
    "SolveResult",
    "TileSparseX",
    "pick_block_n",
    "random_init",
    "resolve_step_fn",
    "run_checked_loop",
    "solve",
    "solve_out_of_core",
    "solve_sparse_tiled",
    "tiles_from_coo",
    "tiles_from_dense",
]
