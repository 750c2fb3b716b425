"""Solvers: the dense MU solve and the tile-sparse solve."""

from .init import random_init
from .solver import SolveResult, resolve_step_fn, run_checked_loop, solve
from .sparse_tiled import TileSparseX, solve_sparse_tiled, tiles_from_coo, tiles_from_dense

__all__ = [
    "SolveResult",
    "TileSparseX",
    "random_init",
    "resolve_step_fn",
    "run_checked_loop",
    "solve",
    "solve_sparse_tiled",
    "tiles_from_coo",
    "tiles_from_dense",
]
