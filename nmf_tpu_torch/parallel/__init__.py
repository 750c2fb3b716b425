"""Parallel execution: the device mesh, the sharded solves, the batched solver."""

from .batched import solve_batched
from .mesh import (
    COL_AXIS,
    ROW_AXIS,
    gather,
    init_distributed,
    make_mesh,
    nmf_shardings,
    shard_problem,
)
from .sharded import gather_result, mu_step_sharded, solve_sharded

__all__ = [
    "ROW_AXIS",
    "COL_AXIS",
    "make_mesh",
    "nmf_shardings",
    "shard_problem",
    "solve_sharded",
    "solve_batched",
    "mu_step_sharded",
    "init_distributed",
    "gather",
    "gather_result",
]
