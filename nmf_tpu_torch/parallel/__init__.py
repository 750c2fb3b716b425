"""Many factorizations in one solve: the batched solver."""

from .batched import solve_batched

__all__ = ["solve_batched"]
