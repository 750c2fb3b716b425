"""Solvers (the plain MU solve so far)."""

from .init import random_init
from .solver import SolveResult, resolve_step_fn, run_checked_loop, solve

__all__ = ["SolveResult", "random_init", "resolve_step_fn", "run_checked_loop", "solve"]
