"""Configuration, device selection, cross-package conversion, metrics,
checkpointing, guards, profiling and the environment doctor."""

from .checkpoint import (
    CheckpointState,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    solve_with_checkpoints,
)
from .config import EPS_DEFAULT, Precision, SolveConfig, reference_preset
from .device import resolve_device
from .guards import GuardError, validate_input, validate_result
from .metrics import MetricsLogger, RunReport

__all__ = [
    "EPS_DEFAULT",
    "Precision",
    "SolveConfig",
    "reference_preset",
    "resolve_device",
    "CheckpointState",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "solve_with_checkpoints",
    "MetricsLogger",
    "RunReport",
    "GuardError",
    "validate_input",
    "validate_result",
]
