"""Configuration, device selection, cross-package conversion and metrics."""

from .config import EPS_DEFAULT, Precision, SolveConfig, reference_preset
from .device import resolve_device

__all__ = ["EPS_DEFAULT", "Precision", "SolveConfig", "reference_preset", "resolve_device"]
