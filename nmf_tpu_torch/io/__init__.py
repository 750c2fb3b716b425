"""``.bin`` I/O and the reference fixtures (NumPy, no device)."""

from . import binio, fixtures
from .binio import read_matrix, write_matrix

__all__ = ["binio", "fixtures", "read_matrix", "write_matrix"]
