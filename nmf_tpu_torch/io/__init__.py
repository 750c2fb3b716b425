"""``.bin`` I/O, the native C++ reader, batch datasets and the reference
fixtures (NumPy, no device)."""

from . import binio, fixtures, native
from .binio import read_matrix, write_matrix
from .dataset import BinDataset

__all__ = ["binio", "fixtures", "native", "read_matrix", "write_matrix", "BinDataset"]
