"""Deterministic test fixtures, replicating the reference generator.

Counterpart of ``nmf_tpu.io.fixtures``.  The reference's
``matrix_export.py:1-17`` seeds NumPy with 0 and writes ``X.bin``
(4096x350), ``W.bin`` (4096x128) and ``H.bin`` (128x350) as
``struct.pack("ii", rows, cols)`` plus **C-order** bytes, which the
column-major reader (nmf.cu:189) then reinterprets.  The bytes here are
identical to that generator's, and :func:`as_seen_by_solver` gives the
matrices the solver actually factorizes.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "REFERENCE_SHAPES",
    "reference_fixture_arrays",
    "write_reference_fixtures",
    "as_seen_by_solver",
    "random_nonneg",
]

# (rows, cols) as written in the file headers (matrix_export.py:5-7).
REFERENCE_SHAPES: Dict[str, Tuple[int, int]] = {
    "X": (4096, 350),
    "W": (4096, 128),
    "H": (128, 350),
}


def reference_fixture_arrays() -> Dict[str, np.ndarray]:
    """The exact arrays the reference generator creates (seed 0, C-order)."""
    rng = np.random.RandomState(0)
    return {
        name: rng.rand(r, c).astype(np.float32)
        for name, (r, c) in REFERENCE_SHAPES.items()
    }


def as_seen_by_solver(arr: np.ndarray) -> np.ndarray:
    """C-order bytes read back as column-major: flatten in C order, reshape
    in Fortran order."""
    r, c = arr.shape
    return np.ascontiguousarray(
        arr.astype(np.float32).reshape(-1).reshape((r, c), order="F")
    )


def write_reference_fixtures(directory) -> Dict[str, str]:
    """Write X.bin, W.bin and H.bin byte-identically to the reference
    generator (matrix_export.py:9-13)."""
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for name, arr in reference_fixture_arrays().items():
        path = os.path.join(str(directory), f"{name}.bin")
        with open(path, "wb") as f:
            f.write(struct.pack("ii", *arr.shape))
            f.write(arr.tobytes())
        paths[name] = path
    return paths


def random_nonneg(
    shape: Tuple[int, ...],
    seed: int = 0,
    dtype=np.float32,
    low: float = 0.0,
    high: float = 1.0,
) -> np.ndarray:
    """Uniform non-negative random array for tests and benchmarks."""
    rng = np.random.RandomState(seed)
    return (low + (high - low) * rng.rand(*shape)).astype(dtype)
