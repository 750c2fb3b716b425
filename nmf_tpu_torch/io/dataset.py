"""Batch dataset loading: a directory of ``.bin`` matrices as ``[B, M, N]``.

Counterpart of ``nmf_tpu.io.dataset``.  The batched solver (BASELINE.json
config 4: 128 independent spectrograms) takes its inputs as one ``[B, M,
N]`` array; this module reads a directory of reference-format ``.bin``
files into exactly that, in parallel on a thread pool (the native C++
reader releases the GIL inside its ctypes call, so the threads read at
once; the NumPy path still overlaps page-cache misses).  The arrays are
NumPy: the solver moves them to its device.

    ds = BinDataset("spectrograms/")
    x = ds.load_batch()                  # all files, stacked [B, M, N]
    for xb in ds.iter_batches(16):       # or streamed in chunks
        ...
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import binio

__all__ = ["BinDataset"]


class BinDataset:
    """A directory (or explicit list) of same-shaped ``.bin`` matrices,
    sorted by path; the shape is the first file's."""

    def __init__(self, source, pattern: str = ".bin", max_workers: int = 8):
        if isinstance(source, (str, os.PathLike)):
            directory = os.fspath(source)
            self.paths: List[str] = sorted(
                p
                for p in (os.path.join(directory, f) for f in os.listdir(directory))
                if p.endswith(pattern) and os.path.isfile(p)
            )
        else:
            self.paths = [os.fspath(p) for p in source]
        if not self.paths:
            raise ValueError(f"no {pattern} files found in {source!r}")
        self.max_workers = max_workers
        with open(self.paths[0], "rb") as f:
            self.shape: Tuple[int, int] = binio.read_header(f)

    def __len__(self) -> int:
        return len(self.paths)

    def _read_checked(self, path: str) -> np.ndarray:
        a = binio.read_matrix(path)
        if a.shape != self.shape:
            raise ValueError(
                f"{path}: shape {a.shape} != dataset shape {self.shape} "
                f"(from {self.paths[0]})"
            )
        return a

    def load_batch(self, indices: Optional[Sequence[int]] = None) -> np.ndarray:
        """Read (a subset of) the files in parallel; returns [B, M, N] f32."""
        paths = self.paths if indices is None else [self.paths[i] for i in indices]
        if not paths:
            raise ValueError("load_batch: empty index selection")
        workers = min(self.max_workers, len(paths))
        if workers <= 1:
            mats = [self._read_checked(p) for p in paths]
        else:
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                mats = list(pool.map(self._read_checked, paths))
        return np.stack(mats)

    def iter_batches(self, batch_size: int, drop_remainder: bool = False) -> Iterator[np.ndarray]:
        """Stream the dataset in [batch_size, M, N] chunks, in path order,
        one thread pool serving the whole iteration."""
        if batch_size <= 0:
            raise ValueError("batch_size must be >= 1")
        workers = min(self.max_workers, batch_size)
        with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            for start in range(0, len(self.paths), batch_size):
                idx = range(start, min(start + batch_size, len(self.paths)))
                if drop_remainder and len(idx) < batch_size:
                    return
                paths = [self.paths[i] for i in idx]
                yield np.stack(list(pool.map(self._read_checked, paths)))
