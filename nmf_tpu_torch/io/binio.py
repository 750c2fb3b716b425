"""Binary ``.bin`` matrix format, byte-compatible with the reference.

Format (reference ``cuda/nmf.cu:188-259``)::

    u32 rows | u32 cols | rows*cols float32 payload, **column-major**

Counterpart of ``nmf_tpu.io.binio``: the same bytes in both directions, the
same errors for truncated and missing files.  Reads and writes go through
the native C++ library (:mod:`nmf_tpu_torch.io.native`) when it is built,
as in JAX, and through NumPy otherwise or when ``NMF_TPU_NO_NATIVE=1``;
both give the same bytes.  Arrays are NumPy here: the solver moves them to
its device.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Tuple, Union

import numpy as np

__all__ = [
    "read_matrix",
    "write_matrix",
    "read_header",
    "pack_header",
    "MAGICLESS_HEADER_BYTES",
]

# Two little-endian uint32s: rows, cols (pinned little-endian, as the
# reference's native-endian fread on x86 reads them).
_HEADER = struct.Struct("<II")
MAGICLESS_HEADER_BYTES = _HEADER.size  # 8


def pack_header(rows: int, cols: int) -> bytes:
    """The 8-byte (rows, cols) header."""
    return _HEADER.pack(rows, cols)


def read_header(f: BinaryIO) -> Tuple[int, int]:
    """Read the (rows, cols) header from an open binary stream."""
    raw = f.read(_HEADER.size)
    if len(raw) != _HEADER.size:
        raise ValueError("truncated .bin header")
    rows, cols = _HEADER.unpack(raw)
    return rows, cols


def _native():
    """The native library's module, or None (``NMF_TPU_NO_NATIVE=1``
    disables it)."""
    if os.environ.get("NMF_TPU_NO_NATIVE") == "1":
        return None
    from . import native

    return native if native.available() else None


def read_matrix(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read a ``.bin`` matrix exactly as the reference reader does.

    Returns a C-contiguous ``(rows, cols)`` float32 array whose element
    ``[i, j]`` is payload word ``i + j*rows`` (column-major, nmf.cu:189).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(2, "no such .bin file", os.fspath(path))
    nat = _native()
    if nat is not None:
        return nat.read_matrix_native(os.fspath(path))
    with open(path, "rb") as f:
        rows, cols = read_header(f)
        count = rows * cols
        payload = np.fromfile(f, dtype="<f4", count=count)
    if payload.size != count:
        raise ValueError(
            f"truncated .bin payload in {path}: expected {count} f32 words, "
            f"got {payload.size}"
        )
    return np.ascontiguousarray(payload.reshape((rows, cols), order="F"))


def write_matrix(arr, path: Union[str, os.PathLike]) -> None:
    """Write a matrix in the reference ``.bin`` format (column-major payload).

    Accepts a NumPy array or anything ``np.asarray`` takes (a CPU tensor);
    a CUDA tensor must be brought to the host by the caller.
    """
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError(f".bin format is 2-D only, got shape {arr.shape}")
    arr = arr.astype("<f4", copy=False)
    nat = _native()
    if nat is not None:
        nat.write_matrix_native(arr, os.fspath(path))
        return
    rows, cols = arr.shape
    with open(path, "wb") as f:
        f.write(_HEADER.pack(rows, cols))
        # one strided copy straight into column-major bytes
        f.write(arr.tobytes(order="F"))
