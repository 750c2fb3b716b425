"""ctypes binding to the native C++ ``.bin`` reader and writer.

Counterpart of ``nmf_tpu.io.native`` over the same library: ``libnmfio.so``
built from ``native/binio.cpp`` (``make -C native``, or any ``g++ -O3
-std=c++17 -fPIC -shared`` build of that file).  Every entry point gives the
bytes of the NumPy path of :mod:`nmf_tpu_torch.io.binio`.

Search order for the shared library:
  1. ``NMF_TPU_NATIVE_LIB`` (a full path);
  2. ``<repo>/native/libnmfio.so``, where ``make -C native`` puts it.

Loading is lazy.  A load that finds no library returns None and is tried
again on the next call, so a library built later in the process is found;
a load that succeeds stays cached.  An explicit ``NMF_TPU_NATIVE_LIB`` that
is missing, fails to load or reports another ABI version raises on every
call: a user who names a library must not get a different one.

``READS`` counts the native reads (``"matrix"``, ``"columns"``), so that a
caller can show which path a read took; :func:`reset_counts` zeroes it.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional

import numpy as np

__all__ = [
    "available",
    "load",
    "read_matrix_native",
    "write_matrix_native",
    "has_read_columns",
    "read_columns_native",
    "READS",
    "reset_counts",
]

ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_ERRORS = {
    -1: "cannot open file",
    -2: "short read",
    -3: "short write",
    -4: "truncated header",
    -5: "file smaller than header claims / allocation failure",
}

READS: Dict[str, int] = {"matrix": 0, "columns": 0}


def reset_counts() -> None:
    for key in READS:
        READS[key] = 0


def _candidate_paths():
    env = os.environ.get("NMF_TPU_NATIVE_LIB")
    if env:
        yield env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    yield os.path.join(repo, "native", "libnmfio.so")


def _bind(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every entry point the library has."""
    u32, fptr = ctypes.c_uint32, ctypes.POINTER(ctypes.c_float)
    lib.nmf_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(u32), ctypes.POINTER(u32)]
    lib.nmf_read_header.restype = ctypes.c_int
    lib.nmf_read_matrix.argtypes = [ctypes.c_char_p, fptr, u32, u32, ctypes.c_int]
    lib.nmf_read_matrix.restype = ctypes.c_int
    lib.nmf_write_matrix.argtypes = [ctypes.c_char_p, fptr, u32, u32, ctypes.c_int]
    lib.nmf_write_matrix.restype = ctypes.c_int
    # the column-block reader is absent from the oldest builds
    if hasattr(lib, "nmf_read_columns"):
        lib.nmf_read_columns.argtypes = [ctypes.c_char_p, fptr, u32, u32, u32, u32, ctypes.c_int]
        lib.nmf_read_columns.restype = ctypes.c_int


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None when none is found.  Never latches a
    miss (module docstring); an explicit ``NMF_TPU_NATIVE_LIB`` that cannot
    be used raises ``FileNotFoundError`` or ``RuntimeError``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        env = os.environ.get("NMF_TPU_NATIVE_LIB")
        for path in _candidate_paths():
            explicit = env is not None and path == env
            if not os.path.exists(path):
                if explicit:
                    raise FileNotFoundError(f"NMF_TPU_NATIVE_LIB={path!r} does not exist")
                continue
            try:
                lib = ctypes.CDLL(path)
                lib.nmf_native_abi_version.restype = ctypes.c_int
                version = lib.nmf_native_abi_version()
            except (OSError, AttributeError) as e:
                # AttributeError: a foreign .so without the ABI symbol
                if explicit:
                    raise RuntimeError(f"NMF_TPU_NATIVE_LIB={path!r} failed to load: {e}") from e
                continue
            if version != ABI_VERSION:
                if explicit:
                    raise RuntimeError(
                        f"NMF_TPU_NATIVE_LIB={path!r} reports ABI version {version}, "
                        f"this build needs {ABI_VERSION} — rebuild with `make -C native`"
                    )
                continue
            _bind(lib)
            _lib = lib
            break
        return _lib


def available() -> bool:
    return load() is not None


def _check(rc: int, path, op: str) -> None:
    if rc != 0:
        raise ValueError(f"native {op} failed for {path}: {_ERRORS.get(rc, f'error {rc}')}")


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_matrix_native(path) -> np.ndarray:
    """Native read: ``(rows, cols)`` float32, C-contiguous; the array of
    :func:`nmf_tpu_torch.io.binio.read_matrix`."""
    lib = load()
    if lib is None:
        raise RuntimeError("native binio library not available")
    rows, cols = ctypes.c_uint32(), ctypes.c_uint32()
    p = os.fspath(path).encode()
    _check(lib.nmf_read_header(p, ctypes.byref(rows), ctypes.byref(cols)), path, "header read")
    out = np.empty((rows.value, cols.value), dtype=np.float32)
    _check(lib.nmf_read_matrix(p, _fptr(out), rows, cols, 1), path, "read")
    READS["matrix"] += 1
    return out


def has_read_columns() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "nmf_read_columns")


def read_columns_native(path, rows: int, cols: int, j0: int, j1: int,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """Columns ``[j0, j1)`` of a ``(rows, cols)`` ``.bin`` file as a
    ``(rows, j1 - j0)`` C-contiguous float32 array: one bulk read of the
    contiguous span and a cache-blocked transpose, in native code.  With
    ``out`` (a C-contiguous float32 array of that shape) the columns land
    there and ``out`` is returned."""
    lib = load()
    if lib is None or not hasattr(lib, "nmf_read_columns"):
        raise RuntimeError("native column reader not available")
    shape = (int(rows), int(j1) - int(j0))
    if out is None:
        out = np.empty(shape, dtype=np.float32)
    elif out.dtype != np.float32 or out.shape != shape or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 array of shape {shape}, "
                         f"got {out.dtype} {out.shape}")
    _check(lib.nmf_read_columns(os.fspath(path).encode(), _fptr(out), rows, cols, j0, j1, 1),
           path, "column read")
    READS["columns"] += 1
    return out


def write_matrix_native(arr, path) -> None:
    """Native write: the bytes of :func:`nmf_tpu_torch.io.binio.write_matrix`."""
    lib = load()
    if lib is None:
        raise RuntimeError("native binio library not available")
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
    if arr.ndim != 2:
        raise ValueError(f".bin format is 2-D only, got shape {arr.shape}")
    rows, cols = arr.shape
    _check(lib.nmf_write_matrix(os.fspath(path).encode(), _fptr(arr), rows, cols, 1), path, "write")
