"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the sources into a shared library with a plain C
interface at first use, under ``build/nmf_tpu_torch/<hash>/`` beside the
package (the hash covers the sources and the flags, so an edit rebuilds),
and ``ctypes`` loads it.  Nothing is built or loaded at import time: this
module is imported on machines with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["load_library", "library_path", "NVCC_FLAGS"]

_PKG = pathlib.Path(__file__).resolve().parents[2]   # nmf_tpu_torch/
_SOURCES = (_PKG / "csrc" / "fused_mu.cu",)
_LIB_NAME = "libfused_mu.so"

# sm_90a keeps wgmma/setmaxnreg available to later kernels; no fast math:
# the kernels rely on IEEE division and the accurate logf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "nmf_tile": ([], _I),
    "nmf_max_chunk": ([], _I),
    "nmf_error_string": ([_I], ctypes.c_char_p),
    # w, h, x, scales, denom, part, out; m, n, k, kc, splits, per; eps;
    # state_bf16, x_kind, gemm, device; stream
    "nmf_h_update": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 4 + [_P], _I),
    "nmf_w_update": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 4 + [_P], _I),
    # w, h, x, scales, partials, out; m, n, k; eps; state_bf16, x_kind,
    # gemm, device; stream
    "nmf_kl_cost": ([_P] * 6 + [_I] * 3 + [_F] + [_I] * 4 + [_P], _I),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are built from source at first use"
    )


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _PKG.parent / "build" / "nmf_tpu_torch" / digest.hexdigest()[:16] / _LIB_NAME


def _compile(out: pathlib.Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # per-process temporary name + atomic rename: concurrent first uses
    # (a CLI subprocess beside its parent) never load a half-written file
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (out.parent / "build.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library.

    Cached for the life of the process: the loaded library is immutable.
    """
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
