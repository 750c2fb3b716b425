"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source (``fused_mu.cu``: K1/K2's 2-D calls and K3;
``fused_mu_batched.cu``: K1/K2 over a member axis, both through
``fused_mu.cuh``; ``tile_sparse.cu``: K5; ``extrapolate.cu``: the
accelerated loop's extrapolation; ``graph_if.cu``: a captured graph under
an IF conditional node, the loops' stop and accept test on the device;
all but the last two include ``pass1.cuh``, K1/K2's
pass 1 for a dense walk or a sweep plan's and K3's cost walk, built from the
tensor-core pieces of ``mma_tile.cuh``, the SIMT f32-GEMM pieces of
``simt_tile.cuh`` and ``mu_tile.cuh``) into an object,
all at once in parallel,
and links them into one shared library with a plain C interface at first
use, under ``build/nmf_tpu_torch/<hash>/`` beside the package (the hash
covers the sources, the headers and the flags, so an edit rebuilds);
``ctypes`` loads it.  Nothing is built or loaded at import time: this
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
_CSRC = _PKG / "csrc"
_SOURCES = (_CSRC / "fused_mu.cu", _CSRC / "fused_mu_batched.cu", _CSRC / "tile_sparse.cu",
            _CSRC / "extrapolate.cu", _CSRC / "graph_if.cu")
_HEADERS = (_CSRC / "mu_tile.cuh", _CSRC / "mma_tile.cuh", _CSRC / "simt_tile.cuh",
            _CSRC / "pass1.cuh", _CSRC / "fused_mu.cuh")
_LIB_NAME = "libnmf_kernels.so"

# sm_90a keeps wgmma/setmaxnreg available to later kernels; no fast math:
# the kernels rely on IEEE division and the accurate logf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "nmf_tile": ([], _I),
    "nmf_max_chunk": ([], _I),
    "nmf_error_string": ([_I], ctypes.c_char_p),
    # K1 (1) or K2 (0), Mode: pass-1 launches since the last reset
    "nmf_partial_launches": ([_I, _I], _I),
    "nmf_reset_partial_launches": ([], None),
    # K1 (1) or K2 (0), Mode, kc, out[4]: registers, dynamic shared memory,
    # blocks an SM, local memory of one pass-1 instance of the 2-D call, or
    # (member) of a batched call
    "nmf_partial_info": ([_I, _I, _I, _P], _I),
    "nmf_member_partial_info": ([_I, _I, _I, _P], _I),
    # w, h, x, scales, denom, part, out; m, n, k, kc, splits, per; eps;
    # state_bf16, x_kind, gemm, numerator_only, device; stream
    "nmf_h_update": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 5 + [_P], _I),
    "nmf_w_update": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 5 + [_P], _I),
    # w, h, x, scales, partials, scratch, out; m, n, k, kc, splits, per;
    # eps; state_bf16, x_kind, gemm, device; stream
    "nmf_kl_cost": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 4 + [_P], _I),
    # the same over a member axis, then members, x_shared
    "nmf_h_update_batched": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 5 + [_P] + [_I] * 2, _I),
    "nmf_w_update_batched": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 5 + [_P] + [_I] * 2, _I),
    "nmf_kl_cost_batched": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 4 + [_P] + [_I] * 2, _I),
    # K3's Mode: pass-1 launches since the last reset; Mode, kc, out[4]:
    # registers, dynamic shared memory, blocks an SM, local memory
    "nmf_kl_launches": ([_I], _I),
    "nmf_reset_kl_launches": ([], None),
    # K1 (0), K2 (1) or K3 (2), Mode, n: n more pass-1 launches (a graph's
    # replay, or a capture taken back)
    "nmf_add_launches": ([_I, _I, _I], _I),
    "nmf_kl_info": ([_I, _I, _P], _I),
    # w, h, tiles, perm, rb, cb, part, out; mp, np, k, bm, bn, n_tiles,
    # steps, per, kc; eps; state_bf16, x_kind, gemm, device; stream
    "nmf_h_sweep": ([_P] * 8 + [_I] * 9 + [_F] + [_I] * 4 + [_P], _I),
    "nmf_w_sweep": ([_P] * 8 + [_I] * 9 + [_F] + [_I] * 4 + [_P], _I),
    # K5's H target (1) or W target (0), Mode: pass-1 launches and info, as
    # K1/K2's
    "nmf_sweep_launches": ([_I, _I], _I),
    "nmf_reset_sweep_launches": ([], None),
    # K5's H target (1) or W target (0), Mode, n: n more pass-1 launches
    # (a graph's replay, or a capture taken back)
    "nmf_add_sweep_launches": ([_I, _I, _I], _I),
    "nmf_sweep_info": ([_I, _I, _I, _P], _I),
    # next0, prev0, ex0, n0, next1, prev1, ex1, n1, momentum; eps;
    # state_bf16, device; stream
    "nmf_extrapolate": ([_P] * 3 + [_I] + [_P] * 3 + [_I] + [_P, _I, _F, _I, _I, _P], _I),
    # body graph, pred, device, exec out, graph out: "IF *pred: body"
    "nmf_if_graph": ([_P, _P, _I, ctypes.POINTER(_P), ctypes.POINTER(_P)], _I),
    # exec, stream
    "nmf_graph_launch": ([_P, _P], _I),
    # exec, graph
    "nmf_if_graph_destroy": ([_P, _P], _I),
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
    for src in (*_SOURCES, *_HEADERS):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _PKG.parent / "build" / "nmf_tpu_torch" / digest.hexdigest()[:16] / _LIB_NAME


def _run_all(cmds):
    """Run the commands at once; returns (all succeeded, their joined log)."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs = [f"$ {' '.join(c)}\n{p.communicate()[0]}" for c, p in zip(cmds, procs)]
    return all(p.returncode == 0 for p in procs), "".join(logs)


def _compile(out: pathlib.Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # per-process temporary names + atomic rename: concurrent first uses
    # (a CLI subprocess beside its parent) never load a half-written file
    pid = os.getpid()
    tmp = out.with_name(f".{out.name}.{pid}.tmp")
    # nvcc tells an object by its ".o" suffix
    objs = [out.with_name(f".{src.stem}.{pid}.o") for src in _SOURCES]
    ok, log = _run_all(
        [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for o, src in zip(objs, _SOURCES)]
    )
    if ok:   # the link: the objects hold whole device code (no -rdc)
        ok, link_log = _run_all(
            [[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]]
        )
        log += link_log
    (out.parent / "build.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if not ok:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
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
