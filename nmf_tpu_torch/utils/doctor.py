"""Environment diagnosis: ``python -m nmf_tpu_torch doctor``.

Counterpart of ``nmf_tpu.utils.doctor``.  Every probe that touches the
device runs in a bounded subprocess, so a driver or device that hangs
takes the child down and never this process; "up" means the child ran a
program on the device and fetched a verified result within the timeout,
not that a device was listed.  The child:

* imports torch and reads the device's name (``torch.cuda.get_device_name``
  on ``cuda``, the CPU otherwise);
* runs an exact 8 x 128 matmul check: every entry of ``(3 J) (3 J)^T`` is
  ``3 * 3 * 128 = 1152``, exact in f32, so ``v == 1152.0`` proves a round
  trip through the device, not a cached zero;
* times one paired 8 MiB host-to-device and device-to-host copy.

The parent adds the host facts: the Python, torch, CUDA and NumPy versions,
the card's row of the tuning table (``chip_spec``: the device name and the
bf16 and f32 peaks, ``None`` for a card the table does not hold, as JAX's
doctor reports them), and in place of JAX's compile-cache statistics the
size of the port's kernel build directory (``build/nmf_tpu_torch/``: each built library is one
set of kernel sources, and the first call of a solve on a fresh checkout
pays the ``nvcc`` build).  A child whose sentinel line is not JSON reads as
down with the line in the error, not as a traceback.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

__all__ = ["diagnose", "format_report"]

# Runs inside the bounded subprocess: one sentinel JSON line on success.
_CHILD = r"""
import json, time
import torch

dev = torch.device(PLAT or "cuda")
if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("torch.cuda.is_available() is False")

def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

t0 = time.time()
name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
count = torch.cuda.device_count() if dev.type == "cuda" else 1
enum_s = time.time() - t0

t0 = time.time()
x = torch.full((8, 128), 3.0, dtype=torch.float32, device=dev)
v = float((x @ x.T)[:1, :1].cpu())
dispatch_s = time.time() - t0

mb = 8.0
host = torch.ones((1024, 2048), dtype=torch.float32)   # 8 MiB
if dev.type == "cuda":
    host = host.pin_memory()
host[:8, :8].to(dev)   # warm the copy path first
sync()
t0 = time.time()
on_dev = host.to(dev, non_blocking=True)
sync()
h2d_s = time.time() - t0
t0 = time.time()
back = on_dev.to("cpu")
d2h_s = time.time() - t0

print("NMFDOC=" + json.dumps({
    "n_devices": count,
    "platform": dev.type,
    "device_kind": name,
    "enumerate_s": round(enum_s, 3),
    "dispatch_s": round(dispatch_s, 3),
    "matmul_ok": v == 3.0 * 3.0 * 128,
    "h2d_gbps": round(mb / 1024.0 / max(h2d_s, 1e-9), 4),
    "d2h_gbps": round(mb / 1024.0 / max(d2h_s, 1e-9), 4),
}))
"""


def _build_stats() -> dict:
    """Libraries and bytes under the kernel build directory."""
    from ..ops.kernels._build import library_path

    current = library_path()
    root = current.parent.parent
    out = {"dir": str(root), "current_built": current.exists(), "libraries": 0, "bytes": 0}
    if not root.is_dir():
        return out
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            try:
                out["bytes"] += os.path.getsize(path)
            except OSError:
                continue   # removed while listed
            out["libraries"] += name == current.name
    return out


def diagnose(platform: Optional[str] = None, timeout: float = 180.0,
             _run=subprocess.run) -> dict:
    """Probe the environment and return a structured report.

    ``report["up"]`` is True iff a bounded subprocess ran the matmul check
    on the device and fetched the verified result within ``timeout``
    seconds.  ``platform`` is ``"cuda"`` (the default, None) or ``"cpu"``;
    ``_run`` is the subprocess runner (tests inject a stub).
    """
    import numpy as np
    import torch

    report: dict = {
        "artifact": "nmf_tpu_torch-doctor",
        "requested_platform": platform,
        "timeout_s": timeout,
        "versions": {
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "numpy": np.__version__,
        },
        "kernel_build": _build_stats(),
    }
    t0 = time.time()
    try:
        # a prefix line, not str.format: the child is full of braces
        proc = _run([sys.executable, "-c", f"PLAT = {platform!r}\n" + _CHILD],
                    capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        report["up"] = False
        report["error"] = (
            f"device probe hung >{timeout:.0f}s: a wedged driver or device, or a "
            "device held by another job.  A listed device is not a usable one: "
            "'up' requires a completed matmul on it."
        )
        report["probe_s"] = round(time.time() - t0, 1)
        return report
    report["probe_s"] = round(time.time() - t0, 1)
    if proc.returncode != 0:
        report["up"] = False
        report["error"] = "probe subprocess crashed: " + proc.stderr[-400:]
        return report
    sentinel = [line for line in proc.stdout.splitlines() if line.startswith("NMFDOC=")]
    if not sentinel:
        report["up"] = False
        report["error"] = "probe printed no sentinel: " + proc.stdout[-400:]
        return report
    try:
        backend = json.loads(sentinel[-1][len("NMFDOC="):])
    except json.JSONDecodeError as e:
        report["up"] = False
        report["error"] = f"probe sentinel is not JSON ({e}): " + sentinel[-1][-400:]
        return report
    if not isinstance(backend, dict):
        report["up"] = False
        report["error"] = "probe sentinel is not a JSON object: " + sentinel[-1][-400:]
        return report
    report["backend"] = backend
    report["up"] = bool(backend.get("matmul_ok"))
    # the tuning table's row: a host-side lookup, None peaks for an unknown kind
    from .device import chip_spec_for

    spec = chip_spec_for(backend.get("device_kind", ""))
    report["chip_spec"] = {
        "device_kind": backend.get("device_kind", ""),
        "bf16_tflops": spec.peak_tflops("bfloat16"),
        "f32_tflops": spec.peak_tflops("float32"),
    }
    return report


def format_report(report: dict) -> str:
    """Human-readable rendering of :func:`diagnose`'s dict."""
    up = report.get("up")
    lines = [f"nmf_tpu_torch doctor — {'UP' if up else 'DOWN'} (probe {report.get('probe_s', '?')}s)"]
    v = report["versions"]
    lines.append(f"  versions: python {v['python']}, torch {v['torch']}, CUDA {v['cuda']}, "
                 f"numpy {v['numpy']}")
    kb = report["kernel_build"]
    lines.append(
        f"  kernel build: {kb['dir']} — {kb['libraries']} libraries, {kb['bytes'] / 1e6:.1f} MB; "
        + ("the current sources are built" if kb["current_built"]
           else "the current sources are not built (the first solve on the card runs nvcc)")
    )
    if not up:
        lines.append(f"  error: {report.get('error', 'unknown')}")
        return "\n".join(lines)
    b = report["backend"]
    lines.append(f"  device: {b['platform']} x{b['n_devices']} ({b['device_kind']}) — "
                 f"enumerate {b['enumerate_s']}s, first matmul {b['dispatch_s']}s")
    lines.append(f"  link: H2D {b['h2d_gbps']} GB/s, D2H {b['d2h_gbps']} GB/s (one 8 MiB copy each)")
    cs = report.get("chip_spec")
    if cs:
        lines.append(f"  peaks: bf16 {cs['bf16_tflops']} TFLOP/s, f32 {cs['f32_tflops']} TFLOP/s "
                     "(None: a card the tuning table does not hold)")
    return "\n".join(lines)
