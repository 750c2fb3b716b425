#!/usr/bin/env python3
"""Drive the PyTorch port (``nmf_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                     # from the root of a checkout
    python3 chip_smoke.py --phases card,kernels,modes,quant   # a subset
    python3 chip_smoke.py --phases card,modes,flagship        # after a K1/K2 edit
    python3 chip_smoke.py --phases card,accel                 # the accelerated solves
    python3 chip_smoke.py --phases card,families,transform    # the families, the H-only path

Twelve phases, in order; any failure raises and the exit code is non-zero:

1. card: assert CUDA, read the card's name and power limit, build the
   kernels from ``nmf_tpu_torch/csrc/`` (build seconds printed), print
   ptxas's registers and spills per kernel (a spill in any K1/K2, K3 or K5
   pass-1 kernel fails) and each pass-1 instance's registers, dynamic
   shared memory, blocks an SM and local memory as the runtime reports
   them (K3's 15 instances too; local memory fails), and check with
   ``cuobjdump -sass`` of the same toolkit that every BF16- and
   SPLIT3-Mode K1/K2 and K5 kernel and every BF16 K3 kernel holds
   tensor-core (``HMMA``) instructions and no F32- or ANY-Mode one does;
2. kernels: K1-K3 in float32 against their plain torch versions on the card
   at the reference, ISMIR and paper shapes (factors rtol 1e-4 / atol 1e-6,
   cost rel 1e-5), bitwise-equal on a second call, each timed beside its
   plain version with CUDA events (median of 10 samples of 10 back-to-back
   calls, in turns plain, kernel, kernel, plain), the pass-1 instance of
   K1/K2 read at the reference shape as in phase 3; then checked only at
   K = 8, 64, 300 and 2048 (every K chunk width, several chunks) and at
   65x129x17 and 127x350x255 (no row of W, H or X on 16 bytes: the SIMT
   pass 1's 4-byte copies), K3 also where its walk has edges
   (``KL_SHAPES``: M < 64, N < 64, N = 1, runs of two tiles split 157
   ways), each K3 call's instance read from the library's launches per Mode
   (``nmf_kl_launches``: F32 here), and K > 2048 shown to take the plain
   ops by the rank rule;
3. modes: each precision mode of K1-K3 (``bfloat16``, ``float32_fast``,
   bf16 X, int8 X, ``BF16_FULL`` with bf16 state, and ``float32_fast`` with
   bf16 X and with bf16 state and int8 X) against its plain
   version on the card at the reference shape (timed as in phase 2) and at
   K = 8, 64, 300 and 2048, bitwise-equal on a rerun, within ``MODE_LIMITS``.
   Where a mode rounds or splits the GEMM operands (``bfloat16``,
   ``float32_fast``, bf16 state; not ``float32_fast`` on bf16 state, which
   splits exactly), the same kernel without the rounding (f32 GEMMs) is
   run as a control on the same operands and must fail the
   limits, so a kernel that skipped it could not pass; the W and H of
   ``bfloat16`` and ``float32_fast`` are built so that skipping it biases
   every sum one way.  At the reference shape the library's count of
   pass-1 launches per Mode (``nmf_partial_launches``) over one K1 and one
   K2 call names the instance that ran: the tensor-core ones (``mma.sync
   bf16`` under ``bfloat16``, ``mma.sync split3`` under ``float32_fast``),
   ``simt`` else; K3 in every mode also at ``KL_SHAPES`` and phase 2's
   rows off 16 bytes, each call's instance read from ``nmf_kl_launches``
   (``kl_mode_expected``: BF16 under ``bfloat16``, F32 on f32 operands
   under both f32 policies, ANY for bf16 X, int8 X or bf16 state there);
4. quant: the quantizer on the card gives the codes and scales of
   ``quantize_columns_np`` byte for byte on the reference X, and those of
   ``quantize_rowblocks_np`` on a row-block case;
5. cli: the reference pipeline through the CLI, as subprocesses: ``gen``,
   then ``run X.bin W.bin H.bin -o ... --jsonl`` at float32 and at each
   tier (``--dtype bfloat16``, ``--dtype float32_fast``, ``--x-dtype
   bfloat16``, ``--x-dtype int8``) and once at ``--x-dtype int8
   --x-quant-rows 32``: 200 iterations, 8 strictly decreasing checks;
   float32 and float32_fast within 1e-4 of the 96689.73 pin; then ``run
   X.bin --rank 128`` at the default init (nndsvda) and ``run ...
   --accelerate``, each byte-equal to the in-process solve (from
   ``nndsvd_init(X, 128, "nndsvda")``), and ``run ... --strict-compat``
   twice: de-padded to 4096 x 128 and 128 x 350, byte-equal on the rerun;
6. inprocess: the same runs in-process through ``solve``, each with the
   counts set to 0 just before it: exactly 200/200/8 launches of K1/K2/K3
   and 0 plain calls (0 launches for ``--x-quant-rows 32``, which takes the
   plain ops by rule); factors byte-identical on a rerun and to the CLI's
   files; the final cost against the ``backend="jnp"`` solve within 1e-4
   relative (1e-3 for ``bfloat16``, whose kernel cost has a bf16 recon);
7. flagship: 10240 x 10240, K=256: one call of K1 and K2 under
   ``float32``, ``bfloat16`` and ``float32_fast`` timed beside its plain
   version, its instance traced as in phase 3; then 50 iterations, float32,
   bfloat16 and float32_fast, through the kernels and through plain torch
   ops: final costs agree to 1e-4 (float32, float32_fast) and 1e-3
   (bfloat16); iterations/s and TFLOP/s for each, and exactly 50/50/2
   launches of K1/K2/K3 in each solve through the kernels; K3 timed once
   per policy beside ``kl_cost_plain``; then K1/K2 per call where
   a block's contraction walks farthest (``LONG_WALKS``: the flagship, and
   an hour of audio in memory, wide and tall, 303 tiles a split):
   ``bfloat16`` with f32 state (the update) and bf16 state (the f32
   numerator), and ``float32_fast`` with f32 state (the update), each
   within its ``MODE_LIMITS`` of its plain version with the f32-GEMM
   control failing; and K3 at the same shapes under ``float32``,
   ``bfloat16`` (the f32-recon control failing) and ``float32_fast``,
   within cost rel 1e-5;
8. tilesparse: K5 (``h_numerator`` / ``w_numerator``) against its plain
   version on the card at the ``tests/test_pallas.py`` problem (and the
   same with its tile list padded to 64 by zero tiles at block (0, 0), as
   the tiled solve pads it), 160 x 200 with 32^2 tiles, 288 x 480 with
   96 x 160 tiles, 8192^2 K=128 with 128^2 tiles at occupancy 0.08, K = 300
   and 2048, and two long runs (300 full 128^2 tiles down one column
   block, and across one row block), in every mode (float32, ``bfloat16``,
   ``float32_fast``, bf16 tiles, bf16 state) within ``MODE_LIMITS``, with
   phase 3's controls where a mode rounds or splits, bitwise on a rerun,
   sentinel blocks exactly zero, the pass-1 instance each call ran read
   from the library's launches per Mode (``nmf_sweep_launches``: BF16
   under ``bfloat16`` and bf16 state, SPLIT3 under ``float32_fast``, F32
   under float32, ANY for bf16 tiles), each mode timed at 8192^2; then the
   tile-sparse solve at 8192^2, K=128, 200 iterations under float32,
   bfloat16 and float32_fast: exactly 200 + 200 K5 launches, all in the
   policy's instance, byte-identical factors on a rerun, the cost against
   the ``backend="jnp"`` tiled solve and (float32) the dense
   ``clamp_inputs=False`` solve through K1-K3, iterations/s of all three;
   once at K=256 ``bfloat16``, and once with int8 tiles (the plain sweep by
   rule, 0 launches);
9. oocore: K1/K2 ``numerator_only`` in every mode against the plain
   numerators at phase 3's shapes, the streamed block 1025 x 65408 x 32
   (timed and its instance traced there) and the ragged last block
   1025 x 30592 x 32, within
   ``MODE_LIMITS`` with phase 3's controls (bf16 state: X built so that a
   skipped Z rounding shows), bitwise on a rerun, the full update equal bit
   for bit to ``base * numerator / denom`` and within the mode's limits of
   its plain version, and K > 2048 on the plain ops by rule; the streamed
   cost pass's K3 (f32 GEMMs; f32, bf16 and int8 X, bf16 state) against
   ``kl_cost_plain`` at the same shapes (rel 1e-5, timed at the block, its
   instance read there);
   then ``solve_out_of_core`` at an hour
   of audio, 1025 x 619264, K=32 (X made on the card from ``--seed``, moved
   to the host), 10 iterations, a cost pass every 5, in f32, bf16 and int8
   X: exactly blocks x iterations launches of K1 and of K2
   ``numerator_only``, blocks x passes of K3, the cost within 1e-5 of the
   in-memory ``solve`` (f32: and of the ``jnp`` streamed solve), factors
   within ``OOC_FACTOR_RTOL`` of it, byte-identical reruns, peak device
   memory under a third of X, the H2D rate, the fraction of the H2D
   roofline reached, the host's block fills (gather into pinned memory)
   and waits on the host clock, and the device's kernel / copy / overlap /
   idle shares (``torch.profiler``); and ``run --out-of-core --block-n 1024`` at 2048 x
   8192, K=128, through the CLI, its files byte-equal to the in-process
   streamed solve, its cost within 1e-5 of the in-memory solve;
10. accel: ``accelerate=True``, each solve with the counts set to 0 just
   before it.  (a) The reference pipeline (seed-0 fixtures, 200 iterations,
   f32 through K1-K3): K1/K2 launched ``iterations + 25 x rejects`` times,
   K3 ``1 (seed) + 8 + rejects``, 0 plain calls, the rejects read from the
   counts; the history non-increasing, the final cost at most the plain
   kernel solve's and within 1e-4 of the ``backend="jnp"`` accelerated
   solve, with its rejects (counted on its step and cost calls) and its
   momentum bit for bit; a bitwise rerun; the reject path forced by
   ``initial_cost=0`` (no seed cost, one block redone); it/s of the
   accelerated, accelerated ``jnp`` and plain kernel solves in turns; the
   extrapolation's time on W and H (CUDA events) and the device busy share
   of an accelerated and a plain solve (``torch.profiler``).  (b) The
   flagship, 50 iterations, ``bfloat16`` and ``float32``: launches, the
   cost against the ``jnp`` accelerated solve (1e-3 / 1e-4), it/s.  (c) The
   tile-sparse solve at 8192^2, K=128, 200 iterations, f32 and ``bfloat16``:
   K5 launched ``iterations + 25 x rejects`` times a sweep, a bitwise
   rerun, the cost against the ``jnp`` tiled accelerated solve.  (d) The
   streamed solve at the hour of audio, 10 iterations, a check every 5, f32
   and int8 X: blocks x (iterations + 5 x rejects) launches of K1 and K2
   ``numerator_only``, blocks x (1 + checks + rejects) of K3, the cost
   within 1e-5 of the in-memory accelerated solve, a bitwise rerun, it/s;
11. families: the beta (2, 0, 0.5, 3), HALS and penalized KL (``l1_h =
   l2_w = 0.1``) solves, and ``accelerate=True`` for beta 2 and HALS, at
   the reference fixtures, 200 iterations, f32, on the card: plain torch
   ops by rule, so 0 launches of K1-K3 and K5 (the counts set to 0 just
   before each); the final cost within ``FAMILY_COST_RTOL`` of the same
   solve on the CPU; a history that does not rise for beta >= 1, HALS and
   the accelerated solves; a bitwise rerun; it/s; one HALS sweep of H and
   of W timed (CUDA events) and the kernels one HALS iteration launches
   (torch.profiler);
12. transform: the H-only path at the ISMIR shape 1025 x 4000, K=32 (X
   from ``--seed`` on the card, W from a 200-iteration solve).  (a)
   ``solve_h_only``, 200 iterations, under float32, ``bfloat16``,
   ``float32_fast``, bf16 X and int8 X: exactly 200 K1, 0 K2 and 8 K3
   launches and 0 plain calls, every K3 launch in its F32 instance (ANY
   for bf16 or int8 X, read from ``nmf_kl_launches``), never BF16: the
   H-only cost has a true-f32 recon in every policy; the cost within 1e-4
   of the ``backend="jnp"`` H-only solve (1e-3 under ``bfloat16``), a
   bitwise rerun, it/s; and ``solve_w_only``: 200 K1 launches on the
   transposed problem, against ``jnp``.  (b) ``transform_out_of_core`` at
   the hour of audio (phase 9's 1025 x 619,264, K=32, 10 blocks), 50
   iterations a block, f32 and int8 X: blocks x 50 K1 and blocks x 2 K3
   launches, the block costs summed within 1e-5 of the in-memory
   ``solve_h_only`` from the same explicit H0 and H within
   ``OOC_FACTOR_RTOL`` of it, peak device memory under a third of X, the
   H2D rate and it/s.  (c) ``NMF(n_components=32, init="nndsvda").fit``
   (200/200/8 launches), ``transform`` of 1000 new columns (200/0/8), then
   ``normalize_factors``: W H moved by at most 1e-6 relative.  (d) The CLI
   as subprocesses: ``transform X W -o H``, in memory and ``--out-of-core
   --block-n 1024``, and ``run`` at the reference fixtures with ``--beta
   2``, ``--algorithm hals --beta 2`` and ``--l1-h 0.1``, each file
   byte-equal to the in-process result.

Every number printed carries the card's name and power limit.  The line
before the last is the card as ``nvidia-smi`` names it, the one before that
a JSON summary of the kernels (each with its launches on its main path,
its time beside its plain version's, and its bound: the larger of its
flops over the card's peak and its bytes over 3.35 TB/s, H100 SXM at 700 W;
no single PyTorch call computes any of them, so ``library_ms`` is null;
each K1/K2 and K5 entry, mode and flagship entry names the instance that
ran, ``impl``, K1-K3 carry phase 7's ``long_walks`` readings, and K1-K3
and K5 phase 1's ``pass1`` (registers, shared memory, blocks an SM per
instance); K3 its instance in each mode and its launches on the
reference, streamed and flagship solves (``solve_launches``);
K1's and K2's ``numerator_only`` modes and K3's ``streamed`` modes carry
their launches on the streamed solve; every kernel its launches on phase
10's accelerated solves, ``accel_launches``; K1-K3 their launches on each
run of phase 12, ``transform_launches``, K2's all 0); the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import dataclasses
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
PIN_COST = 96689.73               # tests/test_parity.py:144
EPS = float(np.float32(2.2204e-16))
SHAPES = [(4096, 350, 128), (1025, 4000, 32), (513, 3445, 30)]   # (M, N, K)
# correctness only: K chunk widths 16 and 64, two chunks, the K=2048 ceiling;
# rows of W, H and X off 16 bytes (K and N odd) at chunk widths 32 and 256
COVERAGE_SHAPES = [(100, 70, 8), (333, 333, 64), (257, 129, 300), (300, 200, 2048),
                   (65, 129, 17), (127, 350, 255)]
# K chunk widths 128, 16, 64 (the tensor-core kernels' R = 4 stages apart),
# two chunks, the K=2048 ceiling
MODE_SHAPES = [(4096, 350, 128), (100, 70, 8), (333, 333, 64), (257, 129, 300),
               (300, 200, 2048)]
# phase 7: bfloat16 and float32_fast K1/K2 per call where a block's
# contraction walks farthest (the mma sums over a whole walk): the flagship
# (40 tiles a split) and an hour of audio in memory, wide (K2: 303) and
# tall (K1: 303)
LONG_WALKS = [(10240, 10240, 256), (1025, 619_264, 32), (619_264, 1025, 32)]
# K3 where its walk (K1's side: 64 columns, a run of M tiles) has edges:
# M < 64, N < 64, N = 1, and runs of two tiles split 157 ways (the last
# one tile); phase 3 also checks phase 2's rows off 16 bytes in every mode
KL_SHAPES = [(40, 333, 24), (700, 50, 40), (300, 1, 8), (20_000, 100, 16)]
KL_MODE_SHAPES = [(65, 129, 17), (127, 350, 255), *KL_SHAPES]
F32_TOL = (1e-4, 1e-6, 1e-5)          # phase 2: factors rtol, atol; cost rel
# Phase 3, per kind of mode, (max, spread, cost); None: not limited.  max:
# the largest relative error |kernel - plain| / |plain| of a factor.  spread:
# its RMS over the entries, or under bf16 state the share of entries that
# differ (each by one bf16 ulp at most, checked).  cost: relative error.
# Where a mode rounds or splits, a control (the kernel without it) must
# read above the spread and cost limits; each limit lies between the sound
# kernels' readings and the controls' on the card (PERF.md, PR 2).  The max
# allows bf16 flips: a last-ulp difference in W H may flip the rounding of a
# Z entry, moving a sum over N terms by 2**-8 of one term.
MODE_LIMITS = {
    "f32_gemm": (1e-4, None, 1e-5),     # bf16 X, int8 X: f32 GEMMs
    "bfloat16": (1e-3, 3e-5, 1e-5),
    "float32_fast": (1e-4, 2e-6, 1e-5),
    "bf16_state": (None, 1e-3, 1e-5),   # and one bf16 ulp at most
}
SAMPLES, CALLS = 10, 10
KERNELS = [
    # name, TPU kernel it replaces, source of the port's kernel
    ("update_h", "nmf_tpu/ops/pallas/fused_mu.py:245", "nmf_tpu_torch/csrc/fused_mu.cu"),
    ("update_w", "nmf_tpu/ops/pallas/fused_mu.py:378", "nmf_tpu_torch/csrc/fused_mu.cu"),
    ("kl_cost", "nmf_tpu/ops/pallas/fused_mu.py:516", "nmf_tpu_torch/csrc/fused_mu.cu"),
    ("h_numerator", "nmf_tpu/ops/pallas/tile_sparse.py:122", "nmf_tpu_torch/csrc/tile_sparse.cu"),
    ("w_numerator", "nmf_tpu/ops/pallas/tile_sparse.py:122", "nmf_tpu_torch/csrc/tile_sparse.cu"),
]
# Published peaks of one H100 SXM at 700 W (dense): f32 on the SIMT units,
# bf16 on the tensor cores, and the HBM rate.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# Phase 8: the main tile-sparse problem (benchmarks/run_all.py:436-612,
# RETUNE_r05 cells tile_sparse_*): m, n, k, tile edge, occupancy, seed
TS_MAIN = (8192, 8192, 128, 128, 0.08, 0)
TS_ITERS = 200
# CLI tiers: name -> extra flags (the names of phase 3's modes where they match)
TIERS = {
    "float32": [],
    "bfloat16": ["--dtype", "bfloat16"],
    "float32_fast": ["--dtype", "float32_fast"],
    "x_bfloat16": ["--x-dtype", "bfloat16"],
    "x_int8": ["--x-dtype", "int8"],
    "x_int8_rows32": ["--x-dtype", "int8", "--x-quant-rows", "32"],
}
PHASES = ("card", "kernels", "modes", "quant", "cli", "inprocess", "flagship", "tilesparse",
          "oocore", "accel", "families", "transform")
# csrc/mu_tile.cuh's Mode, in the order of its values; the pass-1 instance
# of K1/K2 that each runs on
MODES = ("F32", "ANY", "SPLIT3", "BF16")
IMPL = {"BF16": "mma.sync bf16", "SPLIT3": "mma.sync split3"}   # F32, ANY: "simt"
# the GEMM policy -> the K1/K2 instance it routes to
IMPL_OF_POLICY = {"bfloat16": IMPL["BF16"], "float32_fast": IMPL["SPLIT3"]}
# the Modes of K1/K2 on the tensor cores, each phase 1 holds to HMMA, and on
# the SIMT units, to none
MMA_MODES = tuple(IMPL)
SIMT_MODES = tuple(m for m in MODES if m not in IMPL)
_KERNEL_RE = re.compile(r"(h_update_partial|w_update_partial|h_sweep_partial|w_sweep_partial"
                        r"|kl_partial|kl_final|finalize|sum_splits|sweep_sum)"
                        r"(?:ILi(\d+)E)?(?:I?LNS\d*_4ModeE(\d)E)?")
# the pass-1 kernels, K1/K2's and K5's, by name
PASS1_KERNELS = (("h_update_partial", 1, "nmf_partial_info"), ("w_update_partial", 0, "nmf_partial_info"),
                 ("h_sweep_partial", 1, "nmf_sweep_info"), ("w_sweep_partial", 0, "nmf_sweep_info"))
# each kernel's pass-1 kernel, whose instances the result line lists
PASS1_OF = {"update_h": "h_update_partial", "update_w": "w_update_partial",
            "h_numerator": "h_sweep_partial", "w_numerator": "w_sweep_partial",
            "kl_cost": "kl_partial"}
PASS1_NAMES = {name for name, _, _ in PASS1_KERNELS}
# K3's Modes (no SPLIT3: its recon is true f32 under float32_fast)
KL_MODES = ("F32", "ANY", "BF16")
# phase 8's K5 modes -> the Mode of the pass-1 instance each runs
K5_MODE = {"float32": "F32", "bfloat16": "BF16", "float32_fast": "SPLIT3", "bf16_tiles": "ANY",
           "bf16_state": "BF16"}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def _launches(**counts):
    """Every K1-K3 launch count (``fused_mu.LAUNCHES``' keys), 0 unless given."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    return {key: counts.get(key, 0) for key in fused_mu.LAUNCHES}


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound(flops, nbytes, kind="float32"):
    """(least ms the card could take, "operations" or "bytes"): the larger
    of ``flops`` over the peak of ``kind`` and ``nbytes`` over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def event_ms(fn, samples=SAMPLES, calls=CALLS) -> float:
    """Time of one call by CUDA events: the median over ``samples`` of
    ``calls`` back-to-back calls each (a lone call between two events
    measures mostly its launch), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def timed_pair(kern, plain, samples=SAMPLES, calls=CALLS):
    """(kernel ms, plain ms): plain, kernel, kernel, plain, in one call."""
    p1 = event_ms(plain, samples, calls)
    k1 = event_ms(kern, samples, calls)
    k2 = event_ms(kern, samples, calls)
    p2 = event_ms(plain, samples, calls)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _kernel_label(mangled):
    """``h_update_partial<R=16,BF16>`` for a mangled kernel name, or the
    name itself where it is none of the port's kernels."""
    m = _KERNEL_RE.search(mangled)
    if not m:
        return mangled
    args = ([f"R={m.group(2)}"] if m.group(2) else []) + ([MODES[int(m.group(3))]] if m.group(3) else [])
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def _check_sass(card, lib_path):
    """Every BF16- and SPLIT3-Mode pass-1 kernel of the built library (K1/K2
    and K5) holds HMMA (tensor-core) instructions and no F32- or ANY-Mode
    one does: ``cuobjdump -sass`` of the toolkit that built it (a missing
    cuobjdump fails the phase)."""
    from nmf_tpu_torch.ops.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    check(tool.is_file(), f"no cuobjdump beside {_build._nvcc()}: the SASS check cannot run")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    hmma, label = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            label = _kernel_label(fn.group(1))
            hmma.setdefault(label, 0)
        elif label and "HMMA" in line:
            hmma[label] += 1
    partial = {n: c for n, c in hmma.items() if n.split("<")[0] in PASS1_NAMES}
    by_mode = {mode: {n: c for n, c in partial.items() if n.endswith(f",{mode}>")}
               for mode in MODES}
    for mode in MMA_MODES:
        check(len(by_mode[mode]) == 20 and all(by_mode[mode].values()),
              f"{mode}-Mode K1/K2/K5 kernels without HMMA (or missing): {by_mode[mode]}")
    for mode in SIMT_MODES:
        check(len(by_mode[mode]) == 20 and not any(by_mode[mode].values()),
              f"{mode}-Mode K1/K2/K5 kernels with HMMA (or missing): {by_mode[mode]}")
    kl = {n: c for n, c in hmma.items() if n.startswith("kl_partial<")}
    kl_by_mode = {mode: {n: c for n, c in kl.items() if n.endswith(f",{mode}>")} for mode in KL_MODES}
    check(len(kl) == 15 and all(len(v) == 5 for v in kl_by_mode.values()),
          f"K3 kernels missing: {kl}")
    check(all(kl_by_mode["BF16"].values()), f"BF16 K3 kernels without HMMA: {kl_by_mode['BF16']}")
    check(not any(c for mode in ("F32", "ANY") for c in kl_by_mode[mode].values()),
          f"F32/ANY K3 kernels with HMMA: {kl_by_mode}")
    for mode in MMA_MODES:
        print(f"[{card}] SASS ({tool}): HMMA instructions in each {mode}-Mode K1/K2/K5 "
              f"kernel {by_mode[mode]}")
    print(f"[{card}] SASS: no HMMA in the 40 F32- and ANY-Mode K1/K2/K5 kernels")
    print(f"[{card}] SASS: HMMA instructions in each BF16 K3 kernel {kl_by_mode['BF16']}, none in "
          "the 10 F32 and ANY ones")


def kl_counts(fn):
    """(fn(), K3's pass-1 launches per Mode, in MODES' order) as the library
    counts them on the host (``nmf_kl_launches``), set to 0 just before."""
    from nmf_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    lib.nmf_reset_kl_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, [lib.nmf_kl_launches(i) for i in range(len(MODES))]


def kl_mode_expected(prec, w, x):
    """The Mode a K3 call must run: BF16 under ``bfloat16`` (any state and
    X), F32 on f32 W, H and X under both f32 policies, else ANY."""
    if prec.matmul_dtype == "bfloat16":
        return "BF16"
    dense_f32 = not isinstance(x, tuple) and x.dtype == torch.float32
    return "F32" if w.dtype == torch.float32 and dense_f32 else "ANY"


def kl_instance(mode, k):
    """K3's instance label at rank ``k``, as phase 1 lists it."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    return f"kl_partial<R={fused_mu.chunk_width(k) // 16},{mode}>"


def _kl_impl(instance):
    """``mma.sync bf16`` for a BF16 K3 instance, ``simt`` for F32 and ANY."""
    return IMPL["BF16"] if instance.endswith(",BF16>") else "simt"


def _check_kl_mode(kern, w, h, x, prec, where):
    """One more K3 call, counted: the Mode it ran must be the one
    ``kl_mode_expected`` names; returns its instance label."""
    _, counts = kl_counts(lambda: kern(w, h, x))
    ran = _mode_of_counts(counts, where)
    want = kl_mode_expected(prec, w, x)
    check(ran == want, f"{where}: K3 ran the {ran} instance, expected {want}")
    return kl_instance(ran, w.shape[1])


def _mode_of_counts(counts, what):
    """The one Mode with launches in ``counts`` (launches per Mode, in
    MODES' order)."""
    ran = [mode for mode, n in zip(MODES, counts) if n]
    check(len(ran) == 1, f"{what}: pass-1 launches per Mode {dict(zip(MODES, counts))}")
    return ran[0]


def _impl_of_counts(counts, what):
    """The pass-1 instance (``IMPL``'s, or "simt") of the one Mode with
    launches in ``counts``."""
    return IMPL.get(_mode_of_counts(counts, what), "simt")


def sweep_counts(fn):
    """(fn(), {"h_numerator": [launches per Mode], "w_numerator": [...]}):
    K5's pass-1 launches per Mode as the library counts them on the host,
    set to 0 just before ``fn``."""
    from nmf_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    lib.nmf_reset_sweep_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, {key: [lib.nmf_sweep_launches(h, i) for i in range(len(MODES))]
                 for key, h in (("h_numerator", 1), ("w_numerator", 0))}


def observed_impls(fn):
    """{"update_h": impl, "update_w": impl} of the K1/K2 pass-1 kernels that
    ``fn`` launched: the library counts each pass-1 launch per Mode on the
    host as it makes it (``nmf_partial_launches``), set to 0 just before.
    (torch.profiler traces of the call lost pass-1 kernels on the H100,
    at the streamed block on every retry: PERF.md section 6.)"""
    from nmf_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    lib.nmf_reset_partial_launches()
    fn()
    torch.cuda.synchronize()
    impls = {}
    for key, h in (("update_h", 1), ("update_w", 0)):
        counts = [lib.nmf_partial_launches(h, i) for i in range(len(MODES))]
        if any(counts):
            impls[key] = _impl_of_counts(counts, key)
    return impls


def _check_impls(fn, prec, where):
    """The K1/K2 instances ``fn`` ran, each the one its GEMM policy routes
    to: the tensor cores under ``bfloat16`` and ``float32_fast``, SIMT
    under ``float32``."""
    want = IMPL_OF_POLICY.get(prec.matmul_dtype, "simt")
    impls = observed_impls(fn)
    check(set(impls) == {"update_h", "update_w"} and set(impls.values()) == {want},
          f"{where}: K1/K2 ran {impls}, expected {want}")
    return impls


def phase_card(card, out):
    print(f"[{card}] phase 1: card and build")
    from nmf_tpu_torch.ops.kernels import _build

    lib_path = _build.library_path()
    fresh = not lib_path.exists()
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f"[{card}] kernels {'built' if fresh else 'loaded (already built)'} "
          f"in {secs} s: {lib_path.relative_to(REPO)}")
    log = lib_path.parent / "build.log"
    if fresh and log.exists():
        # one line per kernel: registers and spills from ptxas -v
        name, spilled = None, []
        for line in log.read_text().splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                name = _kernel_label(entry.group(1))
            elif name and ("spill" in line and " 0 bytes spill stores" not in line or "Used" in line):
                print(f"[{card}]   {name}: {line.split('info    :')[-1].strip()}")
                if "spill" in line:
                    spilled.append(name)
        # the F32 and BF16 Modes of K1/K2 and K5 hold two blocks an SM only
        # without spills (PERF.md section 6); SPLIT3 holds one, with no spill
        # either
        bad = [n for n in spilled if n.split("<")[0] in PASS1_NAMES | {"kl_partial"}]
        check(not bad, f"K1/K2/K3/K5 pass-1 kernels spill: {bad}")
    _check_sass(card, lib_path)
    out["build_seconds"] = secs
    out["pass1"] = _pass1_info(card)


def _pass1_info(card):
    """{"h_update_partial<R=16,F32>": {"registers", "smem_bytes",
    "blocks_per_sm", "local_bytes"}, ...} of every K1/K2, K3 and K5 pass-1
    instance, as the runtime reports them (``nmf_partial_info``,
    ``nmf_kl_info``, ``nmf_sweep_info``); a kernel with local memory (a
    spill) fails."""
    import ctypes

    from nmf_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    info = {}
    for mode_i, mode in enumerate(MODES):
        for name, h, query in PASS1_KERNELS:
            for r in (1, 2, 4, 8, 16):
                vals = (ctypes.c_int * 4)()
                rc = getattr(lib, query)(h, mode_i, 16 * r, vals)
                check(rc == 0, f"{query} {name} R={r} {mode}: CUDA error {rc}")
                label = f"{name}<R={r},{mode}>"
                info[label] = dict(zip(("registers", "smem_bytes", "blocks_per_sm", "local_bytes"),
                                       vals))
                check(vals[3] == 0, f"{label}: {vals[3]} bytes of local memory a thread")
                print(f"[{card}]   {label}: {vals[0]} registers, {vals[1]} bytes of dynamic "
                      f"shared memory, {vals[2]} blocks an SM, {vals[3]} bytes local")
    for mode in KL_MODES:   # K3's instances (nmf_kl_info)
        for r in (1, 2, 4, 8, 16):
            vals = (ctypes.c_int * 4)()
            rc = lib.nmf_kl_info(MODES.index(mode), 16 * r, vals)
            label = f"kl_partial<R={r},{mode}>"
            check(rc == 0, f"nmf_kl_info {label}: CUDA error {rc}")
            info[label] = dict(zip(("registers", "smem_bytes", "blocks_per_sm", "local_bytes"), vals))
            check(vals[3] == 0, f"{label}: {vals[3]} bytes of local memory a thread")
            print(f"[{card}]   {label}: {vals[0]} registers, {vals[1]} bytes of dynamic "
                  f"shared memory, {vals[2]} blocks an SM, {vals[3]} bytes local")
    return info


def _operands(m, n, k):
    rng = np.random.RandomState(m + n + k)
    return tuple(
        torch.from_numpy(np.maximum(rng.rand(*s).astype(np.float32), np.float32(EPS))).cuda()
        for s in ((m, k), (k, n), (m, n))
    )


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _where(name, w, h, label=""):
    return f"{name} {label}{w.shape[0]}x{h.shape[1]}x{w.shape[1]}"


def _run_pair(kern, plain, w, h, x, where):
    """(kernel result, plain result) on the same tensors, once the kernel's
    dtype, finiteness and a bitwise-identical second call are checked."""
    out1 = kern(w, h, x)
    torch.cuda.synchronize()
    out2 = kern(w, h, x)
    torch.cuda.synchronize()
    ref = plain(w, h, x)
    torch.cuda.synchronize()
    check(out1.dtype == ref.dtype, f"{where}: dtype {out1.dtype} vs plain {ref.dtype}")
    check(torch.equal(_bits(out1), _bits(out2)), f"{where}: second call not bitwise identical")
    check(bool(torch.isfinite(out1).all()), f"{where}: non-finite output")
    return out1, ref


def _check_kernel(name, kern, plain, w, h, x, tol=F32_TOL):
    """Kernel vs plain on the same tensors, and a bitwise rerun; returns
    (max abs error, description)."""
    rtol, atol, cost_rtol = tol
    where = _where(name, w, h)
    out1, ref = _run_pair(kern, plain, w, h, x, where)
    err = (out1.float() - ref.float()).abs()
    max_err = float(err.max())
    if name == "kl_cost":
        rel = max_err / abs(float(ref))
        ok, what = rel <= cost_rtol, f"rel err {rel} (limit {cost_rtol})"
    else:
        worst = float((err - rtol * ref.float().abs()).max())
        ok = worst <= atol
        what = (f"max abs err {max_err}, worst excess over rtol {rtol}: {worst} "
                f"(atol {atol})")
    check(ok, f"{where}: {what}")
    return max_err, what


def _pairs(prec=None):
    """name -> (kernel, plain) under ``prec``, X dense or a (codes, scales)
    pair."""
    from nmf_tpu_torch.ops import mu
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.quant import dequantize
    from nmf_tpu_torch.utils.config import Precision

    prec = prec or Precision()

    def dense(x):
        return dequantize(*x) if isinstance(x, tuple) else x

    return {
        "update_h": (lambda w, h, x: fused_mu.update_h_fused(w, h, x, precision=prec),
                     lambda w, h, x: mu.update_h(w, h, dense(x), precision=prec)),
        "update_w": (lambda w, h, x: fused_mu.update_w_fused(w, h, x, precision=prec),
                     lambda w, h, x: mu.update_w(w, h, dense(x), precision=prec)),
        "kl_cost": (lambda w, h, x: fused_mu.kl_cost_fused(x, w, h, precision=prec),
                    lambda w, h, x: fused_mu.kl_cost_plain(x, w, h, precision=prec)),
    }


def _mu_bound(name, w, h, x, prec):
    """The bound of one K1, K2 or K3 call on these operands: two GEMMs of
    M x N x K a half-update, one for the cost (three bf16 passes each under
    split3, which K3 does not take), X (codes and scales), W and H read
    once, the result written once."""
    m, k = w.shape
    n = h.shape[1]
    split3 = prec.matmul_dtype == "float32_fast" and name != "kl_cost"
    kind = "float32" if prec.matmul_dtype == "float32" or not (
        split3 or prec.matmul_dtype == "bfloat16") else "bfloat16"
    flops = (3 if split3 else 1) * (1 if name == "kl_cost" else 2) * 2 * m * n * k
    x_bytes = sum(t.numel() * t.element_size() for t in (x if isinstance(x, tuple) else (x,)))
    out_bytes = {"update_h": k * n * h.element_size(), "update_w": m * k * w.element_size(),
                 "kl_cost": 4}[name]
    nbytes = x_bytes + (w.numel() + h.numel()) * w.element_size() + out_bytes
    return bound(flops, nbytes, kind)


def phase_kernels(card, out):
    print(f"[{card}] phase 2: kernels (float32) vs plain torch on the card")
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.utils.config import Precision

    pairs = _pairs()
    stats = out["kernels"]
    for si, (m, n, k) in enumerate(SHAPES):
        w, h, x = _operands(m, n, k)
        for name, (kern, plain) in pairs.items():
            max_err, what = _check_kernel(name, kern, plain, w, h, x)
            kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x))
            print(f"[{card}] {name:8s} {m}x{n}x{k}: kernel {kms} ms, plain {pms} ms, "
                  f"{what}, bitwise-repeatable")
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], max_err)
            if si == 0:  # the main path's shape
                st["ms"], st["plain_ms"] = kms, pms
                st["bound_ms"], st["bound_by"] = _mu_bound(name, w, h, x, Precision())
        inst = _check_kl_mode(pairs["kl_cost"][0], w, h, x, Precision(), _where("kl_cost", w, h))
        if si == 0:   # which instance the main path's K3 ran
            stats["kl_cost"].update(impl="simt", instance=inst)
            print(f"[{card}] [float32] {m}x{n}x{k}: K3 ran {inst} (the library's launches per Mode)")
        if si == 0:   # which pass-1 instance the main path's K1/K2 ran
            impls = _check_impls(lambda: [pairs[nm][0](w, h, x) for nm in ("update_h", "update_w")],
                                 Precision(), f"[float32] {m}x{n}x{k}")
            for name, impl in impls.items():
                stats[name]["impl"] = impl
            print(f"[{card}] [float32] {m}x{n}x{k}: K1/K2 pass 1 ran {impls}")
    # every K chunk width and several chunks, up to the rank ceiling; K3
    # also where its walk has edges
    for m, n, k in [*COVERAGE_SHAPES, *KL_SHAPES]:
        w, h, x = _operands(m, n, k)
        for name, (kern, plain) in pairs.items():
            if (m, n, k) in KL_SHAPES and name != "kl_cost":
                continue
            max_err, what = _check_kernel(name, kern, plain, w, h, x)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], max_err)
            if name == "kl_cost":
                what += f", {_check_kl_mode(kern, w, h, x, Precision(), _where(name, w, h))}"
            print(f"[{card}] {name:8s} {m}x{n}x{k}: {what}, bitwise-repeatable")
    # above the rank ceiling the wrappers take the plain ops by rule
    k = fused_mu.MAX_FUSED_K + 8
    w, h, x = _operands(64, 96, k)
    launches = dict(fused_mu.LAUNCHES)
    plain_before = fused_mu.PLAIN_CALLS["update_h"]
    fused_mu.update_h_fused(w, h, x)
    check(fused_mu.PLAIN_CALLS["update_h"] == plain_before + 1
          and fused_mu.LAUNCHES == launches, f"K={k} did not take the plain ops")
    print(f"[{card}] K={k} > MAX_FUSED_K: plain ops by the rank rule, no launch")


class ModeCheck(NamedTuple):
    prec: object            # Precision of the mode
    state: torch.dtype      # W and H
    xform: str              # X: "f32", "bf16" or "int8" (codes, scales)
    limits: tuple           # (max, spread, cost): see MODE_LIMITS
    control: object = None  # Precision of a kernel that skips the mode's rounding
    controlled: tuple = ()  # the kernels whose arithmetic the control changes


def _modes():
    """mode -> ModeCheck.  A control is the same kernel under a policy that
    skips the mode's rounding (or split), on the same operands: it must
    fail the limit, so each run shows the limit can see that fault."""
    from nmf_tpu_torch.utils.config import BF16_FULL, Precision

    f32 = Precision()
    bf16_state = dataclasses.replace(BF16_FULL, state_dtype="bfloat16")
    gemms = ("update_h", "update_w")
    return {
        "bfloat16": ModeCheck(Precision("bfloat16"), torch.float32, "f32",
                              MODE_LIMITS["bfloat16"], f32, (*gemms, "kl_cost")),
        # K3 is true f32 under float32_fast: the control changes K1/K2 only
        "float32_fast": ModeCheck(Precision("float32_fast"), torch.float32, "f32",
                                  MODE_LIMITS["float32_fast"], f32, gemms),
        "x_bfloat16": ModeCheck(Precision(x_dtype="bfloat16"), torch.float32, "bf16",
                                MODE_LIMITS["f32_gemm"]),
        "x_int8": ModeCheck(Precision(x_dtype="int8"), torch.float32, "int8",
                            MODE_LIMITS["f32_gemm"]),
        # float32_fast on the other storages of its tensor-core kernels: bf16
        # X (W and H exposed as above), and bf16 state (split exactly, lo 0)
        # with int8 X, which no control can tell from f32 GEMMs
        "float32_fast_x_bf16": ModeCheck(Precision("float32_fast", x_dtype="bfloat16"),
                                         torch.float32, "bf16", MODE_LIMITS["float32_fast"],
                                         f32, gemms),
        "float32_fast_bf16_state": ModeCheck(Precision("float32_fast", "bfloat16", "int8"),
                                             torch.bfloat16, "int8", MODE_LIMITS["bf16_state"]),
        # bf16 W and H are their own rounding: the control skips only Z's,
        # which K3 does not form
        "bf16_full_state": ModeCheck(bf16_state, torch.bfloat16, "bf16",
                                     MODE_LIMITS["bf16_state"],
                                     dataclasses.replace(bf16_state, matmul_dtype="float32"),
                                     gemms),
    }


def _exposed(rng, shape, mode):
    """W or H values on which a kernel that skips ``mode``'s rounding is off
    by a bias of one sign, where on uniform operands the errors mostly
    cancel in the sums (and in the cost, below one f32 ulp at some shapes).

    bfloat16: b * (1 + 2**-10), b bf16-exact, which rounds to b, 2**-10 low
    in every operand (W H 2**-9 low).  float32_fast: hi + lo, hi a power of
    two and lo = hi * 2**-8 * u with u in [0.5, 1) on 8 bits, which bf16
    splits exactly into (hi, lo); split3 drops lo * lo' = 2**-16 u u' of
    every product (W H ~8.6e-6 low)."""
    if mode == "bfloat16":
        b = torch.from_numpy(np.maximum(rng.rand(*shape).astype(np.float32), np.float32(EPS)))
        return (b.to(torch.bfloat16).float() * (1 + 2.0 ** -10)).cuda()
    hi = np.exp2(-rng.randint(0, 4, shape)).astype(np.float32)
    u = (128 + rng.randint(0, 128, shape)).astype(np.float32) / 256
    return torch.from_numpy(hi + hi * np.float32(2.0 ** -8) * u).cuda()


def _mode_operands(m, n, k, mode, spec):
    from nmf_tpu_torch.ops.quant import quantize_columns

    w, h, x = _operands(m, n, k)
    policy = spec.prec.matmul_dtype
    if spec.state == torch.float32 and policy in ("bfloat16", "float32_fast"):
        rng = np.random.RandomState(m + n + k)
        w, h = _exposed(rng, (m, k), policy), _exposed(rng, (k, n), policy)
    w, h = w.to(spec.state), h.to(spec.state)
    if spec.xform == "bf16":
        x = x.to(torch.bfloat16)
    elif spec.xform == "int8":
        x = quantize_columns(x, EPS)
    return w, h, x


def _mode_err(out, ref):
    """(largest relative error, spread, largest bf16 ulp distance) of a
    result against its plain version.  The spread is the RMS relative error
    of an f32 result, and for a bf16 result the share of entries that
    differ (the entries are positive, so their bits count ulps)."""
    rel = (out.double() - ref.double()).abs() / ref.double().abs()
    if out.dtype == torch.bfloat16:
        ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
        return float(rel.max()), float((ulps > 0).double().mean()), int(ulps.max())
    return float(rel.max()), float(rel.square().mean().sqrt()), 0


def phase_modes(card, out):
    print(f"[{card}] phase 3: precision modes of K1-K3 vs plain torch on the card")
    stats = out["kernels"]
    for mode, spec in _modes().items():
        pairs = _pairs(spec.prec)
        controls = _pairs(spec.control) if spec.control else {}
        max_limit, spread_limit, cost_limit = spec.limits
        # K1-K3 at MODE_SHAPES, then K3 alone at the edges of its walk
        for si, (m, n, k) in enumerate([*MODE_SHAPES, *KL_MODE_SHAPES]):
            w, h, x = _mode_operands(m, n, k, mode, spec)
            for name, (kern, plain) in pairs.items():
                if si >= len(MODE_SHAPES) and name != "kl_cost":
                    continue
                where = _where(name, w, h, f"[{mode}] ")
                res, ref = _run_pair(kern, plain, w, h, x, where)
                err, spread, ulps = _mode_err(res, ref)
                spread_name = ("share of entries differing" if res.dtype == torch.bfloat16
                               else "rms rel err")
                if name == "kl_cost":
                    limit, measured = cost_limit, err
                    inst = _check_kl_mode(kern, w, h, x, spec.prec, where)
                    what = f"rel err {err} (limit {limit}), {inst}"
                else:
                    limit, measured = spread_limit, spread
                    check(ulps <= 1, f"{where}: an entry {ulps} bf16 ulps from plain")
                    check(max_limit is None or err <= max_limit,
                          f"{where}: max rel err {err} (limit {max_limit})")
                    what = (f"max rel err {err} (limit {max_limit}), {spread_name} "
                            f"{spread} (limit {spread_limit})")
                check(limit is None or measured <= limit, f"{where}: {what}")
                # "err" is what "limit" bounds: the spread of factors, the
                # relative error of the cost
                ms = stats[name]["modes"].setdefault(
                    mode, {"max_abs_err": 0.0, "max_rel_err": 0.0, "err": 0.0, "limit": limit})
                ms["max_abs_err"] = max(ms["max_abs_err"], float((res.float() - ref.float()).abs().max()))
                ms["max_rel_err"] = max(ms["max_rel_err"], err)
                ms["err"] = max(ms["err"], measured)
                if name in spec.controlled:
                    c_err, c_spread, _ = _mode_err(controls[name][0](w, h, x), ref)
                    c_measured = c_err if name == "kl_cost" else c_spread
                    check(c_measured > limit, f"{where}: the control ({spec.control.matmul_dtype} "
                          f"GEMMs) reads {c_measured}, within the limit {limit}")
                    ms["control_min"] = min(ms.get("control_min", c_measured), c_measured)
                    what += f"; control ({spec.control.matmul_dtype} GEMMs) {c_measured}"
                if si == 0:  # the main path's shape, timed
                    kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x))
                    b_ms, b_by = _mu_bound(name, w, h, x, spec.prec)
                    ms.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
                    if name == "kl_cost":
                        ms.update(impl=_kl_impl(inst), instance=inst)
                    print(f"[{card}] {where}: kernel {kms} ms, plain {pms} ms, bound {b_ms} ms "
                          f"({b_by}), {what}, bitwise-repeatable")
                else:
                    print(f"[{card}] {where}: {what}, bitwise-repeatable")
            if si == 0:   # which pass-1 instance K1/K2 ran, from a trace
                impls = _check_impls(lambda: [pairs[nm][0](w, h, x) for nm in ("update_h", "update_w")],
                                     spec.prec, f"[{mode}] {m}x{n}x{k}")
                for name, impl in impls.items():
                    stats[name]["modes"][mode]["impl"] = impl
                print(f"[{card}] [{mode}] {m}x{n}x{k}: K1/K2 pass 1 ran {impls} (the library's "
                      "launches per Mode)")


def phase_quant(card, out):
    print(f"[{card}] phase 4: the quantizer on the card vs the NumPy twin")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops import quant

    x = nt.fixtures.as_seen_by_solver(nt.fixtures.reference_fixture_arrays()["X"])
    x = np.maximum(x, np.float32(EPS))   # the load-time clamp
    cases = [
        ("columns", x, lambda a: quant.quantize_columns(a, EPS),
         lambda a: quant.quantize_columns_np(a, EPS)),
        # 4000 rows in blocks of 300: normalised to 14 blocks of 286 rows,
        # the last one padded by 4 (nmf_tpu/ops/quant.py:128-137)
        ("rowblocks 300", np.ascontiguousarray(x[:4000]),
         lambda a: quant.quantize_rowblocks(a, EPS, 300),
         lambda a: quant.quantize_rowblocks_np(a, EPS, 300)),
    ]
    for label, xa, on_card, on_host in cases:
        q, s = (t.cpu().numpy() for t in on_card(torch.from_numpy(xa).cuda()))
        qn, sn = on_host(xa)
        check(q.dtype == np.uint8 and q.shape == qn.shape, f"quant {label}: codes {q.dtype} {q.shape}")
        check(q.tobytes() == qn.tobytes(), f"quant {label}: codes differ from the NumPy twin "
              f"at {int((q != qn).sum())} entries")
        check(s.tobytes() == sn.tobytes(), f"quant {label}: scales differ from the NumPy twin")
        print(f"[{card}] quantizer {label} {q.shape}: codes and {s.shape} scales "
              f"byte-identical to the NumPy twin")


def _cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return subprocess.run([sys.executable, "-m", "nmf_tpu_torch", *args],
                          check=True, cwd=cwd, env=env)


def phase_cli(card, tmp, out):
    print(f"[{card}] phase 5: reference pipeline through the CLI, every tier")
    _cli(["gen", "."], tmp)
    for tier, flags in TIERS.items():
        t0 = time.perf_counter()
        _cli(["run", "X.bin", "W.bin", "H.bin", "-o", f"W_{tier}.bin", f"H_{tier}.bin",
              "--jsonl", f"{tier}.jsonl", "-q", *flags], tmp)
        wall = time.perf_counter() - t0
        rec = json.loads(pathlib.Path(tmp, f"{tier}.jsonl").read_text().splitlines()[-1])
        costs = [c["cost"] for c in rec["checks"]]
        check(rec["iterations"] == 200, f"CLI {tier}: ran {rec['iterations']} iterations")
        check(len(costs) == 8, f"CLI {tier}: made {len(costs)} checks")
        check(all(b < a for a, b in zip(costs, costs[1:])),
              f"CLI {tier}: costs not decreasing: {costs}")
        rel = abs(rec["final_cost"] - PIN_COST) / PIN_COST
        if tier in ("float32", "float32_fast"):
            check(rel <= 1e-4, f"CLI {tier}: final cost {rec['final_cost']} vs {PIN_COST}: rel {rel}")
        size = pathlib.Path(tmp, f"W_{tier}.bin").stat().st_size
        check(size == 8 + 4096 * 128 * 4, f"CLI {tier}: W_{tier}.bin is {size} bytes")
        out["cli"][tier] = rec["final_cost"]
        print(f"[{card}] CLI {tier}: 200 iterations, 8 decreasing checks, final cost "
              f"{rec['final_cost']} (rel {rel} to the pin), solve {rec['seconds']} s = "
              f"{rec['iters_per_sec']} it/s, process wall {wall} s")
    _cli_solver_flags(card, tmp, out)


def _cli_files(tmp, tag):
    import nmf_tpu_torch as nt

    return tuple(nt.read_matrix(os.path.join(tmp, f"{f}_{tag}.bin")) for f in "WH")


def _cli_solver_flags(card, tmp, out):
    """``run X.bin --rank 128`` at the default init (nndsvda), ``run
    --accelerate`` and ``run --strict-compat`` on the reference fixtures:
    the first two byte-equal to the in-process solve, the third de-padded
    and byte-equal on a rerun."""
    import nmf_tpu_torch as nt

    x, w, h = (nt.read_matrix(os.path.join(tmp, f"{s}.bin")) for s in "XWH")
    runs = {"nndsvda": ["X.bin", "--rank", "128"],
            "accelerate": ["X.bin", "W.bin", "H.bin", "--accelerate"],
            "strict": ["X.bin", "W.bin", "H.bin", "--strict-compat"],
            "strict_rerun": ["X.bin", "W.bin", "H.bin", "--strict-compat"]}
    recs = {}
    for tag, args in runs.items():
        _cli(["run", *args, "-o", f"W_{tag}.bin", f"H_{tag}.bin", "--jsonl", f"{tag}.jsonl",
              "-q"], tmp)
        recs[tag] = json.loads(pathlib.Path(tmp, f"{tag}.jsonl").read_text().splitlines()[-1])
        check(recs[tag]["iterations"] == 200, f"CLI {tag}: {recs[tag]['iterations']} iterations")
    w0, h0 = nt.nndsvd_init(x, 128, "nndsvda")
    cfg = nt.reference_preset()
    for tag, (w_in, h_in, c) in {"nndsvda": (w0, h0, cfg),
                                 "accelerate": (w, h, dataclasses.replace(cfg, accelerate=True))
                                 }.items():
        res = nt.solve(x, w_in, h_in, c, device="cuda")
        w_out, h_out = _cli_files(tmp, tag)
        check(w_out.tobytes() == res.w.cpu().numpy().tobytes()
              and h_out.tobytes() == res.h.cpu().numpy().tobytes(),
              f"CLI {tag}: files differ from the in-process solve")
        costs = [c_["cost"] for c_ in recs[tag]["checks"]]
        check(len(costs) == 8 and all(b <= a for a, b in zip(costs, costs[1:])),
              f"CLI {tag}: checks {costs}")
        out["cli"][tag] = recs[tag]["final_cost"]
        print(f"[{card}] CLI run {' '.join(runs[tag])}: files byte-equal to the in-process solve, "
              f"final cost {recs[tag]['final_cost']}, history {costs}, {recs[tag]['iters_per_sec']} it/s")
    strict, again = _cli_files(tmp, "strict"), _cli_files(tmp, "strict_rerun")
    check(strict[0].shape == (4096, 128) and strict[1].shape == (128, 350),
          f"CLI strict: shapes {strict[0].shape}, {strict[1].shape}")
    check(all(a.tobytes() == b.tobytes() for a, b in zip(strict, again)),
          "CLI strict: files differ on a rerun")
    out["cli"]["strict"] = recs["strict"]["final_cost"]
    print(f"[{card}] CLI run --strict-compat: de-padded to 4096x128 / 128x350, byte-identical on a "
          f"rerun, final cost {recs['strict']['final_cost']} (over the padded 4096x352 buffers; "
          f"rel {abs(recs['strict']['final_cost'] - PIN_COST) / PIN_COST} to the pin)")


def _tier_configs():
    """tier -> (SolveConfig, ran through the CLI): the CLI tiers, parsed as
    the CLI parses them, and bf16 state, which only the API reaches."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.cli import build_parser

    tiers = {}
    for tier, flags in TIERS.items():
        args = build_parser().parse_args(["run", "X.bin", *flags])
        prec = nt.Precision(matmul_dtype=args.dtype, x_dtype=args.x_dtype,
                            x_quant_rows=args.x_quant_rows)
        tiers[tier] = (dataclasses.replace(nt.reference_preset(), precision=prec), True)
    prec = _modes()["bf16_full_state"][0]
    tiers["bf16_full_state"] = (dataclasses.replace(nt.reference_preset(), precision=prec), False)
    return tiers


def phase_inprocess(card, tmp, out):
    print(f"[{card}] phase 6: reference pipeline in-process through solve, every tier")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    x, w, h = (nt.read_matrix(os.path.join(tmp, f"{s}.bin")) for s in "XWH")
    for tier, (cfg, via_cli) in _tier_configs().items():
        fused_mu.reset_counts()
        t0 = time.perf_counter()
        res = nt.solve(x, w, h, cfg, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, plain_calls = dict(fused_mu.LAUNCHES), dict(fused_mu.PLAIN_CALLS)
        want = _launches(**({} if cfg.precision.x_quant_rows
                            else {"update_h": 200, "update_w": 200, "kl_cost": 8}))
        check(launches == want, f"{tier}: launches {launches}, expected {want}")
        check(not any(plain_calls.values()), f"{tier}: plain calls on the card {plain_calls}")
        out["launches"][tier] = launches
        hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
        check(int(res.iterations) == 200 and hist.shape == (8,), f"{tier}: 200 iterations / 8 checks")
        check(bool(np.all(np.diff(hist) < 0)), f"{tier}: costs not decreasing: {hist}")
        cost = float(res.cost)
        w1, h1 = (t.cpu().float().numpy() for t in (res.w, res.h))
        res2 = nt.solve(x, w, h, cfg, device="cuda")
        check(w1.tobytes() == res2.w.cpu().float().numpy().tobytes(), f"{tier}: W differs on a rerun")
        check(h1.tobytes() == res2.h.cpu().float().numpy().tobytes(), f"{tier}: H differs on a rerun")
        if via_cli:
            wout = nt.read_matrix(os.path.join(tmp, f"W_{tier}.bin"))
            hout = nt.read_matrix(os.path.join(tmp, f"H_{tier}.bin"))
            check(wout.tobytes() == w1.tobytes() and hout.tobytes() == h1.tobytes(),
                  f"{tier}: CLI output files differ from the in-process factors")
        plain = nt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"), device="cuda")
        c_plain = float(plain.cost)
        rel = abs(cost - c_plain) / abs(c_plain)
        limit = 1e-3 if cfg.precision.matmul_dtype == "bfloat16" else 1e-4
        check(rel <= limit, f"{tier}: cost {cost} vs plain (backend='jnp') {c_plain}: rel {rel}")
        if tier in ("float32", "float32_fast"):
            pin = abs(cost - PIN_COST) / PIN_COST
            check(pin <= 1e-4, f"{tier}: final cost {cost} vs {PIN_COST}: rel {pin}")
        print(f"[{card}] solve {tier}: launches {launches}, cost {cost} (plain {c_plain}, "
              f"rel {rel}, limit {limit}), history {hist.tolist()}, {secs} s (first solve of "
              f"the tier), byte-identical on rerun{' and vs the CLI files' if via_cli else ''}")


def _split_exposed(g, shape):
    """Phase 3's ``float32_fast`` W or H (``_exposed``), made on the card:
    hi + lo, hi a power of two and lo = hi * 2**-8 * u, u in [0.5, 1) on 8
    bits."""
    hi = torch.exp2(-torch.randint(0, 4, shape, generator=g, device="cuda").float())
    u = (128 + torch.randint(0, 128, shape, generator=g, device="cuda")).float() / 256
    return hi + hi * 2.0 ** -8 * u


def _walk_operands(m, n, k, mode, spec):
    """A long-walk check's operands, made on the card from a seed: X
    uniform; f32 state: W and H as phase 3's for ``mode`` (``_exposed``:
    ``bfloat16`` 2**-10 above bf16-exact values, ``float32_fast`` split
    exactly into (hi, lo)); bf16 state: X as phase 9a's (``_num_operands``:
    a skipped rounding of Z shows)."""
    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    w, h, x = (torch.rand(s, generator=g, device="cuda").clamp_(min=EPS)
               for s in ((m, k), (k, n), (m, n)))
    if spec.state == torch.bfloat16:
        w, h = w.bfloat16(), h.bfloat16()
        return w, h, (x.bfloat16().double() * (1 + 2.0 ** -10) * (w.double() @ h.double())).float()
    if mode == "float32_fast":
        return _split_exposed(g, (m, k)), _split_exposed(g, (k, n)), x
    return w.bfloat16().float() * (1 + 2.0 ** -10), h.bfloat16().float() * (1 + 2.0 ** -10), x


def _walk_tiles(name, m, n, k):
    """Tiles a K1 (update_h) or K2 block walks: the planner's tiles_per_split."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    chunks = -(-k // fused_mu.chunk_width(k))
    m_tiles, n_tiles = -(-m // fused_mu.TILE), -(-n // fused_mu.TILE)
    if name == "update_h":
        return fused_mu.plan_split(n_tiles, chunks, m_tiles)[1]
    return fused_mu.plan_split(m_tiles, chunks, n_tiles)[1]


def _check_long_walks(card, out):
    """``bfloat16`` and ``float32_fast`` K1/K2, one call each against its
    plain version on the same operands, where a block's contraction walks
    farthest (LONG_WALKS): within the mode's ``MODE_LIMITS`` (max and RMS
    relative error), the f32-GEMM control failing the RMS limit, bitwise on
    a rerun.  f32 state: the full update (phase 3's ``bfloat16`` and
    ``float32_fast``); bf16 state (``bfloat16``): the f32 numerator
    (``numerator_only``, phase 9a's ``bf16_state``), which shows a drift
    the bf16 result would round away."""
    checks = {("bfloat16", "f32 state"): (_modes()["bfloat16"], _pairs),
              ("bfloat16", "bf16 state"): (_num_modes()["bf16_state"], _num_pairs),
              ("float32_fast", "f32 state"): (_modes()["float32_fast"], _pairs)}
    for m, n, k in LONG_WALKS:
        for (mode, label), (spec, pairs_of) in checks.items():
            max_limit, spread_limit, _ = MODE_LIMITS[mode]
            w, h, x = _walk_operands(m, n, k, mode, spec)
            pairs, controls = pairs_of(spec.prec), pairs_of(spec.control)
            for name, (kern, plain) in pairs.items():
                if name not in ("update_h", "update_w"):
                    continue
                per = _walk_tiles(name, m, n, k)
                where = _where(name, w, h, f"[{mode}, {label}, {per} tiles a split] ")
                res, ref = _run_pair(kern, plain, w, h, x, where)
                check(res.dtype == torch.float32, f"{where}: dtype {res.dtype}")
                err, spread, _ = _mode_err(res, ref)
                c_spread = _mode_err(controls[name][0](w, h, x), ref)[1]
                del res, ref
                what = (f"max rel err {err} (limit {max_limit}), rms rel err {spread} (limit "
                        f"{spread_limit}); control (f32 GEMMs) {c_spread}")
                check(err <= max_limit and spread <= spread_limit, f"{where}: {what}")
                check(c_spread > spread_limit, f"{where}: the control reads {c_spread}, within "
                      f"the limit {spread_limit}")
                out["kernels"][name]["long_walks"][f"{mode} {label} {m}x{n}x{k}"] = {
                    "tiles_per_split": per, "max_rel_err": err, "rms_rel_err": spread,
                    "control_rms": c_spread}
                print(f"[{card}] {where}: {what}, bitwise-repeatable")
            del w, h, x
            torch.cuda.empty_cache()


def phase_flagship(card, out):
    print(f"[{card}] phase 7: flagship 10240x10240, K=256, 50 iterations, float32, bfloat16 "
          "and float32_fast")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.utils.metrics import flops_per_iter

    m = n = 10240
    k = 256
    iters = 50
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((m, n), generator=g, device="cuda")
    w = torch.rand((m, k), generator=g, device="cuda")
    h = torch.rand((k, n), generator=g, device="cuda")
    # one call of K1 and K2 under each GEMM policy, timed as in phase 2 with
    # fewer samples (a call takes milliseconds here)
    for dtype in ("float32", "bfloat16", "float32_fast"):
        pairs = _pairs(nt.Precision(dtype))
        impls = _check_impls(lambda: [pairs[nm][0](w, h, x) for nm in ("update_h", "update_w")],
                             nt.Precision(dtype), f"flagship [{dtype}]")
        for name in ("update_h", "update_w"):
            kern, plain = pairs[name]
            kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x), 5, 5)
            b_ms, b_by = _mu_bound(name, w, h, x, nt.Precision(dtype))
            out["kernels"][name]["flagship"][dtype] = {"ms": kms, "plain_ms": pms, "bound_ms": b_ms,
                                                       "bound_by": b_by, "impl": impls[name]}
            print(f"[{card}] flagship {name} [{dtype}] {m}x{n}x{k}: kernel {kms} ms, "
                  f"plain {pms} ms, bound {b_ms} ms ({b_by}), {impls[name]} "
                  f"({2 * 2 * m * n * k / kms / 1e9} TFLOP/s)")
        # K3 under the same policy: checked, its instance read, timed
        kern, plain = pairs["kl_cost"]
        where = f"flagship kl_cost [{dtype}] {m}x{n}x{k}"
        res, ref = _run_pair(kern, plain, w, h, x, where)
        rel = _mode_err(res, ref)[0]
        check(rel <= MODE_LIMITS["f32_gemm"][2], f"{where}: rel err {rel} (limit 1e-5)")
        inst = _check_kl_mode(kern, w, h, x, nt.Precision(dtype), where)
        kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x), 5, 5)
        b_ms, b_by = _mu_bound("kl_cost", w, h, x, nt.Precision(dtype))
        out["kernels"]["kl_cost"]["flagship"][dtype] = {
            "ms": kms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by, "impl": _kl_impl(inst),
            "instance": inst, "rel_err": rel}
        print(f"[{card}] {where}: kernel {kms} ms, plain {pms} ms, bound {b_ms} ms ({b_by}), {inst}, "
              f"rel err {rel}, {2 * m * n * k / kms / 1e9} TFLOP/s of its recon")
    for dtype, limit in (("float32", 1e-4), ("bfloat16", 1e-3), ("float32_fast", 1e-4)):
        base = nt.SolveConfig(max_iter=iters, check_every=25, precision=nt.Precision(dtype))
        results = {}
        for backend in ("auto", "jnp"):   # warm each path once (allocator, cuBLAS)
            nt.solve(x, w, h, dataclasses.replace(base, backend=backend, max_iter=1),
                     device="cuda")
        torch.cuda.synchronize()
        for backend in ("auto", "jnp", "jnp", "auto"):
            fused_mu.reset_counts()
            t0 = time.perf_counter()
            res = nt.solve(x, w, h, dataclasses.replace(base, backend=backend), device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            cost = float(res.cost)
            if backend == "auto":   # 50 iterations, a cost every 25: 50/50/2
                want = _launches(update_h=iters, update_w=iters, kl_cost=iters // 25)
                check(fused_mu.LAUNCHES == want and not any(fused_mu.PLAIN_CALLS.values()),
                      f"flagship {dtype}: launches {fused_mu.LAUNCHES}, plain calls "
                      f"{fused_mu.PLAIN_CALLS}, expected {want}")
                out["launches"][f"flagship {dtype}"] = dict(fused_mu.LAUNCHES)
            check(np.isfinite(cost) and int(res.iterations) == iters,
                  f"flagship {dtype} {backend}: cost {cost}")
            results.setdefault(backend, []).append((secs, cost))
        c_k, c_p = results["auto"][0][1], results["jnp"][0][1]
        rel = abs(c_k - c_p) / abs(c_p)
        check(rel <= limit, f"flagship {dtype}: cost kernel {c_k} vs plain {c_p}: rel {rel}")
        for backend, label in (("auto", "kernels"), ("jnp", "plain (cuBLAS f32)")):
            for secs, cost in results[backend]:
                ips = iters / secs
                tf = flops_per_iter(m, k, n) * ips / 1e12
                out["flagship"].setdefault(f"{dtype} {label}", []).append(ips)
                print(f"[{card}] flagship {dtype} {label}: {secs} s for {iters} iterations + "
                      f"2 costs, {ips} it/s, {tf} TFLOP/s, final cost {cost}")
        print(f"[{card}] flagship {dtype} costs agree: rel {rel} (limit {limit})")
    del x, w, h
    _check_long_walks(card, out)
    _check_kl_long_walks(card, out)


def _check_kl_long_walks(card, out):
    """K3 where its blocks walk farthest (LONG_WALKS: 40, 17 and 303 tiles
    a split) on phase 3's ``bfloat16`` operands (2**-10 above bf16-exact
    values): ``bfloat16`` (BF16) with the f32-recon control failing, and
    ``float32`` and ``float32_fast`` (F32), each within cost rel 1e-5 of
    ``kl_cost_plain``, bitwise on a rerun."""
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.utils.config import Precision

    limit = MODE_LIMITS["bfloat16"][2]
    spec = _modes()["bfloat16"]
    for m, n, k in LONG_WALKS:
        w, h, x = _walk_operands(m, n, k, "bfloat16", spec)
        per = fused_mu.kl_split(m, n, k)[2]
        for dtype in ("bfloat16", "float32", "float32_fast"):
            prec = Precision(dtype)
            kern, plain = _pairs(prec)["kl_cost"]
            where = _where("kl_cost", w, h, f"[{dtype}, {per} tiles a split] ")
            res, ref = _run_pair(kern, plain, w, h, x, where)
            rel = _mode_err(res, ref)[0]
            inst = _check_kl_mode(kern, w, h, x, prec, where)
            what = f"rel err {rel} (limit {limit}), {inst}"
            check(rel <= limit, f"{where}: {what}")
            entry = {"tiles_per_split": per, "rel_err": rel, "instance": inst}
            if dtype == "bfloat16":
                c_rel = _mode_err(_pairs(spec.control)["kl_cost"][0](w, h, x), ref)[0]
                check(c_rel > limit, f"{where}: the control (f32 recon) reads {c_rel}, within "
                      f"the limit {limit}")
                entry["control_rel"] = c_rel
                what += f"; control (f32 recon) {c_rel}"
            out["kernels"]["kl_cost"]["long_walks"][f"{dtype} {m}x{n}x{k}"] = entry
            print(f"[{card}] {where}: {what}, bitwise-repeatable")
        del w, h, x
        torch.cuda.empty_cache()


def tile_problem(m, k, n, tile, occ_frac, seed=0):
    """Clustered-sparse X and dense W, H: the generator of the JAX package's
    tile-sparse benchmark (benchmarks/tile_sparse_tune.py:29-41), copied
    because its harness imports the JAX package."""
    rng = np.random.RandomState(seed)
    mb, nb = m // tile, n // tile
    occ = rng.rand(mb, nb) < occ_frac
    x = np.zeros((m, n), np.float32)
    for i, j in zip(*np.nonzero(occ)):
        blk = rng.rand(tile, tile).astype(np.float32)
        blk[rng.rand(tile, tile) < 0.5] = 0
        x[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = blk
    w = rng.rand(m, k).astype(np.float32)
    h = rng.rand(k, n).astype(np.float32)
    return x, w, h


def _fixed_tile_problem(m, k, n, tile, blocks, seed, zero_frac):
    """X with the given occupied blocks (their entries zeroed at random),
    W and H clamped: the problems of tests/test_pallas.py and
    tests/test_sparse.py."""
    rng = np.random.RandomState(seed)
    x = np.zeros((m, n), np.float32)
    for i, j in blocks:
        blk = rng.rand(*tile).astype(np.float32)
        blk[rng.rand(*tile) < zero_frac] = 0
        rows, cols = slice(i * tile[0], (i + 1) * tile[0]), slice(j * tile[1], (j + 1) * tile[1])
        x[rows, cols] = blk[: min(tile[0], m - i * tile[0]), : min(tile[1], n - j * tile[1])]
    w = np.maximum(rng.rand(m, k).astype(np.float32), np.float32(EPS))
    h = np.maximum(rng.rand(k, n).astype(np.float32), np.float32(EPS))
    return x, w, h


def _ts_cases():
    """name -> (X, W, H, tile, pad) for the K5 checks; "main" is the
    solve's.  pad: the tile list padded to a multiple of it with zero tiles
    at block (0, 0), as the tiled solve pads it (1: not padded).  The long
    runs: 300 full 128^2 tiles in one column block (the H target's run of
    one output block crosses many pieces) and its transpose (the W
    target's): K5's counterpart of ``LONG_WALKS``."""
    m, n, k, t, occ, seed = TS_MAIN
    pallas = _fixed_tile_problem(
        512, 16, 640, (128, 128), [(0, 0), (1, 2), (3, 4), (2, 2), (0, 4)], 3, 0.6)
    tall = _fixed_tile_problem(38_400, 128, 128, (128, 128), [(i, 0) for i in range(300)], 7, 0.0)
    wide = _fixed_tile_problem(128, 128, 38_400, (128, 128), [(0, j) for j in range(300)], 8, 0.0)
    cases = {
        "pallas 512x640 K=16": (*pallas, (128, 128)),
        "padded 512x640 K=16": (*pallas, (128, 128), 64),
        "ragged 160x200 K=8": (*_fixed_tile_problem(
            160, 8, 200, (32, 32), [(0, 0), (1, 3), (2, 5), (4, 6), (3, 1), (0, 4)], 41, 0.5),
            (32, 32)),
        "96x160 tiles 288x480 K=24": (*_fixed_tile_problem(
            288, 24, 480, (96, 160), [(0, 0), (0, 2), (1, 1), (2, 1), (2, 2)], 5, 0.5), (96, 160)),
        "main": (*tile_problem(m, k, n, t, occ, seed), (t, t)),
        "K=300": (*tile_problem(384, 300, 512, 128, 0.5, 1), (128, 128)),
        "K=2048": (*tile_problem(256, 2048, 384, 128, 0.5, 2), (128, 128)),
        "long run 38400x128 K=128": (*tall, (128, 128)),
        "long run 128x38400 K=128": (*wide, (128, 128)),
    }
    return {label: case if len(case) == 5 else (*case, 1) for label, case in cases.items()}


class SweepCase(NamedTuple):
    w: torch.Tensor        # (Mp, K), padded with zeros
    h: torch.Tensor        # (K, Np)
    tiles: torch.Tensor    # (T, bm, bn)
    plans: dict            # target -> (perm, rb, cb) int32 on the card
    layouts: dict          # target -> SweepLayout on the card (the plain version's)
    empty: dict            # target -> output blocks with no tile


def _sweep_case(x, w, h, tile, pad=1):
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.sparse_tiled import _pad_tiles_np
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    tx = nt.tiles_from_dense(x, tile)
    tx = dataclasses.replace(tx, **dict(zip(("tiles", "rows", "cols"), _pad_tiles_np(
        np.asarray(tx.tiles), np.asarray(tx.rows), np.asarray(tx.cols), pad))))
    bm, bn = tile
    mb, nb = -(-x.shape[0] // bm), -(-x.shape[1] // bn)
    wp = np.zeros((mb * bm, w.shape[1]), np.float32)
    hp = np.zeros((h.shape[0], nb * bn), np.float32)
    wp[: w.shape[0]], hp[:, : h.shape[1]] = w, h
    plans, layouts, empty = {}, {}, {}
    for target, by, n_out in (("h", "col", nb), ("w", "row", mb)):
        plan = ts.sweep_plan(tx.rows, tx.cols, n_out, by)
        plans[target] = tuple(torch.from_numpy(a).cuda() for a in plan)
        layouts[target] = ts.sweep_layout(*plan, n_out, target, device="cuda")
        key = plan[2] if by == "col" else plan[1]
        empty[target] = sorted(set(key[plan[0] < 0].tolist()))
    return SweepCase(torch.from_numpy(wp).cuda(), torch.from_numpy(hp).cuda(),
                     torch.from_numpy(tx.tiles).cuda(), plans, layouts, empty)


def _z_biased_tiles(case, bm, bn):
    """f32 tiles on which a kernel that skips rounding Z to bf16 is off by a
    bias of one sign: X = b * (1 + 2**-10) * Y, b the tile's own values
    rounded to bf16 and Y = W H (bf16 W and H, in f64), so that the sound
    Z = X / Y rounds to b and the skipped one sits 2**-10 above it."""
    perm, rb, cb = (a.long() for a in case.plans["h"])
    real = perm >= 0
    perm, rb, cb = perm[real], rb[real], cb[real]
    k = case.w.shape[1]
    wb = case.w.to(torch.bfloat16).double().reshape(-1, bm, k)
    hb = case.h.to(torch.bfloat16).double().reshape(k, -1, bn).permute(1, 0, 2)
    y = torch.bmm(wb[rb], hb[cb])
    b = case.tiles[perm].to(torch.bfloat16).double()
    tiles = torch.empty_like(case.tiles)
    tiles[perm] = (b * (1 + 2.0 ** -10) * y).float()
    return tiles


def _k5_modes():
    """mode -> (Precision, W/H dtype, operands, limits, control Precision):
    operands "base", "exposed" (phase 3's W and H), "bf16_tiles", or
    "z_biased" (X built so that a skipped rounding of Z shows)."""
    from nmf_tpu_torch.utils.config import Precision

    f32 = Precision()
    bf16_state = Precision("bfloat16", "bfloat16", "float32")
    return {
        "float32": (f32, torch.float32, "base", None, None),
        "bfloat16": (Precision("bfloat16"), torch.float32, "exposed",
                     MODE_LIMITS["bfloat16"], f32),
        "float32_fast": (Precision("float32_fast"), torch.float32, "exposed",
                         MODE_LIMITS["float32_fast"], f32),
        "bf16_tiles": (Precision(x_dtype="bfloat16"), torch.float32, "bf16_tiles",
                       MODE_LIMITS["f32_gemm"], None),
        # W and H in bf16 are their own rounding: the control skips only Z's
        "bf16_state": (bf16_state, torch.bfloat16, "z_biased", MODE_LIMITS["bfloat16"],
                       dataclasses.replace(bf16_state, matmul_dtype="float32")),
    }


def _k5_err(out, ref, where):
    """(largest relative error, RMS relative error) over the entries where
    the plain version is not zero; where it is zero (blocks with no tile,
    padding) the kernel must read exactly zero too."""
    zero = ref == 0
    check(bool((out[zero] == 0).all()), f"{where}: nonzero where the plain version is zero")
    rel = ((out.double() - ref.double()).abs() / ref.double().abs())[~zero]
    return float(rel.max()), float(rel.square().mean().sqrt())


def _k5_bound(w, h, tiles, plan, target, prec):
    """K5's bound on these operands: two GEMMs of bm x bn x K a real plan
    entry (three bf16 passes each under split3), the tiles, W, H and the
    plan read once, the numerator written once."""
    bm, bn = tiles.shape[1:]
    k = w.shape[1]
    entries = int((plan[0] >= 0).sum())
    passes = 3 if prec.matmul_dtype == "float32_fast" else 1
    flops = passes * 4 * bm * bn * k * entries
    out_words = k * h.shape[1] if target == "h" else w.shape[0] * k
    nbytes = (tiles.numel() * tiles.element_size()
              + (w.numel() + h.numel()) * w.element_size()
              + 3 * 4 * plan[0].numel() + 4 * out_words)
    kind = "float32" if prec.matmul_dtype == "float32" else "bfloat16"
    return bound(flops, nbytes, kind)


def phase_tilesparse_kernels(card, out):
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    stats = out["kernels"]
    modes = _k5_modes()
    for label, (x, w, h, tile, pad) in _ts_cases().items():
        base = _sweep_case(x, w, h, tile, pad)
        bm, bn = tile
        for mode, (prec, state, operands, limits, control) in modes.items():
            wk, hk, tiles = base.w, base.h, base.tiles
            if operands == "exposed":
                rng = np.random.RandomState(sum(wk.shape) + hk.shape[1])
                wk, hk = _exposed(rng, tuple(wk.shape), mode), _exposed(rng, tuple(hk.shape), mode)
            elif operands == "bf16_tiles":
                tiles = tiles.to(torch.bfloat16)
            elif operands == "z_biased":
                tiles = _z_biased_tiles(base, bm, bn)
            wk, hk = wk.to(state), hk.to(state)
            for target, fn in (("h", ts.h_numerator), ("w", ts.w_numerator)):
                name = f"{target}_numerator"
                plan, layout = base.plans[target], base.layouts[target]
                where = f"{name} [{mode}] {label} tiles {bm}x{bn}"

                def kern(p=prec):
                    return fn(wk, hk, tiles, *plan, EPS, p)

                def plain():
                    return ts.sweep_plain(wk, hk, tiles, layout, EPS, prec, target)

                _, counts = sweep_counts(kern)
                ran = _mode_of_counts(counts[name], where)
                other = "w_numerator" if target == "h" else "h_numerator"
                check(ran == K5_MODE[mode] and not any(counts[other]),
                      f"{where}: K5 ran the {ran} instance ({counts}), expected {K5_MODE[mode]}")
                res, ref = _run_pair(lambda *_: kern(), lambda *_: plain(), wk, hk, tiles, where)
                n_out = res.shape[1] // bn if target == "h" else res.shape[0] // bm
                blocks = (res.reshape(-1, n_out, bn).transpose(0, 1) if target == "h"
                          else res.reshape(n_out, bm, -1))
                check(all(bool((blocks[b] == 0).all()) for b in base.empty[target]),
                      f"{where}: a block with no tile is not exactly zero")
                err, spread = _k5_err(res, ref, where)
                max_abs = float((res - ref).abs().max())
                if limits is None:   # float32: phase 2's tolerance
                    rtol, atol, _ = F32_TOL
                    worst = float(((res - ref).abs() - rtol * ref.abs()).max())
                    check(worst <= atol, f"{where}: worst excess over rtol {rtol}: {worst}")
                    what = f"max abs err {max_abs}, worst excess over rtol {rtol}: {worst}"
                else:
                    max_limit, spread_limit, _ = limits
                    check(max_limit is None or err <= max_limit,
                          f"{where}: max rel err {err} (limit {max_limit})")
                    check(spread_limit is None or spread <= spread_limit,
                          f"{where}: rms rel err {spread} (limit {spread_limit})")
                    what = (f"max rel err {err} (limit {max_limit}), rms rel err {spread} "
                            f"(limit {spread_limit})")
                st = stats[name]
                ms = st["modes"].setdefault(mode, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                                   "err": 0.0, "limit": limits and limits[1],
                                                   "impl": IMPL.get(ran, "simt")})
                ms["max_abs_err"] = max(ms["max_abs_err"], max_abs)
                ms["max_rel_err"] = max(ms["max_rel_err"], err)
                ms["err"] = max(ms["err"], spread)
                if mode == "float32":
                    st["max_abs_err"] = max(st["max_abs_err"], max_abs)
                if control is not None:
                    _, c_spread = _k5_err(kern(control), ref, where)
                    check(c_spread > limits[1], f"{where}: the control ({control.matmul_dtype} "
                          f"GEMMs) reads {c_spread}, within the limit {limits[1]}")
                    ms["control_min"] = min(ms.get("control_min", c_spread), c_spread)
                    what += f"; control ({control.matmul_dtype} GEMMs) {c_spread}"
                if label == "main":   # the solve's shape, timed
                    kms, pms = timed_pair(kern, plain)
                    b_ms, b_by = _k5_bound(wk, hk, tiles, plan, target, prec)
                    ms.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
                    if mode == "float32":
                        st.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                                  impl=IMPL.get(ran, "simt"))
                    what = (f"kernel {kms} ms, plain {pms} ms, bound {b_ms} ms ({b_by}); "
                            + what)
                print(f"[{card}] {where}: {what}, bitwise-repeatable, instance {ran}")


def _ts_solve(x, w, h, cfg, **kw):
    """(result, host seconds) of one tile-sparse solve on the card."""
    import nmf_tpu_torch as nt

    t0 = time.perf_counter()
    res = nt.solve_sparse_tiled(x, w, h, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _counted(fn):
    """(fn(), K5 launches, K5 plain calls, K1-K3 launches) with every count
    set to 0 just before."""
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    fused_mu.reset_counts()
    ts.reset_counts()
    res = fn()
    return res, dict(ts.LAUNCHES), dict(ts.PLAIN_CALLS), dict(fused_mu.LAUNCHES)


def _check_history(res, where):
    hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
    check(int(res.iterations) == TS_ITERS and hist.shape == (TS_ITERS // 25,),
          f"{where}: {int(res.iterations)} iterations, {hist.shape[0]} checks")
    check(bool(np.all(np.isfinite(hist)) and np.all(np.diff(hist) < 0)),
          f"{where}: costs not finite and decreasing: {hist}")
    return hist


def phase_tilesparse_solves(card, out):
    import nmf_tpu_torch as nt

    m, n, k, t, occ, seed = TS_MAIN
    x, w, h = tile_problem(m, k, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    print(f"[{card}] tile-sparse X {m}x{n}, {t}x{t} tiles: {tx.tiles.shape[0]} occupied "
          f"(occupancy {tx.occupancy()}), K={k}, {TS_ITERS} iterations")
    eps = np.float32(EPS)
    want = {"h_numerator": TS_ITERS, "w_numerator": TS_ITERS}
    for dtype, limit in (("float32", 1e-4), ("bfloat16", 1e-3), ("float32_fast", 1e-4)):
        cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, precision=nt.Precision(dtype))
        # warm both paths once (the library, the allocator, cuBLAS)
        for backend in ("auto", "jnp"):
            _ts_solve(tx, w, h, dataclasses.replace(cfg, backend=backend, max_iter=2))
        ((res, secs), per_mode), launches, plain_calls, dense = _counted(
            lambda: sweep_counts(lambda: _ts_solve(tx, w, h, cfg)))
        where = f"tiled solve [{dtype}]"
        check(launches == want, f"{where}: K5 launches {launches}, expected {want}")
        mode = K5_MODE[dtype]
        check(all(counts == [TS_ITERS if m == mode else 0 for m in MODES]
                  for counts in per_mode.values()),
              f"{where}: K5 pass-1 launches per Mode {per_mode}, expected {TS_ITERS} {mode}")
        check(not any(plain_calls.values()) and not any(dense.values()),
              f"{where}: plain calls {plain_calls}, K1-K3 launches {dense}")
        out["launches"][f"tiled {dtype}"] = launches
        hist = _check_history(res, where)
        res2, secs2 = _ts_solve(tx, w, h, cfg)
        for f in ("w", "h"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
                  f"{where}: {f.upper()} differs on a rerun")
        cost = float(res.cost)
        plain, p_secs = _ts_solve(tx, w, h, dataclasses.replace(cfg, backend="jnp"))
        rel = abs(cost - float(plain.cost)) / abs(float(plain.cost))
        check(rel <= limit, f"{where}: cost {cost} vs the jnp tiled solve {float(plain.cost)}: "
              f"rel {rel} (limit {limit})")
        line = (f"[{card}] {where}: K5 {launches} ({mode} instance), cost {cost}, history {hist.tolist()}, "
                f"byte-identical on rerun; {TS_ITERS / secs} and {TS_ITERS / secs2} it/s through "
                f"K5, {TS_ITERS / p_secs} it/s plain sweep (backend='jnp', cost {float(plain.cost)}, "
                f"rel {rel}, limit {limit})")
        out["tiled"][dtype] = {"k5_its": [TS_ITERS / secs, TS_ITERS / secs2],
                               "plain_its": TS_ITERS / p_secs, "rel_vs_plain": rel,
                               "impl": IMPL.get(mode, "simt")}
        if dtype == "float32":
            # the exact-zero contract: the dense solve through K1-K3 with
            # clamp_inputs=False on clamped factors
            nt.solve(x, np.maximum(w, eps), np.maximum(h, eps),
                     dataclasses.replace(cfg, max_iter=2), clamp_inputs=False, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (dres, _, _, dense) = _counted(lambda: nt.solve(
                x, np.maximum(w, eps), np.maximum(h, eps), cfg, clamp_inputs=False,
                device="cuda"))
            torch.cuda.synchronize()
            d_secs = time.perf_counter() - t0
            check(dense == _launches(update_h=TS_ITERS, update_w=TS_ITERS, kl_cost=TS_ITERS // 25),
                  f"dense solve: K1-K3 launches {dense}")
            d_rel = abs(cost - float(dres.cost)) / abs(float(dres.cost))
            check(d_rel <= 1e-4, f"{where}: cost {cost} vs the dense clamp_inputs=False solve "
                  f"{float(dres.cost)}: rel {d_rel}")
            line += (f"; dense solve through K1-K3 {TS_ITERS / d_secs} it/s (host clock incl. "
                     f"the {x.nbytes / 1e6} MB X upload), cost {float(dres.cost)}, rel {d_rel} "
                     "(limit 1e-4)")
            out["tiled"]["dense_its"] = TS_ITERS / d_secs
        print(line)

    # the RETUNE cell's rank, bfloat16 (the generator draws X before W and
    # H, so X and its tiles are the same)
    _, wk, hk = tile_problem(m, 256, n, t, occ, seed)
    cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, precision=nt.Precision("bfloat16"))
    _ts_solve(tx, wk, hk, dataclasses.replace(cfg, max_iter=2))
    (res, secs), launches, plain_calls, _ = _counted(lambda: _ts_solve(tx, wk, hk, cfg))
    check(launches == want and not any(plain_calls.values()), f"K=256: K5 launches {launches}")
    hist = _check_history(res, "tiled solve [bfloat16] K=256")
    out["tiled"]["bfloat16 K=256"] = TS_ITERS / secs
    print(f"[{card}] tiled solve [bfloat16] K=256: K5 {launches}, cost {float(res.cost)}, "
          f"{TS_ITERS / secs} it/s (host clock incl. the tile upload)")
    # int8 tiles: per-tile uint8 codes take the plain sweep by rule
    cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, precision=nt.Precision(x_dtype="int8"))
    (res, secs), launches, plain_calls, dense = _counted(lambda: _ts_solve(tx, w, h, cfg))
    check(not any(launches.values()) and not any(plain_calls.values()) and not any(dense.values()),
          f"int8 tiles: launches {launches}, plain calls {plain_calls}, K1-K3 {dense}")
    hist = _check_history(res, "tiled solve [int8 tiles]")
    print(f"[{card}] tiled solve [int8 tiles]: plain sweep by rule (0 launches), cost "
          f"{float(res.cost)}, history {hist.tolist()}, {TS_ITERS / secs} it/s")


def phase_tilesparse(card, out):
    print(f"[{card}] phase 8: tile-sparse K5 vs plain torch on the card, and the tiled solve")
    phase_tilesparse_kernels(card, out)
    phase_tilesparse_solves(card, out)


# Phase 9: the out-of-core streamed solve at an hour of audio, the ISMIR
# spectrogram (bench.py:59, BASELINE config 2: M=1025, K=32) over 172
# frames/s x 3600 s, rounded up to a multiple of 128 (nmf_tpu/parallel/
# mesh.py:24-26): X is 2.54 GB of f32, streamed in pick_block_n's 10 blocks.
OOC_SHAPE = (1025, 619_264, 32)        # M, N, K
OOC_BLOCK = 65_408                     # pick_block_n(1025, 619264): 256 MiB of f32
OOC_ITERS, OOC_CHECK = 10, 5
OOC_FACTOR_RTOL = 1e-4                 # streamed vs in-memory factors (max rel)
# the JAX package's out-of-core cell (benchmarks/run_all.py:578-593,
# bench.py:901-903): m, n, k, block_n
OOC_CLI = (2048, 8192, 128, 1024)
# phase 9a's mode -> the streamed run whose launches it reports
OOC_RUNS = {"float32": "oocore float32", "x_bfloat16": "oocore bfloat16", "x_int8": "oocore int8"}
# the modes whose streamed cost pass is a K3 call of its own (f32 GEMMs on
# the state and X as stored; the GEMM policies' cost passes are float32's)
OOC_COST_MODES = ("float32", "x_bfloat16", "x_int8", "bf16_state")


def _num_modes():
    """mode -> ModeCheck of K1/K2's numerator_only: phase 3's modes, and bf16
    state with f32 X built so that a skipped rounding of Z shows (the
    numerator is f32, so bf16 state has the ``bfloat16`` limits, as K5's;
    under ``float32_fast`` its own)."""
    from nmf_tpu_torch.utils.config import Precision

    f32 = Precision()
    bf16_state = Precision("bfloat16", "bfloat16", "float32")
    modes = {"float32": ModeCheck(f32, torch.float32, "f32", MODE_LIMITS["f32_gemm"])}
    modes.update((mode, spec) for mode, spec in _modes().items() if spec.state == torch.float32)
    modes["bf16_state"] = ModeCheck(bf16_state, torch.bfloat16, "z_biased",
                                    MODE_LIMITS["bfloat16"],
                                    dataclasses.replace(bf16_state, matmul_dtype="float32"),
                                    ("update_h", "update_w"))
    modes["float32_fast_bf16_state"] = _modes()["float32_fast_bf16_state"]._replace(
        limits=MODE_LIMITS["float32_fast"])
    return modes


def _num_operands(m, n, k, mode, spec):
    """Phase 3's operands; for bf16 state X = b (1 + 2**-10) W H with b
    bf16-exact and W H in f64 from the bf16 factors, so that the sound Z
    rounds to b and a Z left unrounded sits 2**-10 above it."""
    if spec.xform != "z_biased":
        return _mode_operands(m, n, k, mode, spec)
    w, h, x = _operands(m, n, k)
    w, h = w.to(torch.bfloat16), h.to(torch.bfloat16)
    y = w.double() @ h.double()
    x = (x.to(torch.bfloat16).double() * (1 + 2.0 ** -10) * y).float()
    return w, h, x


def _num_pairs(prec):
    """name -> (numerator_only kernel, its plain version) under ``prec``."""
    from nmf_tpu_torch.ops import mu
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.quant import dequantize

    def dense(x):
        return dequantize(*x) if isinstance(x, tuple) else x

    return {
        "update_h": (lambda w, h, x: fused_mu.update_h_fused(w, h, x, precision=prec,
                                                             numerator_only=True),
                     lambda w, h, x: mu.numerator_h(w, h, dense(x), precision=prec)),
        "update_w": (lambda w, h, x: fused_mu.update_w_fused(w, h, x, precision=prec,
                                                             numerator_only=True),
                     lambda w, h, x: mu.numerator_w(w, h, dense(x), precision=prec)),
    }


def _num_bound(name, w, h, x, prec):
    """A numerator's bound: the full update's flops and bytes, the output
    written in f32 (no epilogue: W and H are read for the GEMMs alone)."""
    m, k = w.shape
    n = h.shape[1]
    split3 = prec.matmul_dtype == "float32_fast"
    kind = "float32" if prec.matmul_dtype == "float32" else "bfloat16"
    flops = (3 if split3 else 1) * 2 * 2 * m * n * k
    x_bytes = sum(t.numel() * t.element_size() for t in (x if isinstance(x, tuple) else (x,)))
    out_words = k * n if name == "update_h" else m * k
    return bound(flops, x_bytes + (w.numel() + h.numel()) * w.element_size() + 4 * out_words, kind)


def _epilogue_of(name, w, h, num):
    """The full update from a numerator, in the kernels' order
    ``base * acc / denom`` (csrc/fused_mu.cu finalize), in the state dtype."""
    from nmf_tpu_torch.ops.elementwise import eps_clamp

    if name == "update_h":
        return (h.float() * num / eps_clamp(torch.sum(w, 0, dtype=torch.float32), EPS)[:, None]).to(h.dtype)
    return (w.float() * num / eps_clamp(torch.sum(h, 1, dtype=torch.float32), EPS)[None, :]).to(w.dtype)


def phase_numerators(card, out):
    print(f"[{card}] phase 9a: numerator_only of K1/K2 and the streamed K3 vs plain torch on "
          "the card, every mode")
    from nmf_tpu_torch.ops.kernels import fused_mu

    stats = out["kernels"]
    m_o, n_o, k_o = OOC_SHAPE
    block = (m_o, OOC_BLOCK, k_o)
    shapes = [*MODE_SHAPES, block, (m_o, n_o - (n_o // OOC_BLOCK) * OOC_BLOCK, k_o)]
    for mode, spec in _num_modes().items():
        pairs, controls = _num_pairs(spec.prec), (_num_pairs(spec.control) if spec.control else {})
        updates = _pairs(spec.prec)
        # the streamed cost pass: K3 with f32 GEMMs on the state as stored
        cost_prec = dataclasses.replace(spec.prec, matmul_dtype="float32")
        cost_pair = _pairs(cost_prec)["kl_cost"] if mode in OOC_COST_MODES else None
        max_limit, spread_limit, _ = spec.limits
        # the full update: bf16 state rounds its output (phase 3's limits)
        full_max, full_spread, _ = (MODE_LIMITS["bf16_state"] if spec.state == torch.bfloat16
                                    else spec.limits)
        for m, n, k in shapes:
            w, h, x = _num_operands(m, n, k, mode, spec)
            for name, (kern, plain) in pairs.items():
                where = _where(f"{name} numerator_only", w, h, f"[{mode}] ")
                res, ref = _run_pair(kern, plain, w, h, x, where)
                check(res.dtype == torch.float32, f"{where}: dtype {res.dtype}")
                check(tuple(res.shape) == ((k, n) if name == "update_h" else (m, k)),
                      f"{where}: shape {tuple(res.shape)}")
                err, spread, _ = _mode_err(res, ref)
                check(max_limit is None or err <= max_limit,
                      f"{where}: max rel err {err} (limit {max_limit})")
                check(spread_limit is None or spread <= spread_limit,
                      f"{where}: rms rel err {spread} (limit {spread_limit})")
                what = (f"max rel err {err} (limit {max_limit}), rms rel err {spread} "
                        f"(limit {spread_limit})")
                # the full update is this numerator through the epilogue, bit
                # for bit, and within the mode's limits of its plain version
                upd, upd_plain = (f(w, h, x) for f in updates[name])
                check(torch.equal(_bits(upd), _bits(_epilogue_of(name, w, h, res))),
                      f"{where}: the full update is not base * numerator / denom bitwise")
                f_err, f_spread, f_ulps = _mode_err(upd, upd_plain)
                check(f_ulps <= 1 and (full_max is None or f_err <= full_max)
                      and (full_spread is None or f_spread <= full_spread),
                      f"{where}: the full update vs plain: max rel err {f_err} (limit {full_max}), "
                      f"spread {f_spread} (limit {full_spread}), {f_ulps} bf16 ulps")
                key = "numerator_only" if mode == "float32" else f"numerator_only {mode}"
                ms = stats[name]["modes"].setdefault(
                    key, {"max_abs_err": 0.0, "max_rel_err": 0.0, "err": 0.0, "limit": spread_limit,
                          "launches_of": (OOC_RUNS.get(mode), f"{name}_numerator")})
                ms["max_abs_err"] = max(ms["max_abs_err"], float((res - ref).abs().max()))
                ms["max_rel_err"] = max(ms["max_rel_err"], err)
                ms["err"] = max(ms["err"], spread)
                if name in spec.controlled:
                    _, c_spread, _ = _mode_err(controls[name][0](w, h, x), ref)
                    check(c_spread > spread_limit, f"{where}: the control "
                          f"({spec.control.matmul_dtype} GEMMs) reads {c_spread}, within "
                          f"the limit {spread_limit}")
                    ms["control_min"] = min(ms.get("control_min", c_spread), c_spread)
                    what += f"; control ({spec.control.matmul_dtype} GEMMs) {c_spread}"
                if (m, n, k) == block:   # the streamed block, timed
                    kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x))
                    b_ms, b_by = _num_bound(name, w, h, x, spec.prec)
                    impl = _check_impls(lambda: [f(w, h, x) for f, _ in pairs.values()],
                                        spec.prec, where)[name]
                    ms.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, impl=impl)
                    what = (f"kernel {kms} ms ({impl}), plain {pms} ms, bound {b_ms} ms ({b_by}); "
                            + what)
                print(f"[{card}] {where}: {what}, bitwise-repeatable, epilogue bitwise, full "
                      f"update vs plain max rel {f_err} spread {f_spread}")
            if cost_pair:
                kern, plain = cost_pair
                where = _where("kl_cost streamed", w, h, f"[{mode}] ")
                res, ref = _run_pair(kern, plain, w, h, x, where)
                err = _mode_err(res, ref)[0]
                cost_limit = MODE_LIMITS["f32_gemm"][2]
                check(err <= cost_limit, f"{where}: rel err {err} (limit {cost_limit})")
                key = "streamed" if mode == "float32" else f"streamed {mode}"
                ms = stats["kl_cost"]["modes"].setdefault(
                    key, {"max_abs_err": 0.0, "max_rel_err": 0.0, "err": 0.0, "limit": cost_limit,
                          "launches_of": (OOC_RUNS.get(mode), "kl_cost")})
                ms["max_abs_err"] = max(ms["max_abs_err"], abs(float(res) - float(ref)))
                ms["max_rel_err"] = ms["err"] = max(ms["err"], err)
                inst = _check_kl_mode(kern, w, h, x, cost_prec, where)
                what = f"rel err {err} (limit {cost_limit}), {inst}"
                if (m, n, k) == block:
                    kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x))
                    b_ms, b_by = _mu_bound("kl_cost", w, h, x, cost_prec)
                    ms.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                              impl=_kl_impl(inst), instance=inst)
                    what = f"kernel {kms} ms, plain {pms} ms, bound {b_ms} ms ({b_by}); " + what
                print(f"[{card}] {where}: {what}, bitwise-repeatable")
            del w, h, x
    # above the rank ceiling the numerator takes the plain ops by rule
    k = fused_mu.MAX_FUSED_K + 8
    w, h, x = _operands(64, 96, k)
    for name, (kern, _) in _num_pairs(_num_modes()["float32"].prec).items():
        fused_mu.reset_counts()
        res = kern(w, h, x)
        check(res.dtype == torch.float32 and fused_mu.PLAIN_CALLS[f"{name}_numerator"] == 1
              and not any(fused_mu.LAUNCHES.values()),
              f"{name} numerator_only K={k}: did not take the plain ops by rule")
    print(f"[{card}] numerator_only K={k} > MAX_FUSED_K: plain ops by the rank rule, no launch")


def h2d_rate(nbytes) -> float:
    """Bytes/s of one pinned host-to-device copy of ``nbytes``: CUDA events,
    the median of 5 copies after a warm one."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for i in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b) / 1e3)
    return nbytes / statistics.median(times)


def _union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def _device_shares(trace_path):
    """Seconds of a chrome trace's device events: kernels, H2D copies, busy
    (the union of every kernel, copy and memset interval) and the overlap
    of kernels with H2D copies (both running at once)."""
    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(any(e["cat"] == "kernel" for e in dev), "the profiler recorded no kernel")
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in dev if e["cat"] == "kernel"]
    h2d = [(e["ts"], e["ts"] + e["dur"]) for e in dev
           if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    overlap = _union(kern) + _union(h2d) - _union(kern + h2d)
    return {"kernels": sum(t1 - t0 for t0, t1 in kern) / 1e6,
            "h2d": sum(t1 - t0 for t0, t1 in h2d) / 1e6,
            "busy": busy / 1e6, "overlap": overlap / 1e6}


def _host_timed(fn):
    """(fn's value, host seconds of each ``_BlockStream._put`` and ``_fill``
    call while it ran): ``_fill`` is a block's gather (and cast or
    quantization) into its pinned buffer, ``_put`` that plus the wait for
    the buffer's last copy and the copy's issue."""
    from nmf_tpu_torch.models import streaming

    cls = streaming._BlockStream
    times = {"_put": [], "_fill": []}
    originals = {name: getattr(cls, name) for name in times}

    def timed(name, f):
        def call(self, *args):
            t0 = time.perf_counter()
            try:
                return f(self, *args)
            finally:
                times[name].append(time.perf_counter() - t0)
        return call

    for name, f in originals.items():
        setattr(cls, name, timed(name, f))
    try:
        return fn(), times
    finally:
        for name, f in originals.items():
            setattr(cls, name, f)


def _ooc_solve(x, w, h, cfg, **kw):
    """(result, host seconds, K1-K3 launches, plain calls) of one streamed
    solve on the card, the counts set to 0 just before."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    fused_mu.reset_counts()
    t0 = time.perf_counter()
    res = nt.solve_out_of_core(x, w, h, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(fused_mu.LAUNCHES), dict(fused_mu.PLAIN_CALLS)


def _max_rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs()).max())


def phase_oocore_solves(card, out, seed):
    import gc

    import nmf_tpu_torch as nt

    m, n, k = OOC_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    xd = torch.rand((m, n), generator=g, device="cuda").clamp_min_(EPS)
    w = torch.rand((m, k), generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
    h = torch.rand((k, n), generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
    x = xd.cpu().numpy()
    del xd
    bn = nt.pick_block_n(m, n)
    blocks = -(-n // bn)
    check(bn == OOC_BLOCK and blocks == 10, f"pick_block_n gave {bn} ({blocks} blocks)")
    cfg = nt.SolveConfig(max_iter=OOC_ITERS, check_every=OOC_CHECK)
    passes = -(-OOC_ITERS // OOC_CHECK)
    streams = OOC_ITERS + passes
    print(f"[{card}] phase 9b: streamed solve {m}x{n}, K={k}: X {x.nbytes / 1e9} GB f32 in "
          f"{blocks} blocks of {bn} (last {n - (blocks - 1) * bn}), {OOC_ITERS} iterations, "
          f"cost passes every {OOC_CHECK}: {streams} streams of X")
    want = _launches(update_h=blocks * OOC_ITERS, update_w_numerator=blocks * OOC_ITERS,
                     kl_cost=blocks * passes)
    results = {}
    for xdt in ("float32", "bfloat16", "int8"):
        c = dataclasses.replace(cfg, precision=nt.Precision(x_dtype=xdt))
        # the in-memory solve on the same X first, freed before the
        # streamed run's memory is read
        t0 = time.perf_counter()
        mem = nt.solve(x, w, h, c, device="cuda")
        torch.cuda.synchronize()
        mem_secs = time.perf_counter() - t0
        mem_w, mem_h, mem_cost = mem.w.cpu(), mem.h.cpu(), float(mem.cost)
        del mem
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res, secs, launches, plain_calls = _ooc_solve(x, w, h, c)
        peak = torch.cuda.max_memory_allocated()
        where = f"streamed [{xdt} X]"
        check(launches == want, f"{where}: launches {launches}, expected {want}")
        check(not any(plain_calls.values()), f"{where}: plain calls {plain_calls}")
        hist = res.cost_history.numpy()[: int(res.num_checks)]
        check(int(res.iterations) == OOC_ITERS and hist.shape == (passes,)
              and bool(np.all(np.isfinite(hist))) and bool(np.all(np.diff(hist) < 0)),
              f"{where}: {int(res.iterations)} iterations, history {hist}")
        check(tuple(res.w.shape) == (m, k) and tuple(res.h.shape) == (k, n)
              and bool(torch.isfinite(res.w).all()) and bool(torch.isfinite(res.h).all()),
              f"{where}: factors not finite of the expected shapes")
        cost = float(res.cost)
        rel = abs(cost - mem_cost) / abs(mem_cost)
        check(rel <= 1e-5, f"{where}: cost {cost} vs the in-memory solve {mem_cost}: rel {rel}")
        fw, fh = _max_rel(res.w.cpu(), mem_w), _max_rel(res.h.cpu(), mem_h)
        check(max(fw, fh) <= OOC_FACTOR_RTOL, f"{where}: factors vs the in-memory solve: "
              f"max rel W {fw}, H {fh} (limit {OOC_FACTOR_RTOL})")
        out["launches"][f"oocore {xdt}"] = launches
        line = (f"[{card}] {where}: launches {launches}, cost {cost}, history {hist.tolist()}, "
                f"{OOC_ITERS / secs} it/s ({secs} s, first run); in-memory solve cost "
                f"{mem_cost} (rel {rel}, limit 1e-5), factors max rel W {fw} H {fh} (limit "
                f"{OOC_FACTOR_RTOL}), {OOC_ITERS / mem_secs} it/s incl. its upload; peak device "
                f"memory {peak / 1e9} GB (before the solve {base / 1e9} GB)")
        results[xdt] = {"its": OOC_ITERS / secs, "cost": cost, "rel_vs_memory": rel,
                        "factor_rel_vs_memory": max(fw, fh), "peak_gb": peak / 1e9}
        if xdt == "float32":
            wire = 4 * m * bn
            parts = {"W": 4 * m * k, "H": 4 * k * n, "two blocks": 2 * wire, "a1": 4 * m * k}
            line += f" = {', '.join(f'{p} {b / 1e9}' for p, b in parts.items())} GB + scratch"
            check(peak < x.nbytes / 3, f"{where}: peak device memory {peak} B not under a "
                  f"third of X ({x.nbytes} B)")
            first = res
        print(line)
        if xdt != "float32":
            continue
        # reruns: timed (with host timers around each block's staging),
        # then profiled; both byte-identical to the first
        rate0 = h2d_rate(4 * m * bn)
        (res2, secs2, _, _), host = _host_timed(lambda: _ooc_solve(x, w, h, c))
        rate1 = h2d_rate(4 * m * bn)
        check(len(host["_fill"]) == blocks * streams, f"{where}: {len(host['_fill'])} fills")
        fill_s = sum(host["_fill"])
        wait_s = sum(host["_put"]) - fill_s
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res3, secs3, _, _ = _ooc_solve(x, w, h, c)
        for r, label in ((res2, "timed"), (res3, "profiled")):
            for f in ("w", "h"):
                check(torch.equal(_bits(getattr(r, f)), _bits(getattr(first, f))),
                      f"{where}: {f.upper()} of the {label} rerun differs")
        rate = statistics.median([rate0, rate1])
        roof = streams * x.nbytes / rate
        with tempfile.TemporaryDirectory(prefix="nmf_trace_") as d:
            trace = os.path.join(d, "trace.json")
            prof.export_chrome_trace(trace)
            dev = {key: v / secs3 for key, v in _device_shares(trace).items()}
        fills_ms = sorted(1e3 * t for t in host["_fill"])
        results["time"] = {
            "its_timed": OOC_ITERS / secs2, "its_profiled": OOC_ITERS / secs3,
            "h2d_gbps": [rate0 / 1e9, rate1 / 1e9], "roofline_s": roof,
            "roofline_fraction": roof / secs2, "fill_share": fill_s / secs2,
            "put_wait_share": wait_s / secs2, "fill_ms_median": statistics.median(fills_ms),
            "fill_ms_max": fills_ms[-1], "kernel_share": dev["kernels"],
            "h2d_share": dev["h2d"], "overlap_share": dev["overlap"],
            "idle_share": 1 - dev["busy"],
        }
        print(f"[{card}] {where}: reruns byte-identical; timed {OOC_ITERS / secs2} it/s "
              f"({secs2} s for {streams} streams), profiled {OOC_ITERS / secs3} it/s; H2D "
              f"{rate0 / 1e9} / {rate1 / 1e9} GB/s (pinned, {4 * m * bn} B, before / after); "
              f"H2D roofline {roof} s = {roof / secs2} of the timed run reached; host over "
              f"the timed run: block fills (gather into pinned memory) {fill_s / secs2} of the "
              f"wall, {len(fills_ms)} fills, median {statistics.median(fills_ms)} ms, max "
              f"{fills_ms[-1]} ms; waits for a pinned buffer's copy and copy issue "
              f"{wait_s / secs2}; device over the profiled run: kernels {dev['kernels']}, H2D "
              f"copies {dev['h2d']}, kernels and copies at once {dev['overlap']}, busy "
              f"{dev['busy']}, idle {1 - dev['busy']}")
        # the plain ops (backend="jnp") on the same stream
        jnp, j_secs, j_launch, _ = _ooc_solve(x, w, h, dataclasses.replace(c, backend="jnp"))
        check(not any(j_launch.values()), f"{where} jnp: launches {j_launch}")
        j_rel = abs(cost - float(jnp.cost)) / abs(float(jnp.cost))
        check(j_rel <= 1e-5, f"{where}: cost {cost} vs the jnp streamed solve "
              f"{float(jnp.cost)}: rel {j_rel}")
        results["jnp"] = {"its": OOC_ITERS / j_secs, "rel": j_rel}
        print(f"[{card}] {where} backend='jnp': cost {float(jnp.cost)} (rel {j_rel}, limit "
              f"1e-5), {OOC_ITERS / j_secs} it/s")
        del res2, res3, jnp
    out["oocore"] = results


def phase_oocore_cli(card, tmp, out):
    import nmf_tpu_torch as nt

    m, n, k, bn = OOC_CLI
    print(f"[{card}] phase 9c: run --out-of-core --block-n {bn} at {m}x{n}, K={k}, through the CLI")
    rng = np.random.RandomState(0)
    x = np.maximum(rng.rand(m, n).astype(np.float32), np.float32(EPS))
    w, h = rng.rand(m, k).astype(np.float32), rng.rand(k, n).astype(np.float32)
    for name, a in (("X", x), ("W", w), ("H", h)):
        nt.write_matrix(a, os.path.join(tmp, f"ooc_{name}.bin"))
    t0 = time.perf_counter()
    _cli(["run", "ooc_X.bin", "ooc_W.bin", "ooc_H.bin", "-o", "ooc_Wout.bin", "ooc_Hout.bin",
          "--out-of-core", "--block-n", str(bn), "--jsonl", "ooc.jsonl", "-q"], tmp)
    wall = time.perf_counter() - t0
    rec = json.loads(pathlib.Path(tmp, "ooc.jsonl").read_text().splitlines()[-1])
    cfg = nt.reference_preset()
    res, secs, launches, _ = _ooc_solve(nt.BinColumnSource(os.path.join(tmp, "ooc_X.bin")),
                                        w, h, cfg, block_n=bn)
    blocks = n // bn
    check(launches == _launches(update_h=200 * blocks, update_w_numerator=200 * blocks,
                                kl_cost=8 * blocks), f"CLI out-of-core in-process: launches {launches}")
    for f, t in (("W", res.w), ("H", res.h)):
        got = nt.read_matrix(os.path.join(tmp, f"ooc_{f}out.bin"))
        check(got.tobytes() == t.cpu().numpy().tobytes(),
              f"CLI --out-of-core {f} file differs from the in-process solve_out_of_core")
    mem = nt.solve(x, w, h, cfg, device="cuda")
    rel = abs(rec["final_cost"] - float(mem.cost)) / abs(float(mem.cost))
    check(rel <= 1e-5, f"CLI --out-of-core cost {rec['final_cost']} vs in-memory {float(mem.cost)}")
    out["oocore"]["cli"] = {"its": rec["iters_per_sec"], "rel_vs_memory": rel}
    print(f"[{card}] CLI --out-of-core: {rec['iterations']} iterations, final cost "
          f"{rec['final_cost']} (in-memory solve {float(mem.cost)}, rel {rel}, limit 1e-5), "
          f"{rec['iters_per_sec']} it/s, process wall {wall} s; files byte-identical to the "
          f"in-process solve_out_of_core ({200 / secs} it/s, launches {launches})")


def phase_oocore(card, tmp, out, seed):
    phase_numerators(card, out)
    phase_oocore_solves(card, out, seed)
    phase_oocore_cli(card, tmp, out)


# Phase 10: the accelerated loop (accelerate=True) on each solve: the
# reference shape, the flagship, the tile-sparse solve and the streamed one.
ACCEL_ITERS = 200
ACCEL_FLAGSHIP = (10240, 10240, 256, 50)   # M, N, K, iterations (phase 7's)


def _calls(fn, module, names):
    """(fn(), {name: calls}) with ``module``'s functions ``names`` wrapped to
    count their calls: the plain path's step and cost (``backend="jnp"``),
    which no kernel count sees."""
    calls = dict.fromkeys(names, 0)
    originals = {name: getattr(module, name) for name in names}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return call

    for name in names:
        setattr(module, name, counting(name))
    try:
        return fn(), calls
    finally:
        for name, f in originals.items():
            setattr(module, name, f)


def _rejects(steps, costs, res, chunk, where, blocks=1, seeded=True):
    """Rejected check blocks from a solve's step and cost counts, which must
    agree: steps = blocks x (iterations + chunk x rejects), costs = blocks x
    (seed + checks + rejects)."""
    it, checks = int(res.iterations), int(res.num_checks)
    extra = steps - blocks * it
    check(extra >= 0 and extra % (blocks * chunk) == 0,
          f"{where}: {steps} steps for {it} iterations in blocks of {chunk}")
    rejects = extra // (blocks * chunk)
    check(costs == blocks * (int(seeded) + checks + rejects),
          f"{where}: {costs} costs for {checks} checks and {rejects} rejects")
    return rejects


def _timed(fn):
    """(fn(), host seconds) of work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _accel_history(res, where, checks):
    hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
    check(hist.shape == (checks,) and bool(np.all(np.isfinite(hist)))
          and bool(np.all(np.diff(hist) <= 0)),
          f"{where}: history {hist} not {checks} finite non-increasing checks")
    return hist


def _same_bits(a, b, where):
    for f in ("w", "h", "cost_history", "momentum"):
        check(torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f))),
              f"{where}: {f} differs on a rerun")


def _counted_accel(x, w, h, cfg, where, **kw):
    """(result, seconds, launches, rejects) of one accelerated solve through
    K1-K3, the counts set to 0 just before; the launches match the rejects
    and no call took the plain ops."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    fused_mu.reset_counts()
    res, secs = _timed(lambda: nt.solve(x, w, h, cfg, device="cuda", **kw))
    launches = dict(fused_mu.LAUNCHES)
    chunk = cfg.check_every
    seeded = "initial_cost" not in kw
    rejects = _rejects(launches["update_h"], launches["kl_cost"], res, chunk, where,
                       seeded=seeded)
    steps = int(res.iterations) + chunk * rejects
    want = _launches(update_h=steps, update_w=steps,
                     kl_cost=int(seeded) + int(res.num_checks) + rejects)
    check(launches == want and not any(fused_mu.PLAIN_CALLS.values()),
          f"{where}: launches {launches}, plain calls {fused_mu.PLAIN_CALLS}, expected {want}")
    return res, secs, launches, rejects


def _plain_accel(x, w, h, cfg, where, **kw):
    """(result, seconds, rejects) of the same accelerated solve on the plain
    ops (``backend="jnp"``), its rejects read from its step and cost calls."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import solver

    (res, secs), calls = _calls(
        lambda: _timed(lambda: nt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"),
                                        device="cuda", **kw)),
        solver, ("mu_step", "kl_divergence"))
    rejects = _rejects(calls["mu_step"], calls["kl_divergence"], res, cfg.check_every,
                       f"{where} jnp", seeded="initial_cost" not in kw)
    return res, secs, rejects


def phase_accel_reference(card, out):
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.solver import extrapolate

    fx = nt.fixtures
    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    cfg = dataclasses.replace(nt.reference_preset(), accelerate=True)
    plain_cfg = nt.reference_preset()
    checks = ACCEL_ITERS // cfg.check_every
    print(f"[{card}] phase 10a: accelerated reference solve 4096x350, K=128, {ACCEL_ITERS} "
          "iterations, float32, a check every 25")
    for c in (cfg, dataclasses.replace(cfg, backend="jnp"), plain_cfg):   # warm each path
        nt.solve(x, w, h, dataclasses.replace(c, max_iter=2), device="cuda")
    where = "accel reference"
    res, secs, launches, rejects = _counted_accel(x, w, h, cfg, where)
    out["launches"][where] = launches
    hist = _accel_history(res, where, checks)
    _same_bits(res, nt.solve(x, w, h, cfg, device="cuda"), where)
    jres, j_secs, j_rejects = _plain_accel(x, w, h, cfg, where)
    cost, j_cost = float(res.cost), float(jres.cost)
    rel = abs(cost - j_cost) / abs(j_cost)
    check(rel <= 1e-4, f"{where}: cost {cost} vs the jnp accelerated solve {j_cost}: rel {rel}")
    check(j_rejects == rejects, f"{where}: {rejects} rejects, the jnp solve {j_rejects}")
    check(torch.equal(_bits(res.momentum), _bits(jres.momentum)),
          f"{where}: momentum {float(res.momentum)} vs jnp {float(jres.momentum)}")
    pres, p_secs = _timed(lambda: nt.solve(x, w, h, plain_cfg, device="cuda"))
    p_cost = float(pres.cost)
    check(cost <= p_cost, f"{where}: cost {cost} above the plain kernel solve's {p_cost}")
    reach = int(np.argmax(hist <= p_cost)) if bool(np.any(hist <= p_cost)) else None
    reach_its = None if reach is None else (reach + 1) * cfg.check_every
    # it/s in turns: accelerated through K1-K3, accelerated plain, plain
    # through K1-K3, twice
    its = {"accel": [], "accel_jnp": [], "plain": []}
    for _ in range(2):
        for key, c in (("accel", cfg), ("accel_jnp", dataclasses.replace(cfg, backend="jnp")),
                       ("plain", plain_cfg)):
            its[key].append(ACCEL_ITERS / _timed(lambda: nt.solve(x, w, h, c, device="cuda"))[1])
    # the reject path on the card: a baseline below any cost rejects the
    # first block, redone with K1/K2 from its start (no seed cost)
    fres, _, f_launches, f_rejects = _counted_accel(x, w, h, cfg, f"{where} initial_cost=0",
                                                    initial_cost=0.0)
    check(f_rejects >= 1, f"{where} initial_cost=0: no block rejected")
    fj, _, fj_rejects = _plain_accel(x, w, h, cfg, f"{where} initial_cost=0", initial_cost=0.0)
    f_rel = abs(float(fres.cost) - float(fj.cost)) / abs(float(fj.cost))
    check(fj_rejects == f_rejects and f_rel <= 1e-4
          and torch.equal(_bits(fres.momentum), _bits(fj.momentum)),
          f"{where} initial_cost=0: rejects {f_rejects} / jnp {fj_rejects}, rel {f_rel}")
    # the extrapolation's own cost: its elementwise passes on W and H
    m = np.float32(res.momentum.item())
    w_ms = event_ms(lambda: extrapolate(res.w, pres.w, m, EPS))
    h_ms = event_ms(lambda: extrapolate(res.h, pres.h, m, EPS))
    # device busy share of one accelerated and one plain solve
    from torch.profiler import ProfilerActivity, profile

    shares = {}
    for key, c in (("accel", cfg), ("plain", plain_cfg)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, s = _timed(lambda: nt.solve(x, w, h, c, device="cuda"))
        with tempfile.TemporaryDirectory(prefix="nmf_trace_") as d:
            trace = os.path.join(d, "trace.json")
            prof.export_chrome_trace(trace)
            dev = _device_shares(trace)
        shares[key] = {"busy": dev["busy"] / s, "kernels_ms": 1e3 * dev["kernels"], "wall_ms": 1e3 * s}
    out["accel"]["reference"] = {
        "rejects": rejects, "momentum": float(res.momentum), "cost": cost, "jnp_cost": j_cost,
        "plain_cost": p_cost, "reach_plain_cost_its": reach_its, "its": its,
        "extrap_ms": {"w": w_ms, "h": h_ms}, "profile": shares}
    print(f"[{card}] {where}: launches {launches} ({rejects} rejects), cost {cost}, history "
          f"{hist.tolist()}, momentum {float(res.momentum)}, bitwise on rerun; jnp accelerated "
          f"cost {j_cost} (rel {rel}, limit 1e-4, {j_rejects} rejects, momentum bit-equal); plain "
          f"kernel solve cost {p_cost}, reached by the accelerated history at iteration "
          f"{reach_its}; it/s accelerated {its['accel']}, accelerated jnp {its['accel_jnp']}, "
          f"plain kernels {its['plain']} (first timed runs {ACCEL_ITERS / secs}, "
          f"{ACCEL_ITERS / j_secs}, {ACCEL_ITERS / p_secs})")
    print(f"[{card}] {where} initial_cost=0: launches {f_launches} ({f_rejects} reject), "
          f"cost {float(fres.cost)} (jnp {float(fj.cost)}, rel {f_rel}), momentum "
          f"{float(fres.momentum)} bit-equal to jnp's")
    print(f"[{card}] {where}: extrapolation {w_ms} ms on W (4096x128), {h_ms} ms on H (128x350) "
          f"a call (CUDA events); profiled: accelerated busy {shares['accel']['busy']} "
          f"({shares['accel']['kernels_ms']} ms of kernels in {shares['accel']['wall_ms']} ms), "
          f"plain busy {shares['plain']['busy']} ({shares['plain']['kernels_ms']} ms in "
          f"{shares['plain']['wall_ms']} ms)")


def phase_accel_flagship(card, out):
    import nmf_tpu_torch as nt

    m, n, k, iters = ACCEL_FLAGSHIP
    print(f"[{card}] phase 10b: accelerated flagship {m}x{n}, K={k}, {iters} iterations")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((m, n), generator=g, device="cuda")
    w = torch.rand((m, k), generator=g, device="cuda")
    h = torch.rand((k, n), generator=g, device="cuda")
    for dtype, limit in (("bfloat16", 1e-3), ("float32", 1e-4)):
        cfg = nt.SolveConfig(max_iter=iters, check_every=25, precision=nt.Precision(dtype),
                             accelerate=True)
        for backend in ("auto", "jnp"):
            nt.solve(x, w, h, dataclasses.replace(cfg, backend=backend, max_iter=2), device="cuda")
        where = f"accel flagship {dtype}"
        res, secs, launches, rejects = _counted_accel(x, w, h, cfg, where)
        out["launches"][where] = launches
        hist = _accel_history(res, where, iters // 25)
        jres, j_secs, j_rejects = _plain_accel(x, w, h, cfg, where)
        cost, j_cost = float(res.cost), float(jres.cost)
        rel = abs(cost - j_cost) / abs(j_cost)
        check(rel <= limit, f"{where}: cost {cost} vs jnp {j_cost}: rel {rel} (limit {limit})")
        _, secs2 = _timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))
        _, j_secs2 = _timed(lambda: nt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"),
                                             device="cuda"))
        plain = dataclasses.replace(cfg, accelerate=False)
        pres, p_secs = _timed(lambda: nt.solve(x, w, h, plain, device="cuda"))
        its = {"accel": [iters / secs, iters / secs2], "accel_jnp": [iters / j_secs, iters / j_secs2],
               "plain": iters / p_secs}
        out["accel"][f"flagship {dtype}"] = {"rejects": rejects, "jnp_rejects": j_rejects,
                                            "cost": cost, "jnp_cost": j_cost,
                                            "plain_cost": float(pres.cost), "its": its}
        print(f"[{card}] {where}: launches {launches} ({rejects} rejects; jnp {j_rejects}), cost "
              f"{cost} (jnp {j_cost}, rel {rel}, limit {limit}; plain kernel solve "
              f"{float(pres.cost)}), history {hist.tolist()}; it/s accelerated {its['accel']}, "
              f"accelerated jnp {its['accel_jnp']}, plain kernels {its['plain']}")
    del x, w, h
    torch.cuda.empty_cache()


def phase_accel_tiled(card, out):
    import nmf_tpu_torch as nt

    m, n, k, t, occ, seed = TS_MAIN
    x, w, h = tile_problem(m, k, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    print(f"[{card}] phase 10c: accelerated tile-sparse solve {m}x{n}, K={k}, "
          f"{tx.tiles.shape[0]} {t}x{t} tiles, {TS_ITERS} iterations")
    for dtype, limit in (("float32", 1e-4), ("bfloat16", 1e-3)):
        cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, precision=nt.Precision(dtype),
                             accelerate=True)
        for backend in ("auto", "jnp"):
            _ts_solve(tx, w, h, dataclasses.replace(cfg, backend=backend, max_iter=2))
        where = f"accel tiled {dtype}"
        (res, secs), launches, plain_calls, dense = _counted(lambda: _ts_solve(tx, w, h, cfg))
        extra = launches["h_numerator"] - TS_ITERS
        check(extra >= 0 and extra % 25 == 0, f"{where}: K5 launches {launches}")
        rejects = extra // 25
        want = dict.fromkeys(("h_numerator", "w_numerator"), TS_ITERS + 25 * rejects)
        check(launches == want and not any(plain_calls.values()) and not any(dense.values()),
              f"{where}: K5 launches {launches} (expected {want}), plain calls {plain_calls}, "
              f"K1-K3 {dense}")
        out["launches"][where] = launches
        hist = _accel_history(res, where, TS_ITERS // 25)
        res2, secs2 = _ts_solve(tx, w, h, cfg)
        _same_bits(res, res2, where)
        jres, j_secs = _ts_solve(tx, w, h, dataclasses.replace(cfg, backend="jnp"))
        rel = abs(float(res.cost) - float(jres.cost)) / abs(float(jres.cost))
        check(rel <= limit, f"{where}: cost {float(res.cost)} vs the jnp tiled accelerated solve "
              f"{float(jres.cost)}: rel {rel} (limit {limit})")
        out["accel"][f"tiled {dtype}"] = {"rejects": rejects, "cost": float(res.cost),
                                         "its": [TS_ITERS / secs, TS_ITERS / secs2],
                                         "jnp_its": TS_ITERS / j_secs}
        print(f"[{card}] {where}: K5 {launches} ({rejects} rejects), cost {float(res.cost)} "
              f"(jnp {float(jres.cost)}, rel {rel}, limit {limit}), history {hist.tolist()}, "
              f"byte-identical on rerun; {TS_ITERS / secs} and {TS_ITERS / secs2} it/s through "
              f"K5, {TS_ITERS / j_secs} it/s plain sweep")


def phase_accel_oocore(card, out, seed):
    import gc

    import nmf_tpu_torch as nt

    m, n, k = OOC_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    xd = torch.rand((m, n), generator=g, device="cuda").clamp_min_(EPS)
    w = torch.rand((m, k), generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
    h = torch.rand((k, n), generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
    x = xd.cpu().numpy()
    del xd
    blocks = -(-n // nt.pick_block_n(m, n))
    cfg = nt.SolveConfig(max_iter=OOC_ITERS, check_every=OOC_CHECK, accelerate=True)
    print(f"[{card}] phase 10d: accelerated streamed solve {m}x{n}, K={k}, {blocks} blocks, "
          f"{OOC_ITERS} iterations, a check every {OOC_CHECK}")
    for xdt in ("float32", "int8"):
        c = dataclasses.replace(cfg, precision=nt.Precision(x_dtype=xdt))
        mem, mem_secs = _timed(lambda: nt.solve(x, w, h, c, device="cuda"))
        mem_cost, mem_mom = float(mem.cost), float(mem.momentum)
        del mem
        gc.collect()
        torch.cuda.empty_cache()
        where = f"accel oocore {xdt}"
        res, secs, launches, plain_calls = _ooc_solve(x, w, h, c)
        rejects = _rejects(launches["update_h"], launches["kl_cost"], res, OOC_CHECK, where,
                           blocks=blocks)
        steps = blocks * (OOC_ITERS + OOC_CHECK * rejects)
        want = _launches(update_h=steps, update_w_numerator=steps,
                         kl_cost=blocks * (1 + int(res.num_checks) + rejects))
        check(launches == want and not any(plain_calls.values()),
              f"{where}: launches {launches} (expected {want}), plain calls {plain_calls}")
        out["launches"][where] = launches
        hist = _accel_history(res, where, OOC_ITERS // OOC_CHECK)
        cost = float(res.cost)
        rel = abs(cost - mem_cost) / abs(mem_cost)
        check(rel <= 1e-5, f"{where}: cost {cost} vs the in-memory accelerated solve {mem_cost}: "
              f"rel {rel}")
        res2, secs2, _, _ = _ooc_solve(x, w, h, c)
        for f in ("w", "h", "cost_history"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
                  f"{where}: {f} differs on a rerun")
        out["accel"][f"oocore {xdt}"] = {"rejects": rejects, "cost": cost, "rel_vs_memory": rel,
                                        "its": [OOC_ITERS / secs, OOC_ITERS / secs2]}
        print(f"[{card}] {where}: launches {launches} ({rejects} rejects), cost {cost}, history "
              f"{hist.tolist()}, momentum {float(res.momentum)}; in-memory accelerated solve "
              f"cost {mem_cost} (rel {rel}, limit 1e-5; momentum {mem_mom}; {OOC_ITERS / mem_secs} "
              f"it/s incl. its upload); byte-identical on rerun; {OOC_ITERS / secs} and "
              f"{OOC_ITERS / secs2} it/s")
        del res, res2
        gc.collect()
        torch.cuda.empty_cache()


def phase_accel(card, out, seed):
    print(f"[{card}] phase 10: accelerate=True on the reference, flagship, tile-sparse and "
          "streamed solves")
    phase_accel_reference(card, out)
    phase_accel_flagship(card, out)
    phase_accel_tiled(card, out)
    phase_accel_oocore(card, out, seed)


def _accel_launches(launches, name):
    """A kernel's launches on each accelerated solve of phase 10 (the
    streamed ones under K1's and K2's ``numerator_only`` key where it ran)."""
    out = {}
    for run, counts in launches.items():
        if not run.startswith("accel "):
            continue
        for key in (name, f"{name}_numerator"):
            if counts.get(key):
                out[run[6:] + ("" if key == name else " numerator_only")] = counts[key]
    return out


# ---------------------------------------------------------------------------
# Phase 11: the beta, penalized and HALS families (plain ops by rule)

# the reference solve's families: name -> SolveConfig fields
FAMILY_RUNS = {
    "beta2": dict(beta=2.0),
    "beta0": dict(beta=0.0),
    "beta0.5": dict(beta=0.5),
    "beta3": dict(beta=3.0),
    "hals": dict(beta=2.0, algorithm="hals"),
    "kl l1_h=l2_w=0.1": dict(l1_h=0.1, l2_w=0.1),
    "beta2 accelerate": dict(beta=2.0, accelerate=True),
    "hals accelerate": dict(beta=2.0, algorithm="hals", accelerate=True),
}
FAMILY_ITERS = 200
FAMILY_COST_RTOL = 1e-4   # the card's final cost against the same solve on the CPU
DEVICE = "cuda"           # phases 11 and 12 run their solves here


def _all_counts():
    """Every kernel count, K1-K3's and K5's launches and plain calls."""
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    return {**dict(fused_mu.LAUNCHES), **{f"plain {k}": v for k, v in fused_mu.PLAIN_CALLS.items()},
            **{f"K5 {k}": v for k, v in ts.LAUNCHES.items()},
            **{f"K5 plain {k}": v for k, v in ts.PLAIN_CALLS.items()}}


def _reset_all():
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    fused_mu.reset_counts()
    ts.reset_counts()


def _kernel_launches(fn) -> int:
    """Kernels the card ran for ``fn()`` (torch.profiler, CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="nmf_trace_") as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        events = json.loads(pathlib.Path(trace).read_text())["traceEvents"]
    return sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")


def phase_families(card, out):
    """The beta, penalized and HALS families at the reference fixtures:
    plain ops on the card by rule (no K1-K3 or K5 launch), each against the
    same solve on the CPU, a bitwise rerun, it/s; one HALS sweep timed."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops import hals
    from nmf_tpu_torch.ops.mu import matmul

    fx = nt.fixtures
    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    iters = FAMILY_ITERS
    print(f"[{card}] phase 11: the beta, penalized and HALS families, {x.shape[0]}x{x.shape[1]}, "
          f"K={w.shape[1]}, {iters} iterations, float32, plain torch ops on the card by rule")
    results = {}
    for name, fields in FAMILY_RUNS.items():
        cfg = nt.SolveConfig(max_iter=iters, **fields)
        where = f"families {name}"
        nt.solve(x, w, h, dataclasses.replace(cfg, max_iter=2), device=DEVICE)   # warm
        _reset_all()
        res, secs = _timed(lambda: nt.solve(x, w, h, cfg, device=DEVICE))
        counts = _all_counts()
        check(not any(counts.values()), f"{where}: kernel counts {counts}")
        out["launches"][where] = {key: counts[key] for key in _launches()}
        hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
        check(int(res.iterations) == iters and hist.shape == (cfg.num_checks,)
              and bool(np.all(np.isfinite(hist))),
              f"{where}: {int(res.iterations)} iterations, history {hist}")
        monotone = cfg.beta >= 1.0 or cfg.algorithm == "hals" or cfg.accelerate
        if monotone:
            check(bool(np.all(np.diff(hist) <= 0)), f"{where}: history rises: {hist}")
        res2, secs2 = _timed(lambda: nt.solve(x, w, h, cfg, device=DEVICE))
        for f in ("w", "h", "cost_history"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
                  f"{where}: {f} differs on a rerun")
        t0 = time.perf_counter()
        cpu = nt.solve(x, w, h, cfg, device="cpu")
        cpu_secs = time.perf_counter() - t0
        cost, c_cpu = float(res.cost), float(cpu.cost)
        rel = abs(cost - c_cpu) / abs(c_cpu)
        check(rel <= FAMILY_COST_RTOL, f"{where}: cost {cost} vs the CPU solve {c_cpu}: rel {rel} "
              f"(limit {FAMILY_COST_RTOL})")
        results[name] = {"cost": cost, "cpu_cost": c_cpu, "rel": rel, "its": [iters / secs, iters / secs2],
                         "cpu_its": iters / cpu_secs, "monotone_checked": monotone}
        print(f"[{card}] {where}: no kernel launched (K1-K3 and K5 counts all 0), cost {cost}, "
              f"CPU {c_cpu} (rel "
              f"{rel}, limit {FAMILY_COST_RTOL}), history {hist.tolist()}"
              f"{' non-increasing' if monotone else ''}, bitwise on rerun; "
              f"{iters / secs} / {iters / secs2} it/s on the card, {iters / cpu_secs} on the CPU")
    # one HALS sweep of H and of W on the reference operands, and the
    # kernels one HALS iteration launches
    xt, wt, ht = (torch.from_numpy(a).to(DEVICE) for a in (x, w, h))
    eps = nt.SolveConfig().eps
    wtx, wtw = matmul(wt, xt, transpose_a=True), matmul(wt, wt, transpose_a=True)
    xht, hht = matmul(xt, ht, transpose_b=True), matmul(ht, ht, transpose_b=True)
    sweep_h = event_ms(lambda: hals.cd_sweep_h(ht, wtx, wtw, eps), samples=5, calls=5)
    sweep_w = event_ms(lambda: hals.cd_sweep_w(wt, xht, hht, eps), samples=5, calls=5)
    step_ms = event_ms(lambda: hals.hals_step(wt, ht, xt, eps), samples=5, calls=5)
    per_iter = _kernel_launches(lambda: hals.hals_step(wt, ht, xt, eps))
    results["hals_sweep"] = {"h_ms": sweep_h, "w_ms": sweep_w, "step_ms": step_ms,
                             "launches_per_iteration": per_iter}
    out["families"] = results
    print(f"[{card}] families HALS: one sweep of H's {w.shape[1]} rows {sweep_h} ms, of W's "
          f"columns {sweep_w} ms, one iteration {step_ms} ms (CUDA events); {per_iter} kernel "
          f"launches an iteration (torch.profiler): K sequential row updates, launch-bound")


# ---------------------------------------------------------------------------
# Phase 12: the H-only path: solve_h_only, solve_w_only, transform_out_of_core,
# NMF and the CLI's transform (K1 and K3)

TR_SHAPE = (1025, 4000, 32)         # the ISMIR spectrogram (bench.py:54-59): M, N, K
TR_ITERS = 200
TR_OOC_ITERS = 50                   # a block's H-only iterations at the hour of audio
TR_OOC_CLI_BLOCK = 1024


def _tr_policies():
    import nmf_tpu_torch as nt

    return {"float32": nt.Precision(), "bfloat16": nt.Precision("bfloat16"),
            "float32_fast": nt.Precision("float32_fast"),
            "x_bfloat16": nt.Precision(x_dtype="bfloat16"), "x_int8": nt.Precision(x_dtype="int8")}


def _counted_kl(fn, where, want):
    """(fn(), host seconds, K3's Mode) with every count set to 0 just
    before: K1-K3 launched exactly ``want``, no plain call, and every K3
    launch in one Mode, F32 or ANY (the H-only cost's f32 recon), never
    BF16."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    _reset_all()
    (res, secs), counts = kl_counts(lambda: _timed(fn))
    launches = dict(fused_mu.LAUNCHES)
    check(launches == want and not any(fused_mu.PLAIN_CALLS.values()),
          f"{where}: launches {launches}, plain calls {fused_mu.PLAIN_CALLS}, expected {want}")
    mode = _mode_of_counts(counts, f"{where} K3") if want["kl_cost"] else None
    check(mode != "BF16", f"{where}: K3 ran its BF16 instance (the H-only cost is f32)")
    return res, secs, mode, launches


def _tr_problem(seed):
    """X (M x N, on the host), W from a 200-iteration solve, and an H0,
    all made on the card from ``seed``."""
    import nmf_tpu_torch as nt

    m, n, k = TR_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(seed + 12)
    rand = lambda *s: torch.rand(s, generator=g, device=DEVICE).clamp_min_(EPS)  # noqa: E731
    x, w0, h0, h_start = rand(m, n), rand(m, k), rand(k, n), rand(k, n)
    fit = nt.solve(x, w0, h0, nt.reference_preset(), device=DEVICE)
    return (x.cpu().numpy(), fit.w.cpu().numpy(), fit.h.cpu().numpy(), h_start.cpu().numpy(),
            float(fit.cost))


def phase_transform_h_only(card, out, x, w, h_fit, h0):
    import nmf_tpu_torch as nt

    m, n, k = TR_SHAPE
    want = _launches(update_h=TR_ITERS, kl_cost=TR_ITERS // 25)
    print(f"[{card}] phase 12a: solve_h_only and solve_w_only, {TR_ITERS} iterations")
    results = {}
    for pol, prec in _tr_policies().items():
        cfg = nt.SolveConfig(max_iter=TR_ITERS, precision=prec)
        where = f"transform h_only {pol}"
        nt.solve_h_only(x, w, h0, dataclasses.replace(cfg, max_iter=2), device=DEVICE)  # warm
        res, secs, mode, launches = _counted_kl(
            lambda: nt.solve_h_only(x, w, h0, cfg, device=DEVICE), where, want)
        f32_operands = prec.x_dtype == "float32" and prec.state_dtype == "float32"
        check(mode == ("F32" if f32_operands else "ANY"), f"{where}: K3 ran {mode}")
        out["launches"][where] = launches
        hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
        check(hist.shape == (8,) and bool(np.all(np.isfinite(hist))) and bool(np.all(np.diff(hist) <= 0)),
              f"{where}: history {hist}")
        res2, secs2 = _timed(lambda: nt.solve_h_only(x, w, h0, cfg, device=DEVICE))
        for f in ("h", "cost_history"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
                  f"{where}: {f} differs on a rerun")
        plain, p_secs = _timed(lambda: nt.solve_h_only(
            x, w, h0, dataclasses.replace(cfg, backend="jnp"), device=DEVICE))
        cost, c_plain = float(res.cost), float(plain.cost)
        rel = abs(cost - c_plain) / abs(c_plain)
        limit = 1e-3 if prec.matmul_dtype == "bfloat16" else 1e-4
        check(rel <= limit, f"{where}: cost {cost} vs the jnp H-only solve {c_plain}: rel {rel}")
        results[pol] = {"its": [TR_ITERS / secs, TR_ITERS / secs2], "jnp_its": TR_ITERS / p_secs,
                        "cost": cost, "jnp_cost": c_plain, "rel": rel,
                        "k3": kl_instance(mode, k)}
        print(f"[{card}] {where} {m}x{n}, K={k}: launches {launches}, K3 {kl_instance(mode, k)}, "
              f"cost {cost} (jnp {c_plain}, rel {rel}, limit {limit}), bitwise on rerun; "
              f"{TR_ITERS / secs} / {TR_ITERS / secs2} it/s through K1 and K3, "
              f"{TR_ITERS / p_secs} plain")
    # solve_w_only: the H-only solve of the transposed problem
    cfg = nt.SolveConfig(max_iter=TR_ITERS)
    where = "transform w_only float32"
    w_start = np.ascontiguousarray(np.roll(w, 1, axis=0))
    res, secs, mode, launches = _counted_kl(
        lambda: nt.solve_w_only(x, w_start, h_fit, cfg, device=DEVICE), where, want)
    check(mode == "F32", f"{where}: K3 ran {mode}")
    out["launches"][where] = launches
    plain = nt.solve_w_only(x, w_start, h_fit, dataclasses.replace(cfg, backend="jnp"),
                            device=DEVICE)
    rel = abs(float(res.cost) - float(plain.cost)) / abs(float(plain.cost))
    fro = float(torch.linalg.norm(res.w - plain.w) / torch.linalg.norm(plain.w))
    check(tuple(res.w.shape) == (m, k) and tuple(res.h.shape) == (k, n)
          and res.w.is_contiguous(), f"{where}: W {tuple(res.w.shape)}, H {tuple(res.h.shape)}")
    check(rel <= 1e-4 and fro <= 1e-4, f"{where}: cost rel {rel}, W relative Frobenius {fro} "
          "against the jnp W-only solve (limits 1e-4)")
    results["w_only"] = {"its": TR_ITERS / secs, "rel": rel, "w_fro": fro}
    print(f"[{card}] {where}: {TR_ITERS} K1 launches on the transposed problem ({launches}), "
          f"cost {float(res.cost)} (jnp {float(plain.cost)}, rel {rel}), W relative Frobenius "
          f"{fro} (limits 1e-4), {TR_ITERS / secs} it/s")
    out["transform"]["h_only"] = results


def phase_transform_oocore(card, out, seed, w):
    import gc

    import nmf_tpu_torch as nt

    m, n, k = OOC_SHAPE
    check(w.shape == (m, k), f"W {w.shape} for the hour of audio")
    g = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    x = torch.rand((m, n), generator=g, device=DEVICE).clamp_min_(EPS).cpu().numpy()
    h0 = torch.rand((k, n), generator=g, device=DEVICE).clamp_min_(EPS).cpu().numpy()
    bn = nt.pick_block_n(m, n)
    blocks = -(-n // bn)
    checks = TR_OOC_ITERS // 25
    print(f"[{card}] phase 12b: transform_out_of_core {m}x{n}, K={k}: X {x.nbytes / 1e9} GB f32 "
          f"in {blocks} blocks of {bn}, {TR_OOC_ITERS} H-only iterations a block, one stream of X")
    want = _launches(update_h=blocks * TR_OOC_ITERS, kl_cost=blocks * checks)
    rate = h2d_rate(4 * m * bn)
    results = {"h2d_gbps": rate / 1e9}
    for xdt in ("float32", "int8"):
        cfg = nt.SolveConfig(max_iter=TR_OOC_ITERS, precision=nt.Precision(x_dtype=xdt))
        where = f"transform_out_of_core {xdt}"
        t0 = time.perf_counter()
        mem = nt.solve_h_only(x, w, h0, cfg, device=DEVICE)
        mem_h, mem_cost = mem.h.cpu(), float(mem.cost)
        mem_secs = time.perf_counter() - t0
        del mem
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (res, secs, mode, launches), host = _host_timed(lambda: _counted_kl(
            lambda: nt.transform_out_of_core(x, w, h0=h0, config=cfg, device=DEVICE), where, want))
        peak = torch.cuda.max_memory_allocated()
        check(len(host["_fill"]) == blocks, f"{where}: {len(host['_fill'])} block fills")
        fill_s = sum(host["_fill"])
        out["launches"][f"transform out_of_core {xdt}"] = launches
        check(res.blocks == [(j, min(j + bn, n)) for j in range(0, n, bn)]
              and list(res.iterations) == [TR_OOC_ITERS] * blocks and not res.converged.any(),
              f"{where}: blocks {res.blocks}, iterations {res.iterations}")
        check(res.h.shape == (k, n) and bool(np.isfinite(res.h).all()), f"{where}: H not finite")
        summed = float(np.sum(res.block_costs, dtype=np.float64))
        rel = abs(summed - mem_cost) / abs(mem_cost)
        check(rel <= 1e-5 and abs(res.cost - summed) <= 1e-6 * abs(summed),
              f"{where}: block costs sum to {summed} (cost {res.cost}) vs the in-memory "
              f"solve_h_only {mem_cost}: rel {rel} (limit 1e-5)")
        h_rel = _max_rel(torch.from_numpy(res.h), mem_h)
        check(h_rel <= OOC_FACTOR_RTOL, f"{where}: H vs the in-memory solve: max rel {h_rel} "
              f"(limit {OOC_FACTOR_RTOL})")
        check(peak < x.nbytes / 3, f"{where}: peak device memory {peak} B not under a third of "
              f"X ({x.nbytes} B)")
        wire = x.nbytes // (4 if xdt == "int8" else 1)
        roof = wire / rate
        results[xdt] = {"its": TR_OOC_ITERS / secs, "seconds": secs, "fill_share": fill_s / secs,
                        "fill_ms_median": 1e3 * statistics.median(host["_fill"]),
                        "rel": rel, "h_rel": h_rel,
                        "peak_gb": peak / 1e9, "roofline_s": roof, "roofline_fraction": roof / secs,
                        "k3": kl_instance(mode, k), "in_memory_its": TR_OOC_ITERS / mem_secs}
        print(f"[{card}] {where}: launches {launches}, K3 {kl_instance(mode, k)}, cost "
              f"{res.cost}, block costs summed {summed} vs the in-memory solve_h_only {mem_cost} "
              f"(rel {rel}, limit 1e-5), H max rel {h_rel} (limit {OOC_FACTOR_RTOL}); "
              f"{secs} s = {TR_OOC_ITERS / secs} full-width it/s; H2D {rate / 1e9} GB/s "
              f"(pinned), {wire / 1e9} GB on the wire, roofline {roof} s = {roof / secs} of it "
              f"reached; block fills (host clock: gather, cast or quantization into pinned "
              f"memory) {fill_s / secs} of the wall, median "
              f"{1e3 * statistics.median(host['_fill'])} ms a block; peak device memory "
              f"{peak / 1e9} GB; in-memory {TR_OOC_ITERS / mem_secs} it/s incl. its upload")
    out["transform"]["oocore"] = results


def phase_transform_nmf(card, out, x, seed):
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    m, n, k = TR_SHAPE
    where = "transform NMF"
    print(f"[{card}] phase 12c: NMF(n_components={k}, init='nndsvda') fit, transform, "
          "normalize_factors")
    est = nt.NMF(n_components=k, init="nndsvda", device=DEVICE)
    _reset_all()
    _, fit_secs = _timed(lambda: est.fit(x))
    launches = dict(fused_mu.LAUNCHES)
    check(launches == _launches(update_h=200, update_w=200, kl_cost=8),
          f"{where} fit: launches {launches}")
    g = torch.Generator(device=DEVICE).manual_seed(seed + 14)
    x_new = torch.rand((m, 1000), generator=g, device=DEVICE).cpu().numpy()
    h_new, secs, mode, t_launches = _counted_kl(lambda: est.transform(x_new), f"{where}.transform",
                                                _launches(update_h=200, kl_cost=8))
    out["launches"]["transform NMF.transform"] = t_launches
    check(est.w_.shape == (m, k) and h_new.shape == (k, 1000) and bool(np.isfinite(h_new).all())
          and np.isfinite(est.reconstruction_err_) and est.n_iter_ == 200,
          f"{where}: W {est.w_.shape}, H {h_new.shape}, err {est.reconstruction_err_}")
    wn, hn = nt.normalize_factors(est.w_, h_new)
    before = est.w_.astype(np.float64) @ h_new.astype(np.float64)
    after = wn.astype(np.float64) @ hn.astype(np.float64)
    inv = float(np.max(np.abs(after - before) / np.abs(before)))
    check(inv <= 1e-6 and np.allclose(wn.sum(axis=0), 1.0, rtol=1e-5),
          f"{where}: normalize_factors moved W H by {inv} (limit 1e-6)")
    out["transform"]["nmf"] = {"fit_its": 200 / fit_secs, "transform_its": 200 / secs,
                               "reconstruction_err": est.reconstruction_err_, "invariance": inv}
    print(f"[{card}] {where}: fit {m}x{n} K={k} (nndsvda) launches {launches}, "
          f"reconstruction_err_ {est.reconstruction_err_}, {200 / fit_secs} it/s incl. the init; "
          f"transform of {m}x1000 new columns launches {t_launches}, K3 {kl_instance(mode, k)}, "
          f"{200 / secs} it/s; normalize_factors: W H moved by {inv} relative (limit 1e-6)")


def phase_transform_cli(card, tmp, out, x, w):
    """``transform`` (in memory and ``--out-of-core``) and ``run`` with a
    family, as subprocesses, each file byte-equal to the in-process result."""
    import nmf_tpu_torch as nt

    m, n, k = TR_SHAPE
    print(f"[{card}] phase 12d: the CLI's transform and run with a family, as subprocesses")
    nt.write_matrix(x, os.path.join(tmp, "tr_X.bin"))
    nt.write_matrix(w, os.path.join(tmp, "tr_W.bin"))
    xf, wf = (nt.read_matrix(os.path.join(tmp, f"tr_{s}.bin")) for s in "XW")
    _cli(["transform", "tr_X.bin", "tr_W.bin", "-o", "tr_H.bin", "-q"], tmp)
    h0 = np.random.RandomState(0).rand(k, n).astype(np.float32)
    ref = nt.solve_h_only(xf, wf, h0, nt.SolveConfig(), device=DEVICE).h.cpu().numpy()
    check(nt.read_matrix(os.path.join(tmp, "tr_H.bin")).tobytes() == ref.tobytes(),
          "CLI transform: H differs from the in-process solve_h_only")
    bn = TR_OOC_CLI_BLOCK
    _cli(["transform", "tr_X.bin", "tr_W.bin", "-o", "tr_Hooc.bin", "--out-of-core",
          "--block-n", str(bn), "-q"], tmp)
    ref = nt.transform_out_of_core(os.path.join(tmp, "tr_X.bin"), wf, block_n=bn,
                                   device=DEVICE).h
    check(nt.read_matrix(os.path.join(tmp, "tr_Hooc.bin")).tobytes() == ref.tobytes(),
          "CLI transform --out-of-core: H differs from the in-process transform_out_of_core")
    print(f"[{card}] CLI transform {m}x{n} K={k}, in memory and --out-of-core --block-n {bn}: "
          "files byte-equal to the in-process solve_h_only / transform_out_of_core")
    _cli(["gen", "."], tmp)
    xr, wr, hr = (nt.read_matrix(os.path.join(tmp, f"{s}.bin")) for s in "XWH")
    runs = {"beta2": (["--beta", "2"], dict(beta=2.0)),
            "hals": (["--algorithm", "hals", "--beta", "2"], dict(beta=2.0, algorithm="hals")),
            "l1_h": (["--l1-h", "0.1"], dict(l1_h=0.1))}
    cli = {}
    for tag, (flags, fields) in runs.items():
        _cli(["run", "X.bin", "W.bin", "H.bin", "-o", f"W_{tag}.bin", f"H_{tag}.bin", "-q",
              "--jsonl", f"{tag}.jsonl", *flags], tmp)
        res = nt.solve(xr, wr, hr, nt.SolveConfig(**fields), device=DEVICE)
        for f in "WH":
            got = nt.read_matrix(os.path.join(tmp, f"{f}_{tag}.bin"))
            check(got.tobytes() == getattr(res, f.lower()).cpu().numpy().tobytes(),
                  f"CLI run {' '.join(flags)}: {f} differs from the in-process solve")
        rec = json.loads(pathlib.Path(tmp, f"{tag}.jsonl").read_text().splitlines()[-1])
        cli[tag] = {"final_cost": rec["final_cost"], "its": rec["iters_per_sec"]}
        print(f"[{card}] CLI run X.bin W.bin H.bin {' '.join(flags)}: files byte-equal to the "
              f"in-process solve, final cost {rec['final_cost']}, {rec['iters_per_sec']} it/s")
    out["transform"]["cli"] = cli


def phase_transform(card, tmp, out, seed):
    m, n, k = TR_SHAPE
    print(f"[{card}] phase 12: the H-only path at the ISMIR shape {m}x{n}, K={k} (X from "
          f"--seed, W from a 200-iteration solve): solve_h_only, solve_w_only, "
          f"transform_out_of_core, NMF, CLI transform")
    x, w, h_fit, h0, fit_cost = _tr_problem(seed)
    out["transform"]["w_fit_cost"] = fit_cost
    phase_transform_h_only(card, out, x, w, h_fit, h0)
    phase_transform_oocore(card, out, seed, w)
    phase_transform_nmf(card, out, x, seed)
    phase_transform_cli(card, tmp, out, x, w)


def _transform_launches(launches, name):
    """A kernel's launches on each run of phase 12."""
    return {run[10:]: counts[name] for run, counts in launches.items()
            if run.startswith("transform ")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="drive nmf_tpu_torch on one NVIDIA card")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data phases 9, 10 and 12 make on the card (default 0)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card, no result",
              file=sys.stderr)
        return 1
    if not (REPO / "nmf_tpu_torch").is_dir():
        print(f"chip_smoke: no nmf_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    # true f32 GEMMs on the plain path (ROADMAP.md "H100 numerics rules")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_name_and_limit()
    print(f"[{card}] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    out = {
        "kernels": {name: {"max_abs_err": 0.0, "modes": {}, "flagship": {}, "long_walks": {}}
                    for name, _, _ in KERNELS},
        "launches": {}, "cli": {}, "flagship": {}, "tiled": {}, "oocore": {}, "accel": {},
        "families": {}, "transform": {},
    }
    t_start = time.perf_counter()
    phase_card(card, out)  # always: every other phase needs the build
    if "kernels" in phases:
        phase_kernels(card, out)
    if "modes" in phases:
        phase_modes(card, out)
    if "quant" in phases:
        phase_quant(card, out)
    with tempfile.TemporaryDirectory(prefix="nmf_smoke_") as tmp:
        if "cli" in phases:
            phase_cli(card, tmp, out)
        if "inprocess" in phases:
            check("cli" in phases, "phase inprocess needs phase cli (its files)")
            phase_inprocess(card, tmp, out)
    if "flagship" in phases:
        phase_flagship(card, out)
    if "tilesparse" in phases:
        phase_tilesparse(card, out)
    if "oocore" in phases:
        with tempfile.TemporaryDirectory(prefix="nmf_ooc_") as tmp:
            phase_oocore(card, tmp, out, args.seed)
    if "accel" in phases:
        phase_accel(card, out, args.seed)
    if "families" in phases:
        phase_families(card, out)
    if "transform" in phases:
        with tempfile.TemporaryDirectory(prefix="nmf_tr_") as tmp:
            phase_transform(card, tmp, out, args.seed)
    if phases != list(PHASES):
        print(f"[{card}] phases {phases} passed in {time.perf_counter() - t_start} s; "
              "a subset prints no result")
        return 0

    kernels = []
    for name, replaces, source in KERNELS:
        st = out["kernels"][name]
        # each kernel's main path: the f32 reference solve for K1-K3, the
        # f32 tiled solve for K5
        tiled = name.endswith("_numerator")
        main_launches = out["launches"]["tiled float32" if tiled else "float32"]
        # each mode: its kernel-vs-plain numbers, and for K1-K3 the launches
        # of its tier's solve; numerator_only: of the streamed solve of its
        # X dtype (none for the GEMM policies, which no streamed run takes)
        modes = {}
        for mode, ms in st["modes"].items():
            if tiled:
                modes[mode] = ms
            elif "launches_of" in ms:
                run, counter = ms["launches_of"]
                modes[mode] = {**{key: v for key, v in ms.items() if key != "launches_of"},
                               "launches": run and out["launches"][run][counter]}
            else:   # null: a mode no solve of phase 6 runs
                modes[mode] = {**ms, "launches": out["launches"].get(mode, {}).get(name)}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": st["max_abs_err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            "library_ms": None,
            **({"impl": st["impl"]} if "impl" in st else {}),
            **({"instance": st["instance"]} if "instance" in st else {}),
            # K3: its launches on the reference, streamed and flagship solves
            **({"solve_launches": {
                "reference": main_launches[name],
                "streamed": out["launches"]["oocore float32"][name],
                "flagship": out["launches"]["flagship float32"][name]}}
               if name == "kl_cost" else {}),
            # registers, shared memory and blocks an SM of each pass-1 instance
            **({"pass1": {label: v for label, v in out["pass1"].items()
                          if label.startswith(PASS1_OF[name] + "<")}}
               if name in PASS1_OF else {}),
            "modes": modes,
            **({"flagship": st["flagship"]} if st["flagship"] else {}),
            **({"long_walks": st["long_walks"]} if st["long_walks"] else {}),
            "accel_launches": _accel_launches(out["launches"], name),
            # K1-K3: their launches on phase 12's H-only runs (K2: none)
            **({"transform_launches": _transform_launches(out["launches"], name)}
               if name in ("update_h", "update_w", "kl_cost") else {}),
        })
    print(f"[{card}] oocore summary: {json.dumps(out['oocore'])}")
    print(f"[{card}] accel summary: {json.dumps(out['accel'])}")
    print(f"[{card}] families summary: {json.dumps(out['families'])}")
    print(f"[{card}] transform summary: {json.dumps(out['transform'])}")
    print(f"[{card}] all twelve phases passed in {time.perf_counter() - t_start} s "
          f"(kernel build {out['build_seconds']} s)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
