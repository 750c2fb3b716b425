#!/usr/bin/env python3
"""Drive the PyTorch port (``nmf_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Five phases, in order; any failure raises and the exit code is non-zero:

1. the card: assert CUDA, read the card's name and power limit, build the
   kernels from ``nmf_tpu_torch/csrc/`` (build seconds printed);
2. kernels: K1-K3 against their plain torch versions on the card at the
   reference, ISMIR and paper shapes (factors rtol 1e-4 / atol 1e-6, cost
   rel 1e-5), bitwise-equal on a second call, each timed beside its plain
   version with CUDA events (median of 10 samples of 10 back-to-back calls,
   in turns plain, kernel, kernel, plain); then checked only at K = 8, 64,
   300 and 2048 (every K chunk width, several chunks), and K > 2048 shown to
   take the plain ops by the rank rule;
3. the reference pipeline through the CLI, as subprocesses: ``gen`` then
   ``run X.bin W.bin H.bin -o Wout.bin Hout.bin --jsonl run.jsonl``;
   200 iterations, 8 strictly decreasing checks, final cost within 1e-4
   of 96689.73, ``Wout.bin`` of 8 + 4096*128*4 bytes;
4. the same pipeline in-process through ``solve``: exactly 200/200/8
   launches of K1/K2/K3, and byte-identical factors on a second run and
   against the CLI's output files;
5. the flagship size 10240 x 10240, K=256, f32, 50 iterations, through the
   kernels and through plain torch ops (cuBLAS f32): final costs agree to
   1e-4 relative; iterations/s and TFLOP/s for both.

Every number printed carries the card's name and power limit.  The line
before the last is the card as ``nvidia-smi`` names it, the one before that
a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
PIN_COST = 96689.73               # tests/test_parity.py:144
SHAPES = [(4096, 350, 128), (1025, 4000, 32), (513, 3445, 30)]   # (M, N, K)
# correctness only: K chunk widths 16 and 64, two chunks, the K=2048 ceiling
COVERAGE_SHAPES = [(100, 70, 8), (333, 333, 64), (257, 129, 300), (300, 200, 2048)]
RTOL, ATOL, COST_RTOL = 1e-4, 1e-6, 1e-5
SAMPLES, CALLS = 10, 10
KERNELS = [
    # name, TPU kernel it replaces
    ("update_h", "nmf_tpu/ops/pallas/fused_mu.py:245"),
    ("update_w", "nmf_tpu/ops/pallas/fused_mu.py:378"),
    ("kl_cost", "nmf_tpu/ops/pallas/fused_mu.py:516"),
]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


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


def phase_card(card):
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
        for line in log.read_text().splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print(f"[{card}]   {line.strip()}")


def _operands(m, n, k):
    rng = np.random.RandomState(m + n + k)
    eps = np.float32(2.2204e-16)
    return tuple(
        torch.from_numpy(np.maximum(rng.rand(*s).astype(np.float32), eps)).cuda()
        for s in ((m, k), (k, n), (m, n))
    )


def _check_kernel(name, kern, plain, w, h, x):
    """Kernel vs plain on the same tensors, and a bitwise rerun; returns
    (max abs error, description)."""
    m, k = w.shape
    n = h.shape[1]
    out1 = kern(w, h, x)
    torch.cuda.synchronize()
    out2 = kern(w, h, x)
    torch.cuda.synchronize()
    ref = plain(w, h, x)
    torch.cuda.synchronize()
    check(torch.equal(out1.view(torch.int32), out2.view(torch.int32)),
          f"{name} {m}x{n}x{k}: second call not bitwise identical")
    check(bool(torch.isfinite(out1).all()), f"{name} {m}x{n}x{k}: non-finite output")
    err = (out1 - ref).abs()
    max_err = float(err.max())
    if name == "kl_cost":
        rel = max_err / abs(float(ref))
        ok, what = rel <= COST_RTOL, f"rel err {rel} (limit {COST_RTOL})"
    else:
        worst = float((err - RTOL * ref.abs()).max())
        ok = worst <= ATOL
        what = f"max abs err {max_err}, worst excess over rtol {worst} (atol {ATOL})"
    check(ok, f"{name} {m}x{n}x{k}: {what}")
    return max_err, what


def phase_kernels(card):
    print(f"[{card}] phase 2: kernels vs plain torch on the card")
    from nmf_tpu_torch.ops import divergence, mu
    from nmf_tpu_torch.ops.kernels import fused_mu

    pairs = {
        "update_h": (fused_mu.update_h_fused, mu.update_h),
        "update_w": (fused_mu.update_w_fused, mu.update_w),
        "kl_cost": (lambda w, h, x: fused_mu.kl_cost_fused(x, w, h),
                    lambda w, h, x: divergence.kl_divergence(x, w, h)),
    }
    stats = {name: {"max_abs_err": 0.0} for name in pairs}
    for si, (m, n, k) in enumerate(SHAPES):
        w, h, x = _operands(m, n, k)
        for name, (kern, plain) in pairs.items():
            max_err, what = _check_kernel(name, kern, plain, w, h, x)
            # plain, kernel, kernel, plain: compare within one call, in turns
            p1 = event_ms(lambda: plain(w, h, x))
            k1 = event_ms(lambda: kern(w, h, x))
            k2 = event_ms(lambda: kern(w, h, x))
            p2 = event_ms(lambda: plain(w, h, x))
            kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
            print(f"[{card}] {name:8s} {m}x{n}x{k}: kernel {kms} ms, plain {pms} ms, "
                  f"{what}, bitwise-repeatable")
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], max_err)
            if si == 0:  # the main path's shape
                st["ms"], st["plain_ms"] = kms, pms
    # every K chunk width and several chunks, up to the rank ceiling
    for m, n, k in COVERAGE_SHAPES:
        w, h, x = _operands(m, n, k)
        for name, (kern, plain) in pairs.items():
            max_err, what = _check_kernel(name, kern, plain, w, h, x)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], max_err)
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
    return stats


def phase_cli(card, tmp):
    print(f"[{card}] phase 3: reference pipeline through the CLI")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    cli = [sys.executable, "-m", "nmf_tpu_torch"]
    subprocess.run(cli + ["gen", "."], check=True, cwd=tmp, env=env)
    t0 = time.perf_counter()
    subprocess.run(
        cli + ["run", "X.bin", "W.bin", "H.bin", "-o", "Wout.bin", "Hout.bin",
               "--jsonl", "run.jsonl"],
        check=True, cwd=tmp, env=env,
    )
    wall = time.perf_counter() - t0
    rec = json.loads(pathlib.Path(tmp, "run.jsonl").read_text().splitlines()[-1])
    costs = [c["cost"] for c in rec["checks"]]
    check(rec["iterations"] == 200, f"CLI ran {rec['iterations']} iterations")
    check(len(costs) == 8, f"CLI made {len(costs)} checks")
    check(all(b < a for a, b in zip(costs, costs[1:])), f"CLI costs not decreasing: {costs}")
    rel = abs(rec["final_cost"] - PIN_COST) / PIN_COST
    check(rel <= 1e-4, f"CLI final cost {rec['final_cost']} vs {PIN_COST}: rel {rel}")
    size = pathlib.Path(tmp, "Wout.bin").stat().st_size
    check(size == 8 + 4096 * 128 * 4, f"Wout.bin is {size} bytes")
    print(f"[{card}] CLI run: 200 iterations, final cost {rec['final_cost']} "
          f"(rel {rel} to the pin), solve {rec['seconds']} s = {rec['iters_per_sec']} it/s, "
          f"process wall {wall} s")


def phase_inprocess(card, tmp):
    print(f"[{card}] phase 4: reference pipeline in-process through solve")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    x, w, h = (nt.read_matrix(os.path.join(tmp, f"{s}.bin")) for s in "XWH")
    cfg = nt.reference_preset()
    fused_mu.reset_counts()
    t0 = time.perf_counter()
    res = nt.solve(x, w, h, cfg, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain_calls = dict(fused_mu.LAUNCHES), dict(fused_mu.PLAIN_CALLS)
    check(launches == {"update_h": 200, "update_w": 200, "kl_cost": 8},
          f"launches {launches}")
    check(not any(plain_calls.values()), f"plain calls on the card {plain_calls}")
    hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
    check(int(res.iterations) == 200 and hist.shape == (8,), "200 iterations / 8 checks")
    check(bool(np.all(np.diff(hist) < 0)), f"costs not decreasing: {hist}")
    cost = float(res.cost)
    check(abs(cost - PIN_COST) / PIN_COST <= 1e-4, f"final cost {cost} vs {PIN_COST}")
    w1, h1 = res.w.cpu().numpy(), res.h.cpu().numpy()
    res2 = nt.solve(x, w, h, cfg, device="cuda")
    check(w1.tobytes() == res2.w.cpu().numpy().tobytes(), "W differs on a rerun")
    check(h1.tobytes() == res2.h.cpu().numpy().tobytes(), "H differs on a rerun")
    wout = nt.read_matrix(os.path.join(tmp, "Wout.bin"))
    hout = nt.read_matrix(os.path.join(tmp, "Hout.bin"))
    check(wout.tobytes() == w1.tobytes() and hout.tobytes() == h1.tobytes(),
          "CLI output files differ from the in-process factors")
    print(f"[{card}] solve: {launches} launches, cost {cost}, history {hist.tolist()}, "
          f"{secs} s (first in-process solve), byte-identical on rerun and vs the CLI files")
    return launches


def phase_flagship(card):
    print(f"[{card}] phase 5: flagship 10240x10240, K=256, f32, 50 iterations")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.utils.metrics import flops_per_iter

    m = n = 10240
    k = 256
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((m, n), generator=g, device="cuda")
    w = torch.rand((m, k), generator=g, device="cuda")
    h = torch.rand((k, n), generator=g, device="cuda")
    base = nt.SolveConfig(max_iter=50, check_every=25)
    results = {}
    for backend in ("auto", "jnp"):   # warm each path once (allocator, cuBLAS)
        nt.solve(x, w, h, dataclasses.replace(base, backend=backend, max_iter=1), device="cuda")
    torch.cuda.synchronize()
    for backend in ("auto", "jnp", "jnp", "auto"):
        t0 = time.perf_counter()
        res = nt.solve(x, w, h, dataclasses.replace(base, backend=backend), device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cost = float(res.cost)
        check(np.isfinite(cost) and int(res.iterations) == 50, f"{backend}: cost {cost}")
        results.setdefault(backend, []).append((secs, cost))
    c_k, c_p = results["auto"][0][1], results["jnp"][0][1]
    rel = abs(c_k - c_p) / abs(c_p)
    check(rel <= 1e-4, f"flagship cost kernel {c_k} vs plain {c_p}: rel {rel}")
    for backend, label in (("auto", "kernels"), ("jnp", "plain (cuBLAS f32)")):
        for secs, cost in results[backend]:
            ips = 50 / secs
            tf = flops_per_iter(m, k, n) * ips / 1e12
            print(f"[{card}] flagship {label}: {secs} s for 50 iterations + 2 costs, "
                  f"{ips} it/s, {tf} TFLOP/s, final cost {cost}")
    print(f"[{card}] flagship costs agree: rel {rel} (limit 1e-4)")


def main() -> int:
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

    phase_card(card)
    stats = phase_kernels(card)
    with tempfile.TemporaryDirectory(prefix="nmf_smoke_") as tmp:
        phase_cli(card, tmp)
        launches = phase_inprocess(card, tmp)
    phase_flagship(card)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": "nmf_tpu_torch/csrc/fused_mu.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"],
        }
        for name, replaces in KERNELS
    ]
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
