#!/usr/bin/env python3
"""Timing probes beside ``chip_smoke.py``, on one NVIDIA card.

    python3 probe_timings.py sweep-per                 # K5 against its chunk length
    python3 probe_timings.py flagship --root PATH      # K1/K2 of the port under PATH
    python3 probe_timings.py kl --root PATH            # K3 of the port under PATH
    python3 probe_timings.py tiled-mesh                # the tiled loop on a 1x1 mesh
    python3 probe_timings.py sass --root PATH          # K1-K3's R=16 SASS under PATH
    python3 probe_timings.py graph                     # the check-block graphs against eager
    python3 probe_timings.py accel                     # the accelerated loop's graphs
    python3 probe_timings.py batched                   # the batched loop's graphs
    python3 probe_timings.py tiled                     # the tile-sparse loops' graphs
    python3 probe_timings.py stream                    # the streamed transform's and online graphs
    python3 probe_timings.py stop                      # the stop and the accept test on the device

``sweep-per``: K5 (both targets) at ``chip_smoke.TS_MAIN``, the 8192^2
K=128 tile-sparse problem, in float32, bfloat16, float32_fast and with
bf16 tiles, through its C entry with ``per`` = 1, 2, 3, 4 and 6 plan
entries a chunk (the wrapper picks ``per`` by ``tile_sparse.sweep_split``);
each result's largest relative difference to the wrapper's.

``flagship``: K1 and K2 once per GEMM policy at the 10240^2 K=256
flagship (``chip_smoke.py`` phase 7's operands), and under ``float32``
with bf16 X and with int8 X (every Mode of the pass-1 kernels), importing
``nmf_tpu_torch`` and building its kernels from PATH: run it for two trees
in turns (A, B, B, A) in one call to compare them on one card.

``kl``: K3 (``kl_cost_fused``) of the tree under PATH beside
``kl_cost_plain`` and its bound, at the reference shape in each of phase
3's modes (its operands), at the streamed block 1025 x 65408 x 32 in each
mode of the streamed cost pass (phase 9a's operands, f32 recon), and at
the flagship under ``float32``, ``bfloat16`` and ``float32_fast`` (phase
7's operands) and under ``float32`` with bf16 X and with int8 X; run it
for two trees in turns, as ``flagship``.

``tiled-mesh``: the tile-sparse loop at ``chip_smoke.TS_MAIN`` under
``auto`` (K5), 200 iterations, on one device before any process group
exists, then on a 1x1 NCCL mesh and on one device in turns (host seconds
of ``_run_tiled`` on prepared payloads, ending in a synchronize), and one
loop of each under ``torch.profiler``: its device busy seconds, kernel
launches and host-side operator events.

``sass``: the memory instructions of the R = 16 pass-1 instances of K1,
K2 and K3 in the library built from PATH (``cuobjdump -sass``, the
flagship's chunk width), per instance as phase 1 labels it: all
instructions, global (``LDG``/``STG``), generic (``LD``/``ST``), shared
(``LDS``/``STS``) and tensor-core (``HMMA``) ones and the divergence
brackets (``BSSY``).

``graph``: the check-block graphs (``models/solver.py``) against the
eager loop (``solver.eager_loop``), in turns (graphed, eager, eager,
graphed, ...) after a warm run of each; host clocks around work that ends
in a synchronize, each graphed run with its graph counts (warm-ups,
captures, replays, the captures' host seconds).  Three parts, one JSON
line each: (1) ``breakeven``: with every full block after a call's first
replayed (``MIN_REPLAYS`` set to 1), the reference solve (the seed-0
fixtures) and the ISMIR H-only solve (1025 x 4000, K=32) at 2, 3, 4, 5
and 8 blocks of 25 iterations, in it/s, where a graph made for one call
pays; (2) ``routes``, the rule as shipped: the reference solve (200
iterations) in ``float32``, ``bfloat16`` and ``float32_fast``, the ISMIR
H-only and semi (8 frozen columns) solves, the masked reference solve,
``separate``'s solve (the paper's 20 s clip, K=32), in it/s, and a served
stream at ``bench.py``'s serving rows (2048 x 16384, K=128, blocks of
2048, 50 iterations) in cols/s through a warm transform and as the first
call of a fresh one, with one more profiled run of each for the device's
busy share; (3) ``sizes``: with ``GRAPH_MAX_WORK`` lifted, 4096^2 and
8192^2 at K=128 (``float32``), either side of it, and the flagship
(10240^2, K=256) in ``float32`` (cuBLAS by rule) and ``bfloat16``
(K1-K3), 200 iterations, five pairs in turns, with each run's peak
device memory and what stayed allocated and reserved
after it.  No gate: ``chip_smoke.py`` holds the bits.

``accel``: the accelerated reference solve (the seed-0 fixtures, 200
iterations, a check every 25, K1-K3) in ``float32``, ``bfloat16`` and
``float32_fast``: its it/s graphed and on the eager loop in turns (three
pairs, each graphed run with its graph counts: the captures' host
seconds, the redos, the host reads), the plain solve's beside it (graphed
and eager), one profiled run of each for the device's busy share; the
check at which the accelerated history reaches the plain 200-iteration
cost, and the wall to that cost: the accelerated solve stopped there
(graphed and eager) against the plain graphed solve, three rounds in
turns.  One JSON line a policy; no gate (``chip_smoke.py`` holds the bits).

``batched``: the batched loop's graphs (``parallel/batched.py``) against
the eager batched loop (``solver.eager_loop``), in turns (three pairs after
a warm run of each, each graphed run with its graph counts, then one
profiled run of each for the device's busy share), in problem-it/s
(members x iterations over host seconds): ``solve_restarts`` R = 16 at
512 x 1024, K=32, 100 iterations (``chip_smoke.SEL_SHAPE``) on ``auto``
(batched cuBLAS by rule) and on ``pallas``; ``solve_rank_sweep`` at
``chip_smoke.SWEEP_RANKS``, and ``rank_stability``'s sweep at
``STAB_RANKS`` x ``STAB_RESTARTS``, on ``auto``; the masked batch of 16 x
513 x 2000, K=32, 50 iterations, a check every 10 (plain ops member by
member); the accelerated restarts (R = 16, the default momentum, 100
iterations); config 4 (128 x 513 x 2000, K=32, 100 iterations, B x M x N x
K = 4.20e9, just under ``GRAPH_MAX_WORK``) on ``pallas`` (K1/K2) and
``auto`` (batched cuBLAS), and with 160 members (5.25e9, past it) with
the limit lifted.  Each case also at three times its iterations, in turns,
for a step's time alone (the difference over the extra iterations: the
set-up, the first block and the capture taken out).  One JSON line a
case; no gate (``chip_smoke.py`` phase 14 holds the bits).

``tiled``: the tile-sparse loops' graphs (``models/sparse_tiled.py``)
against the eager loop, in turns as ``batched`` (three pairs after a warm
run of each, each graphed run with its graph counts, the captures' host
seconds among them; one profiled run of each for the device's busy share;
the same call at three times its iterations in turns for a step alone):
``chip_smoke.TS_MAIN``'s 8192^2, K=128 solve (320 occupied 128^2 tiles,
200 iterations, a check every 25) on K5 in ``float32``, ``bfloat16`` and
``float32_fast``, with int8 tiles (the plain sweep), and accelerated in
``float32`` and ``bfloat16``, each the loop alone on a payload prepared
once (``_run_tiled``), in it/s; and the tile-sparse batch of
``chip_smoke.TILED_BATCH`` (4 x 4096^2, K=128, 50 iterations, a check
every 10), plain and accelerated, through ``solve_sparse_tiled_batched``
on prepared tiles, in problem-it/s.  One JSON line a case; no gate
(``chip_smoke.py`` phases 8, 10c, 14e and 15 hold the bits).

``stream``: the streamed transform's and the online learner's graphs
(``solver.StreamGraphs``: a graph a stream slot and block width, JAX's
``_h_only_jit`` and ``_online_jit``) against the eager loop, in turns as
``batched`` (three pairs after a warm run of each, each graphed run with
its graph counts, the captures' host seconds among them; one profiled run
of each for the device's busy share), in columns a second:
``transform_out_of_core`` (``chip_smoke.TR_OOC_ITERS`` = 50 H-only
iterations a block, a check every 25, ``auto``) and ``solve_online``
(``chip_smoke.ONLINE_INNER`` = 20 inner iterations, one pass) on the hour
of audio (``chip_smoke.OOC_SHAPE``, 1025 x 619,264, K=32, f32 X made on
the card from seed 0), at its default blocks of 65,408 columns and at
narrow blocks of 2048.  One JSON line a case; no gate (``chip_smoke.py``
phases 12b, 13f and 13g hold the bits).

``stop``: the loops that decide on the device (the stop under ``thresh >
0`` and the accelerated redo under CUDA IF conditional nodes,
``solver._CudaGraphs.when``) against the eager loop, in turns as
``batched`` (three pairs after a warm run of each, each graphed run with
its graph counts: its host reads, blocks skipped after the stop, waits on
a block's event; one profiled run of each for the device's busy share),
and one audit run of each counting every read of the card by the host
(``aten._local_scalar_dense`` on a CUDA tensor, and every blocking copy
from the card to the host: a ``TorchDispatchMode``, untimed): the reference solve
(the seed-0 fixtures, 4096 x 350, K=128, K1-K3) at ``thresh=1e-4``, a check
every 25; the accelerated reference at ``thresh == 0`` (200 iterations) and
at ``thresh=1e-4``; ``chip_smoke.py``'s ``thresh`` batch (8 members of 512 x
1024, K=32, X uniform noise raised to powers 0.5 to 4.0 drawn from seed 0,
``max_iter=1000``, a check every 10, ``thresh=1e-4``, K1-K3); and the
accelerated restarts R = 16 at 512 x 1024, K=32 (``chip_smoke.SEL_SHAPE``,
100 iterations, a check every 25, ``auto``).  Rates in iterations of the
loop a second (a batch: problem-iterations, members x the loop's).  One
JSON line a case; no gate (``chip_smoke.py`` phases 6, 10a and 14 hold the
bits).

Times are ``chip_smoke.event_ms`` (CUDA events, median of 10 samples of 10
calls); every line names the card and its power limit.
"""

import argparse
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
# ``batched``: config 4's members past GRAPH_MAX_WORK (160 x 513 x 2000 x 32)
BATCHED_WIDE_MEMBERS = 160


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_probe", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_per(cs, card):
    import torch

    from nmf_tpu_torch.ops.kernels import _build, fused_mu, tile_sparse as ts
    from nmf_tpu_torch.utils.config import Precision

    lib = _build.load_library()
    m, n, k, t, occ, seed = cs.TS_MAIN
    base = cs._sweep_case(*cs.tile_problem(m, k, n, t, occ, seed), (t, t))
    modes = {"float32": (Precision(), torch.float32),
             "bfloat16": (Precision("bfloat16"), torch.float32),
             "float32_fast": (Precision("float32_fast"), torch.float32),
             "bf16_tiles": (Precision(x_dtype="bfloat16"), torch.bfloat16)}
    for mode, (prec, tile_dtype) in modes.items():
        tiles = base.tiles.to(tile_dtype)
        for target in ("h", "w"):
            plan = base.plans[target]
            steps = plan[0].shape[0]
            wrapper = ts.h_numerator if target == "h" else ts.w_numerator
            ref = wrapper(base.w, base.h, tiles, *plan, cs.EPS, prec)
            fn = lib.nmf_h_sweep if target == "h" else lib.nmf_w_sweep
            for per in (1, 2, 3, 4, 6):
                part = torch.empty((-(-steps // per) + n // t, k, t), device="cuda")
                out = torch.empty_like(ref)

                def call():
                    rc = fn(base.w.data_ptr(), base.h.data_ptr(), tiles.data_ptr(),
                            *(a.data_ptr() for a in plan), part.data_ptr(), out.data_ptr(),
                            m, n, k, t, t, tiles.shape[0], steps, per, fused_mu.chunk_width(k),
                            cs.EPS, 0, ts._X_KIND[tile_dtype], fused_mu._GEMM[prec.matmul_dtype],
                            torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
                    cs.check(rc == 0, f"K5 {mode} {target} per={per}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                rel = float(((out - ref).abs() / ref.abs().clamp_min(1e-30)).max())
                ms = [cs.event_ms(call) for _ in range(2)]
                print(json.dumps({"card": card, "probe": "sweep-per", "mode": mode,
                                  "target": target, "per": per, "ms": ms,
                                  "max_rel_vs_wrapper": rel}), flush=True)


def _flagship_cases(cs):
    """(label, Precision, (w, h, x)) of the 10240^2 K=256 flagship (phase
    7's operands) under each GEMM policy on f32 X, then under ``float32``
    with bf16 X and with int8 X (codes, scales): every Mode of K1-K3."""
    import torch

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.quant import quantize_columns

    g = torch.Generator(device="cuda").manual_seed(0)
    x, w, h = (torch.rand(s, generator=g, device="cuda")
               for s in ((10240, 10240), (10240, 256), (256, 10240)))
    for dtype in ("float32", "bfloat16", "float32_fast"):
        yield dtype, nt.Precision(dtype), (w, h, x)
    yield "x_bfloat16", nt.Precision(x_dtype="bfloat16"), (w, h, x.to(torch.bfloat16))
    yield "x_int8", nt.Precision(x_dtype="int8"), (w, h, quantize_columns(x, cs.EPS))


def flagship(cs, card, root):
    import torch

    import nmf_tpu_torch as nt

    pkg = pathlib.Path(nt.__file__).resolve()
    cs.check(root.resolve() in pkg.parents, f"nmf_tpu_torch came from {pkg}, not from {root}")
    res = {}
    for label, prec, (w, h, x) in _flagship_cases(cs):
        for name, (kern, _) in cs._pairs(prec).items():
            if name != "kl_cost":
                res[f"{name} {label}"] = cs.event_ms(lambda: kern(w, h, x))
    print(json.dumps({"card": card, "probe": "flagship", "root": str(root), "ms": res}), flush=True)


def kl(cs, card, root):
    import dataclasses

    import torch

    import nmf_tpu_torch as nt

    pkg = pathlib.Path(nt.__file__).resolve()
    cs.check(root.resolve() in pkg.parents, f"nmf_tpu_torch came from {pkg}, not from {root}")
    res = {}

    def time_cost(label, prec, w, h, x):
        kern, plain = cs._pairs(prec)["kl_cost"]
        b_ms, b_by = cs._mu_bound("kl_cost", w, h, x, prec)
        res[label] = {"ms": cs.event_ms(lambda: kern(w, h, x)),
                      "plain_ms": cs.event_ms(lambda: plain(w, h, x)),
                      "bound_ms": b_ms, "bound_by": b_by}

    m, n, k = cs.SHAPES[0]
    time_cost("reference float32", nt.Precision(), *cs._operands(m, n, k))
    for mode, spec in cs._modes().items():
        time_cost(f"reference {mode}", spec.prec, *cs._mode_operands(m, n, k, mode, spec))
    m, n, k = cs.OOC_SHAPE[0], cs.OOC_BLOCK, cs.OOC_SHAPE[2]
    for mode, spec in cs._num_modes().items():
        if mode in cs.OOC_COST_MODES:
            time_cost(f"streamed {mode}", dataclasses.replace(spec.prec, matmul_dtype="float32"),
                      *cs._num_operands(m, n, k, mode, spec))
    torch.cuda.empty_cache()
    for label, prec, (w, h, x) in _flagship_cases(cs):
        time_cost(f"flagship {label}", prec, w, h, x)
    print(json.dumps({"card": card, "probe": "kl", "root": str(root), "ms": res}), flush=True)


def tiled_mesh(cs, card):
    import dataclasses
    import tempfile

    import torch

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import sparse_tiled as st
    from nmf_tpu_torch.parallel.mesh import shutdown

    m, n, k, t, occ, seed = cs.TS_MAIN
    x, w, h = cs.tile_problem(m, k, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    cfg = nt.SolveConfig(max_iter=200, check_every=25)

    def prepared(mesh):
        dev = None if mesh is not None else torch.device("cuda")
        prep = st._prepare_tiled(tx, w, h, cfg, st._CHUNK, (t, t), dev, mesh=mesh)
        st._run_tiled(*prep[:3], dataclasses.replace(cfg, max_iter=2), prep[3])   # warm
        return prep

    def loop_s(prep):
        return cs._timed(lambda: st._run_tiled(*prep[:3], cfg, prep[3]))[1]

    def profiled(prep, d):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop_s(prep)
        path = f"{d}/trace.json"
        prof.export_chrome_trace(path)
        events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
        return {"busy_s": cs._device_shares(path)["busy"],
                "kernels": sum(e.get("cat") == "kernel" for e in events),
                "cpu_ops": sum(e.get("cat") == "cpu_op" for e in events)}

    single = prepared(None)
    res = {"single, no group": [loop_s(single) for _ in range(3)], "mesh": [], "single": []}
    mesh = nt.make_mesh((1, 1), device="cuda")
    meshed = prepared(mesh)
    for i in range(4):
        for tag in (("mesh", "single") if i % 2 == 0 else ("single", "mesh")):
            res[tag].append(loop_s(meshed if tag == "mesh" else single))
    with tempfile.TemporaryDirectory(prefix="nmf_probe_") as d:
        prof = {tag: profiled(prep, d) for tag, prep in (("mesh", meshed), ("single", single))}
    shutdown()
    print(json.dumps({"card": card, "probe": "tiled-mesh", "iterations": cfg.max_iter,
                      "loop_s": res, "profile": prof}), flush=True)


def _run(cs, fn, eager):
    """(host seconds of fn, the graph counts it left), on the eager loop
    where ``eager``."""
    from nmf_tpu_torch.models import solver

    solver.reset_graph_counts()
    if eager:
        with solver.eager_loop():
            secs = cs._timed(fn)[1]
    else:
        secs = cs._timed(fn)[1]
    return secs, {**solver.GRAPH_COUNTS, **solver.ACCEL_COUNTS}


def _busy(cs, fn, eager, tmp):
    """The device's busy share of one run of fn (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        secs = _run(cs, fn, eager)[0]
    trace = f"{tmp}/trace.json"
    prof.export_chrome_trace(trace)
    return cs._device_shares(trace)["busy"] / secs


def _turns(cs, tmp, fn, work, pairs=2, shares=True, warm=True, memory=False):
    """Graphed and eager in turns (GE EG GE ...), after a warm run of
    each: the rate each run reached (work / host seconds) and, graphed,
    its graph counts (the capture's host seconds among them); with
    ``shares`` one more profiled run of each for its busy share; with
    ``memory`` each run's peak device memory over what was allocated
    before it, and what stayed allocated and reserved after it."""
    import torch

    if warm:
        _run(cs, fn, False)
        _run(cs, fn, True)
    rec = {tag: {"per_s": []} for tag in ("graphed", "eager")}
    rec["graphed"]["counts"] = []
    for i in range(pairs):
        for eager in ((False, True) if i % 2 == 0 else (True, False)):
            r = rec["eager" if eager else "graphed"]
            if memory:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            secs, counts = _run(cs, fn, eager)
            r["per_s"].append(work / secs)
            if not eager:
                r["counts"].append(counts)
            if memory:
                for key, v in (("peak_gb", torch.cuda.max_memory_allocated() - base),
                               ("allocated_after_gb", torch.cuda.memory_allocated() - base),
                               ("reserved_after_gb", torch.cuda.memory_reserved())):
                    r.setdefault(key, []).append(v / 1e9)
    if shares:
        for tag, r in rec.items():
            r["busy"] = _busy(cs, fn, tag == "eager", tmp)
    return rec


def graph(cs, card):
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import separation, solver

    fx = nt.fixtures
    xr, wr, hr = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    m, n, k = cs.TR_SHAPE
    g = torch.Generator(device="cuda").manual_seed(12)
    rand = lambda *s: torch.rand(s, generator=g, device="cuda").clamp_min_(cs.EPS)  # noqa: E731
    xi, wi, hi = (t.cpu().numpy() for t in (rand(m, n), rand(m, k), rand(k, n)))
    mask = (np.random.RandomState(16).rand(*xr.shape) >= cs.MASK_MISSING).astype(np.float32)
    xn = xr.copy()
    xn[mask == 0] = np.nan
    audio = cs._paper_audio(0)
    mag = np.abs(separation._stft_np(audio, cs.PAPER_FFT, cs.PAPER_HOP)).astype(np.float32)
    ws, hs = nt.scaled_random_init(mag, cs.PAPER_K, seed=0)
    sm, sn, sk, nb = cs.SERVE_SHAPE
    rng = np.random.RandomState(0)
    xs = np.maximum(rng.rand(sm, sn).astype(np.float32), np.float32(cs.EPS))
    wsv = np.maximum(rng.rand(sm, sk).astype(np.float32), np.float32(cs.EPS))
    tmp = tempfile.TemporaryDirectory(prefix="nmf_probe_")
    path = f"{tmp.name}/serve.nmfz"
    nt.save_transform(path, wsv, nb, nt.SolveConfig(max_iter=cs.SERVE_ITERS,
                                                    check_every=cs.SERVE_ITERS))
    ref = nt.reference_preset()
    rule = solver.MIN_REPLAYS

    # (1) where a graph made for one call pays: every full block after the
    # first replayed (MIN_REPLAYS set to 1 here), calls of 2 to 8 blocks
    breakeven = {}
    solver.MIN_REPLAYS = 1
    try:
        for blocks in (2, 3, 4, 5, 8):
            c = dataclasses.replace(ref, max_iter=25 * blocks)
            hc = nt.SolveConfig(max_iter=25 * blocks)
            for name, fn in ((f"reference float32 {blocks} blocks",
                              lambda c=c: nt.solve(xr, wr, hr, c, device="cuda")),
                             (f"ismir h_only {blocks} blocks",
                              lambda hc=hc: nt.solve_h_only(xi, wi, hi, hc, device="cuda"))):
                breakeven[name] = _turns(cs, tmp.name, fn, 25 * blocks, shares=False)
    finally:
        solver.MIN_REPLAYS = rule
    print(json.dumps({"card": card, "probe": "graph", "part": "breakeven", "min_replays": rule,
                      "rates": breakeven}), flush=True)

    # (2) each route as a user calls it (the rule as shipped): every solve
    # makes its graph in the call; a served stream through a warm transform,
    # and the first call of a fresh one
    cases = {f"reference {tier}": (200, lambda c=dataclasses.replace(
        ref, precision=nt.Precision(tier)): nt.solve(xr, wr, hr, c, device="cuda"))
        for tier in ("float32", "bfloat16", "float32_fast")}
    cases["ismir h_only"] = (200, lambda: nt.solve_h_only(
        xi, wi, hi, nt.SolveConfig(max_iter=200), device="cuda"))
    cases["ismir semi"] = (200, lambda: nt.solve_semi(
        xi, wi, hi, nt.SolveConfig(max_iter=200), n_frozen=cs.SEMI_FROZEN, device="cuda"))
    cases["reference masked"] = (200, lambda: nt.solve_masked(
        xn, wr, hr, mask, nt.SolveConfig(max_iter=200), device="cuda"))
    cases["separate solve"] = (200, lambda: nt.solve(
        mag, ws, hs, nt.SolveConfig(max_iter=200, thresh=0.0, check_every=25), device="cuda"))
    served = nt.load_transform(path)
    cases["serve"] = (sn, lambda: served(xs))     # a rate in columns/s
    rates = {name: _turns(cs, tmp.name, fn, work) for name, (work, fn) in cases.items()}
    # a fresh transform's first call, its load (the same both ways) included
    rates["serve fresh transform"] = _turns(cs, tmp.name, lambda: nt.load_transform(path)(xs),
                                            sn, shares=False)
    print(json.dumps({"card": card, "probe": "graph", "part": "routes", "rates": rates}),
          flush=True)

    # (3) where the device sets the pace: graphed (GRAPH_MAX_WORK lifted)
    # against eager, 200 iterations, five pairs in turns, with memory:
    # 4096^2 and 8192^2 at K=128 (float32), below and above GRAPH_MAX_WORK,
    # and the flagship (10240^2, K=256) in float32 (cuBLAS by rule) and
    # bfloat16 (K1-K3)
    fm, fn_, fk, _ = cs.ACCEL_FLAGSHIP
    sizes = {"4096^2 K=128 float32": (4096, 4096, 128, "float32"),
             "8192^2 K=128 float32": (8192, 8192, 128, "float32"),
             "flagship float32": (fm, fn_, fk, "float32"),
             "flagship bfloat16": (fm, fn_, fk, "bfloat16")}
    flagship = {}
    limit = solver.GRAPH_MAX_WORK
    for name, (sm_, sn_, sk_, tier) in sizes.items():
        gf = torch.Generator(device="cuda").manual_seed(0)
        xf, wf, hf = (torch.rand(s, generator=gf, device="cuda")
                      for s in ((sm_, sn_), (sm_, sk_), (sk_, sn_)))
        cfg = nt.SolveConfig(max_iter=200, check_every=25, precision=nt.Precision(tier))
        solver.GRAPH_MAX_WORK = float("inf")
        try:
            flagship[name] = _turns(cs, tmp.name,
                                    lambda c=cfg: nt.solve(xf, wf, hf, c, device="cuda"), 200,
                                    pairs=5, shares=False, memory=True)
        finally:
            solver.GRAPH_MAX_WORK = limit
        flagship[name]["work"] = sm_ * sn_ * sk_
        del xf, wf, hf
    tmp.cleanup()
    print(json.dumps({"card": card, "probe": "graph", "part": "sizes",
                      "graph_max_work": limit, "rates": flagship}), flush=True)


def accel(cs, card):
    import dataclasses
    import tempfile

    import numpy as np

    import nmf_tpu_torch as nt

    fx = nt.fixtures
    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    ref = dataclasses.replace(nt.reference_preset(), backend="pallas")
    iters = ref.max_iter
    tmp = tempfile.TemporaryDirectory(prefix="nmf_probe_")
    for tier in ("float32", "bfloat16", "float32_fast"):
        plain = dataclasses.replace(ref, precision=nt.Precision(tier))
        acc = dataclasses.replace(plain, accelerate=True)
        solve = lambda c: nt.solve(x, w, h, c, device="cuda")  # noqa: E731
        # where the accelerated history passes the plain 200-iteration cost
        p_cost = float(solve(plain).cost)
        res = solve(acc)
        hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
        reach = int(np.argmax(hist <= p_cost)) if bool(np.any(hist <= p_cost)) else None
        reach_its = None if reach is None else (reach + 1) * acc.check_every
        rec = {"plain_cost": p_cost, "accel_cost": float(res.cost),
               "reach_plain_cost_its": reach_its,
               "accel": _turns(cs, tmp.name, lambda: solve(acc), iters, pairs=3),
               "plain": _turns(cs, tmp.name, lambda: solve(plain), iters, pairs=3)}
        if reach_its is not None:
            # the wall to the plain 200-iteration cost: the accelerated
            # solve stopped at that check, against the plain solve, in turns
            to = dataclasses.replace(acc, max_iter=reach_its)
            walls = {"accel_graphed": [], "accel_eager": [], "plain_graphed": []}
            _run(cs, lambda: solve(to), False)
            for i in range(3):
                order = (("accel_graphed", to, False), ("accel_eager", to, True),
                         ("plain_graphed", plain, False))
                for key, c, eager in (order if i % 2 == 0 else order[::-1]):
                    walls[key].append(_run(cs, lambda c=c: solve(c), eager)[0])
            rec["wall_to_plain_cost_s"] = walls
        print(json.dumps({"card": card, "probe": "accel", "tier": tier, **rec}), flush=True)
    tmp.cleanup()


def _step_ms(cs, call, cfg, rounds=3):
    """A step alone, graphed and on the eager loop: ``call(c)`` at the
    config's depth and at three times it, in turns; ``(t(3n) - t(n)) / 2n``
    in ms, the set-up, the first block and the capture taken out.  Returns
    (ms by loop, the seconds at each depth)."""
    import dataclasses

    import numpy as np

    its = cfg.max_iter
    deep = dataclasses.replace(cfg, max_iter=3 * its)
    secs = {tag: {its: [], 3 * its: []} for tag in ("graphed", "eager")}
    for i in range(rounds):
        for eager in ((False, True) if i % 2 == 0 else (True, False)):
            for c in (cfg, deep):
                secs["eager" if eager else "graphed"][c.max_iter].append(
                    _run(cs, lambda c=c: call(c), eager)[0])
    step = {tag: (float(np.median(v[3 * its])) - float(np.median(v[its]))) / (2 * its) * 1e3
            for tag, v in secs.items()}
    return step, secs


def batched(cs, card):
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import solver

    x = cs._sel_problem(0)
    m, n, k = cs.SEL_SHAPE
    r, iters = cs.SEL_RESTARTS, cs.SEL_ITERS
    auto = nt.SolveConfig(max_iter=iters, check_every=25)
    rng = np.random.RandomState(15)
    bm, mm, mn, mk = cs.MASKED_MEMBERS, cs.BATCH_SHAPE[1], cs.BATCH_SHAPE[2], cs.BATCH_SHAPE[3]
    xm = np.maximum(rng.rand(bm, mm, mn).astype(np.float32), np.float32(cs.EPS))
    wm, hm = rng.rand(bm, mm, mk).astype(np.float32), rng.rand(bm, mk, mn).astype(np.float32)
    masks = (rng.rand(bm, mm, mn) >= cs.MASK_MISSING).astype(np.float32)
    mcfg = nt.SolveConfig(max_iter=cs.PLAIN_ITERS, check_every=cs.MASKED_CHECK)
    b4, m4, n4, k4 = cs.BATCH_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    big = BATCHED_WIDE_MEMBERS
    x4, w4, h4 = (torch.rand(s, generator=g, device="cuda").clamp_min_(cs.EPS)
                  for s in ((big, m4, n4), (big, m4, k4), (big, k4, n4)))
    c4 = nt.SolveConfig(max_iter=cs.BATCH_ITERS, check_every=25, track_cost=False)
    stab_ranks = [rk for rk in cs.STAB_RANKS for _ in range(cs.STAB_RESTARTS)]
    restarts = lambda c: nt.solve_restarts(  # noqa: E731
        x, rank=k, n_restarts=r, config=c, seed=0, device="cuda")
    # name -> (members, its config, the call of a config)
    cases = {
        "restarts auto": (r, auto, restarts),
        "restarts pallas": (r, dataclasses.replace(auto, backend="pallas"), restarts),
        "sweep auto": (len(cs.SWEEP_RANKS), auto, lambda c: nt.solve_rank_sweep(
            x, cs.SWEEP_RANKS, c, seed=0, device="cuda")),
        "stability sweep auto": (len(stab_ranks), auto, lambda c: nt.solve_rank_sweep(
            x, stab_ranks, c, seed=0, device="cuda")),
        "masked": (bm, mcfg, lambda c: nt.solve_batched(xm, wm, hm, c, mask=masks,
                                                        device="cuda")),
        "accelerated restarts auto": (r, dataclasses.replace(auto, accelerate=True), restarts),
        "config 4 pallas": (b4, dataclasses.replace(c4, backend="pallas"),
                            lambda c: nt.solve_batched(x4[:b4], w4[:b4], h4[:b4], c,
                                                       device="cuda")),
        "config 4 auto": (b4, c4, lambda c: nt.solve_batched(x4[:b4], w4[:b4], h4[:b4], c,
                                                             device="cuda")),
        # past GRAPH_MAX_WORK (B x M x N x K 5.25e9), the limit lifted
        f"config 4 x {big} members pallas, limit lifted": (
            big, dataclasses.replace(c4, backend="pallas"),
            lambda c: nt.solve_batched(x4, w4, h4, c, device="cuda")),
        f"config 4 x {big} members auto, limit lifted": (
            big, c4, lambda c: nt.solve_batched(x4, w4, h4, c, device="cuda")),
    }
    tmp = tempfile.TemporaryDirectory(prefix="nmf_probe_")
    limit = solver.GRAPH_MAX_WORK
    for name, (members, cfg, call) in cases.items():
        if "lifted" in name:
            solver.GRAPH_MAX_WORK = float("inf")
        try:
            rec = _turns(cs, tmp.name, lambda: call(cfg), members * cfg.max_iter, pairs=3)
            step, secs = _step_ms(cs, call, cfg)
        finally:
            solver.GRAPH_MAX_WORK = limit
        med = {tag: float(np.median(v["per_s"])) for tag, v in rec.items()}
        work = members * cfg.max_iter
        print(json.dumps({"card": card, "probe": "batched", "case": name, "members": members,
                          "problem_iters": work, "graphed_over_eager":
                          med["graphed"] / med["eager"], "step_ms": step,
                          "step_eager_over_graphed": step["eager"] / step["graphed"],
                          "secs_at_depths": secs, **rec}), flush=True)
    tmp.cleanup()


def tiled(cs, card):
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import solver
    from nmf_tpu_torch.models import sparse_tiled as st

    m, n, k, t, occ, seed = cs.TS_MAIN
    x, w, h = cs.tile_problem(m, k, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    base = nt.SolveConfig(max_iter=cs.TS_ITERS, check_every=25, backend="pallas")
    tb, tm, tn, tk, tile, tocc = cs.TILED_BATCH
    probs = [cs.tile_problem(tm, tk, tn, tile, tocc, seed=i) for i in range(tb)]
    txs = [nt.tiles_from_dense(p[0], (tile, tile)) for p in probs]
    ws, hs = np.stack([p[1] for p in probs]), np.stack([p[2] for p in probs])
    bcfg = nt.SolveConfig(max_iter=cs.PLAIN_ITERS, check_every=cs.MASKED_CHECK)

    def two_d(cfg):
        prep = st._prepare_tiled(tx, w, h, cfg, st._CHUNK, (t, t), torch.device("cuda"))
        return 1, cfg, lambda c: st._run_tiled(*prep[:3], c, prep[3]), prep[3]["work"]

    def batch(cfg):
        call = lambda c: nt.solve_sparse_tiled_batched(  # noqa: E731
            txs, ws, hs, c, device="cuda")
        t_max = -(-max(a.tiles.shape[0] for a in txs) // st._CHUNK) * st._CHUNK
        return tb, cfg, call, tb * t_max * tile * tile * tk

    cases = {
        "float32": lambda: two_d(base),
        "bfloat16": lambda: two_d(dataclasses.replace(base, precision=nt.Precision("bfloat16"))),
        "float32_fast": lambda: two_d(dataclasses.replace(
            base, precision=nt.Precision("float32_fast"))),
        "int8 tiles": lambda: two_d(dataclasses.replace(
            base, backend="auto", precision=nt.Precision(x_dtype="int8"))),
        "accelerated float32": lambda: two_d(dataclasses.replace(base, accelerate=True)),
        "accelerated bfloat16": lambda: two_d(dataclasses.replace(
            base, accelerate=True, precision=nt.Precision("bfloat16"))),
        "batch": lambda: batch(bcfg),
        "batch accelerated": lambda: batch(dataclasses.replace(bcfg, accelerate=True)),
    }
    tmp = tempfile.TemporaryDirectory(prefix="nmf_probe_")
    for name, make in cases.items():
        members, cfg, call, work = make()
        rec = _turns(cs, tmp.name, lambda: call(cfg), members * cfg.max_iter, pairs=3)
        step, secs = _step_ms(cs, call, cfg)
        med = {tag: float(np.median(v["per_s"])) for tag, v in rec.items()}
        print(json.dumps({"card": card, "probe": "tiled", "case": name, "members": members,
                          "tiles": int(tx.tiles.shape[0]) if members == 1 else None,
                          "step_work": work, "graph_max_work": solver.GRAPH_MAX_WORK,
                          "graphed_over_eager": med["graphed"] / med["eager"],
                          "step_ms": step, "step_eager_over_graphed": step["eager"] / step["graphed"],
                          "secs_at_depths": secs, **rec}), flush=True)
    tmp.cleanup()


def stream(cs, card):
    import tempfile

    import numpy as np
    import torch

    import nmf_tpu_torch as nt

    m, n, k = cs.OOC_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    x, w = (torch.rand(s, generator=g, device="cuda").clamp_min_(cs.EPS).cpu().numpy()
            for s in ((m, n), (m, k)))
    cfg = nt.SolveConfig(max_iter=cs.TR_OOC_ITERS)
    tmp = tempfile.TemporaryDirectory(prefix="nmf_probe_")
    for bn in (cs.OOC_BLOCK, 2048):
        cases = {
            "transform": lambda: nt.transform_out_of_core(x, w, config=cfg, block_n=bn,
                                                          device="cuda"),
            "online": lambda: nt.solve_online(x, w, nt.SolveConfig(), block_n=bn,
                                              inner_iters=cs.ONLINE_INNER, device="cuda"),
        }
        for name, fn in cases.items():
            rec = _turns(cs, tmp.name, fn, n, pairs=3)
            med = {tag: float(np.median(v["per_s"])) for tag, v in rec.items()
                   if tag in ("graphed", "eager")}
            print(json.dumps({"card": card, "probe": "stream", "case": name, "m": m, "n": n,
                              "k": k, "block_n": bn, "blocks": -(-n // bn),
                              "unit": "columns a second",
                              "graphed_over_eager": med["graphed"] / med["eager"], **rec}),
                  flush=True)
    tmp.cleanup()


class _ReadAudit:
    """Counts the host's reads of the card inside it: a scalar read of a
    CUDA tensor, and every blocking copy of one to the host."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        import torch

        audit = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                src = args[0] if args and isinstance(args[0], torch.Tensor) else None
                if src is not None and src.is_cuda:
                    if func is torch.ops.aten._local_scalar_dense.default:
                        audit.reads += 1
                    elif func is torch.ops.aten._to_copy.default and \
                            torch.device(kwargs.get("device") or src.device).type == "cpu":
                        audit.reads += 1
                elif func is torch.ops.aten.copy_.default and args[0].device.type == "cpu" \
                        and args[1].is_cuda and not (args[2:] or [kwargs.get("non_blocking")])[0]:
                    audit.reads += 1         # a blocking copy (the pace's pinned copies are not)
                return func(*args, **kwargs)

        self.reads, self.mode = 0, _Mode()

    def count(self, fn) -> int:
        self.reads = 0
        with self.mode:
            fn()
        return self.reads


def stop(cs, card):
    import dataclasses
    import tempfile

    import numpy as np

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import solver

    fx = nt.fixtures
    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    ref = dataclasses.replace(nt.reference_preset(), backend="pallas")
    sm, sn, sk = cs.SEL_SHAPE
    rng = np.random.RandomState(0)
    powers = np.linspace(0.5, 4.0, cs.STOP_MEMBERS)
    xs = np.stack([np.maximum(rng.rand(sm, sn).astype(np.float32) ** np.float32(pw),
                              np.float32(cs.EPS)) for pw in powers])
    ws = rng.rand(cs.STOP_MEMBERS, sm, sk).astype(np.float32)
    hs = rng.rand(cs.STOP_MEMBERS, sk, sn).astype(np.float32)
    xr = cs._sel_problem(0)
    restarts = nt.SolveConfig(max_iter=cs.SEL_ITERS, check_every=25, accelerate=True)
    # name -> (members, the call)
    cases = {
        "reference thresh": (1, lambda: nt.solve(x, w, h, dataclasses.replace(
            ref, max_iter=5000, thresh=1e-4), device="cuda")),
        "accelerated thresh 0": (1, lambda: nt.solve(x, w, h, dataclasses.replace(
            ref, accelerate=True), device="cuda")),
        "accelerated thresh": (1, lambda: nt.solve(x, w, h, dataclasses.replace(
            ref, max_iter=5000, thresh=1e-4, accelerate=True), device="cuda")),
        "thresh batch": (cs.STOP_MEMBERS, lambda: nt.solve_batched(xs, ws, hs, nt.SolveConfig(
            max_iter=1000, check_every=10, thresh=cs.STOP_THRESH, backend="pallas"),
            device="cuda")),
        "accelerated restarts": (cs.SEL_RESTARTS, lambda: nt.solve_restarts(
            xr, rank=sk, n_restarts=cs.SEL_RESTARTS, config=restarts, seed=0,
            device="cuda").results),
    }
    audit = _ReadAudit()
    tmp = tempfile.TemporaryDirectory(prefix="nmf_probe_")
    for name, (members, fn) in cases.items():
        res = fn()
        its = int(res.iterations.max())
        reads = {"graphed": audit.count(fn)}
        with solver.eager_loop():
            reads["eager"] = audit.count(fn)
        rec = _turns(cs, tmp.name, fn, members * its, pairs=3)
        med = {tag: float(np.median(v["per_s"])) for tag, v in rec.items()}
        print(json.dumps({"card": card, "probe": "stop", "case": name, "members": members,
                          "iterations": res.iterations.tolist(),
                          "checks": res.num_checks.tolist(), "host_reads": reads,
                          "graphed_over_eager": med["graphed"] / med["eager"], **rec}),
              flush=True)
    tmp.cleanup()


def sass(cs, card, root):
    import collections
    import re
    import subprocess

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import _build

    pkg = pathlib.Path(nt.__file__).resolve()
    cs.check(root.resolve() in pkg.parents, f"nmf_tpu_torch came from {pkg}, not from {root}")
    _build.load_library()
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    kinds = ("LDG", "STG", "LD", "ST", "LDS", "STS", "HMMA", "BSSY")
    res, label = {}, None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            label = cs._kernel_label(fn.group(1))
            if not re.match(r"(h_update_partial|w_update_partial|kl_partial)<R=16,", label):
                label = None
            elif label not in res:
                res[label] = collections.Counter()
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if label and op:
            res[label]["all"] += 1
            if op.group(1) in kinds:
                res[label][op.group(1)] += 1
    print(json.dumps({"card": card, "probe": "sass", "root": str(root),
                      "instructions": {k: dict(v) for k, v in sorted(res.items())}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("sweep-per", "flagship", "kl", "tiled-mesh", "sass",
                                      "graph", "accel", "batched", "tiled", "stream", "stop"))
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="tree whose nmf_tpu_torch to time (default: this one)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_timings: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs = _smoke()
    card = cs.card_name_and_limit()
    if args.probe == "sweep-per":
        sweep_per(cs, card)
    elif args.probe == "flagship":
        flagship(cs, card, args.root)
    elif args.probe == "tiled-mesh":
        tiled_mesh(cs, card)
    elif args.probe == "sass":
        sass(cs, card, args.root)
    elif args.probe == "graph":
        graph(cs, card)
    elif args.probe == "accel":
        accel(cs, card)
    elif args.probe == "batched":
        batched(cs, card)
    elif args.probe == "tiled":
        tiled(cs, card)
    elif args.probe == "stream":
        stream(cs, card)
    elif args.probe == "stop":
        stop(cs, card)
    else:
        kl(cs, card, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
