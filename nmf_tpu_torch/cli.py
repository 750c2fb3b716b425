"""Command-line interface of the PyTorch port (``run``, ``transform``,
``separate``, ``gen``, ``info``).

    python -m nmf_tpu_torch run X.bin W.bin H.bin -o Wout.bin Hout.bin   # on the card
    python -m nmf_tpu_torch run X.bin --rank 32 --device cpu   # NNDSVDa init
    python -m nmf_tpu_torch run X.bin W.bin H.bin --accelerate       # Nesterov loop
    python -m nmf_tpu_torch run X.bin W.bin H.bin --strict-compat    # padded-EPS replay
    python -m nmf_tpu_torch run X.bin W.bin H.bin --out-of-core --block-n 4096  # X streamed
    python -m nmf_tpu_torch run X.bin W.bin H.bin --beta 2 --algorithm hals     # HALS
    python -m nmf_tpu_torch run X.bin W.bin H.bin --mask M.bin   # observed entries only
    python -m nmf_tpu_torch run X.bin W.bin H.bin --freeze 8     # first 8 columns of W fixed
    python -m nmf_tpu_torch run X.bin --rank 32 --init random --online   # one-pass learner
    python -m nmf_tpu_torch transform X.bin W.bin -o H.bin       # H against a fixed W
    python -m nmf_tpu_torch transform X.bin W.bin -o H.bin --out-of-core --block-n 4096
    python -m nmf_tpu_torch separate song.wav --rank 32 --out-dir sources   # the paper's pipeline
    python -m nmf_tpu_torch gen ./fixtures        # seed-0 reference fixtures
    python -m nmf_tpu_torch info fixtures/X.bin   # header/stats of .bin files

The flags mirror ``python -m nmf_tpu``.  Every other flag of the JAX CLI's
``run`` and ``transform`` is parsed with the JAX CLI's default, and runs as
the JAX CLI runs it when it spells out that default; any other value is
refused with exit code 2, naming the ROADMAP.md item that will bring it: a
flag is never silently ignored.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .io import binio, fixtures
from .models import init as init_mod
from .models.masked import solve_masked, solve_masked_h_only
from .models.nmf import solve_h_only
from .models.online import solve_online
from .models.semi import solve_semi
from .models.separation import separate
from .models.solver import solve
from .models.streaming import (
    BinColumnSource,
    solve_out_of_core,
    transform_out_of_core,
    wire_itemsize,
)
from .models.strict import solve_strict
from .utils.config import Precision, SolveConfig
from .utils.device import resolve_device
from .utils.metrics import MetricsLogger

# JAX-CLI flags not in the port yet: flag -> (argparse kwargs with the JAX
# CLI's default, nmf_tpu/cli.py:42-114, 1188-1227; where the work is queued
# in ROADMAP.md).  A flag that spells out its default runs as the JAX CLI
# runs it; any other value is refused.  _SOLVER_LATER is common to run and
# transform (the JAX CLI's _add_solver_flags), _RUN_LATER is run's own.
_SOLVER_LATER = {
    "--live": ({"action": "store_true"}, "Queue 1 step 9, item 13: utils (live metrics)"),
    "--validate": ({"action": "store_true"}, "Queue 1 step 9, item 13: utils (guards)"),
    "--mesh": ({}, "Queue 1 step 12, item 12: sharded solves"),
    "--checkpoint-dir": ({}, "Queue 1 item 13: utils (checkpoint)"),
    "--checkpoint-every": ({"type": int, "default": 100}, "Queue 1 item 13: utils (checkpoint)"),
}
_RUN_LATER = {
    "--restarts": ({"type": int, "default": 1},
                   "Queue 1 step 7, item 9: selection and batched solves"),
}
_AUTOTUNE = "Queue 1 step 11 (item 7): the H100 backend rules and autotune"


def _default(kw: dict):
    return kw.get("default", False if kw.get("action") == "store_true" else None)


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def _refused(args, later: dict) -> list:
    refused = [
        f"{flag} (ROADMAP.md {where})"
        for flag, (kw, where) in later.items()
        if getattr(args, _dest(flag)) != _default(kw)
    ]
    if args.backend == "autotune":
        refused.append(f"--backend autotune (ROADMAP.md {_AUTOTUNE})")
    return refused


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _config(args) -> SolveConfig:
    return SolveConfig(
        max_iter=args.max_iter, thresh=args.thresh, check_every=args.check_every,
        precision=Precision(
            matmul_dtype=args.dtype, x_dtype=args.x_dtype, x_quant_rows=args.x_quant_rows
        ),
        backend=args.backend, track_cost=not args.no_cost, accelerate=args.accelerate,
        beta=args.beta, algorithm=args.algorithm,
        l1_w=args.l1_w, l1_h=args.l1_h, l2_w=args.l2_w, l2_h=args.l2_h,
    )


def _write_factors(res, args) -> tuple:
    w_out, h_out = (t.cpu().float().numpy() for t in (res.w, res.h))
    w_path, h_path = args.output
    binio.write_matrix(w_out, w_path)
    binio.write_matrix(h_out, h_path)
    return w_out, h_out


_LONE_INIT = ("provide BOTH initial W and H files, or neither plus --rank (a lone "
              "init file would otherwise be silently ignored)")


def _cmd_run_online(args, dev) -> int:
    """run with --online: one-pass dictionary learning, then an out-of-core
    transform for H, X streamed from its .bin (``nmf_tpu/cli.py:211-290``)."""
    if args.strict_compat or args.checkpoint_dir or args.mask or args.freeze:
        return _error("--online composes with --mesh only (no --strict-compat "
                      "/ --checkpoint-dir / --mask / --freeze)")
    if not (0.0 < args.online_rho <= 1.0):
        return _error(f"--online-rho must be in (0, 1], got {args.online_rho}")
    if args.online_passes < 1 or args.online_inner_iters < 1:
        return _error("--online-passes and --online-inner-iters must be >= 1")
    if args.rank and args.init != "random" and not (args.W or args.H):
        return _error("--online streams X (global statistics for "
                      f"--init {args.init} are unavailable); use --init random or "
                      "provide a W init file")
    source = BinColumnSource(args.X)
    if args.W or args.H:
        if not args.W or args.H:
            return _error("--online takes an optional W init only (H is "
                          "produced by the post-pass transform)")
        w0 = binio.read_matrix(args.W)
    elif args.rank:
        w0, _ = init_mod.random_init(source.shape[0], args.rank, 1, seed=args.seed)
    else:
        return _error("provide a W init or --rank")
    config = _config(args)
    logger = MetricsLogger(verbose=not args.quiet, jsonl_path=args.jsonl)
    with logger.timed() as t:
        res = solve_online(args.X, w0, config, block_n=args.block_n,
                           inner_iters=args.online_inner_iters, rho=args.online_rho,
                           passes=args.online_passes, seed=args.seed, device=dev)
        tr = transform_out_of_core(args.X, res.w, config=config, block_n=args.block_n,
                                   seed=args.seed, device=dev)
    logger.report_raw({
        "mode": "online",
        "shape": list(source.shape),
        "rank": int(res.w.shape[1]),
        "passes": res.passes,
        "blocks": len(res.blocks),
        "pass_cost_sums": [round(sum(p), 6) for p in res.block_costs],
        "transform_cost": float(tr.cost),
        "seconds": t.seconds,
    })
    w_path, h_path = args.output
    binio.write_matrix(res.w, w_path)
    binio.write_matrix(tr.h, h_path)
    if not args.quiet:
        print(f"[nmf] online: wrote {w_path}, {h_path}", file=sys.stderr)
    return 0


def _cmd_run_out_of_core(args, dev) -> int:
    """run with --out-of-core: X (and a --mask) streamed from its .bin in
    column blocks, never loaded whole (``nmf_tpu/cli.py:293-368``)."""
    source = BinColumnSource(args.X)
    m, n = source.shape
    if bool(args.W) != bool(args.H):
        return _error(_LONE_INIT)
    if args.W and args.H:
        w0 = binio.read_matrix(args.W)
        h0 = binio.read_matrix(args.H)
    elif args.rank:
        if args.init != "random":
            return _error("--out-of-core init must be 'random' or explicit W/H "
                          "files (other inits read all of X)")
        w0, h0 = init_mod.random_init(m, args.rank, n, seed=args.seed)
    else:
        return _error("provide W and H files, or --rank")
    config = _config(args)
    mask = BinColumnSource(args.mask) if args.mask else None
    logger = MetricsLogger(verbose=not args.quiet, jsonl_path=args.jsonl)
    with logger.timed() as t:
        res = solve_out_of_core(source, w0, h0, config, block_n=args.block_n, mask=mask,
                                n_frozen=args.freeze, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # time the run, not its enqueue
    logger.report(res, (m, n), t.seconds, check_every=config.check_every)
    _write_factors(res, args)
    if not args.quiet:
        gb = m * n * wire_itemsize(config.precision.x_dtype) / 1e9
        w_path, h_path = args.output
        print(
            f"[nmf] out-of-core: streamed {m}x{n} X "
            f"({gb:.2f} GB as {config.precision.x_dtype}) per iteration; "
            f"wrote {w_path}, {h_path}",
            file=sys.stderr,
        )
    return 0


def cmd_run(args) -> int:
    if args.out_of_core and args.strict_compat:
        return _error("--strict-compat (padded-EPS replication) requires the "
                      "in-memory solver; drop --out-of-core")
    refused = _refused(args, {**_SOLVER_LATER, **_RUN_LATER})
    if refused:
        return _error("not in the PyTorch port yet: " + "; ".join(refused))
    if args.online and args.out_of_core:
        return _error("pick one streaming mode — --out-of-core (full alternating "
                      "solve, one X stream per iteration) or --online (one-pass "
                      "dictionary learning)")
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    if args.online:
        return _cmd_run_online(args, dev)
    if args.out_of_core:
        return _cmd_run_out_of_core(args, dev)
    x = binio.read_matrix(args.X)
    if bool(args.W) != bool(args.H):
        return _error(_LONE_INIT)
    if args.W and args.H:
        w0 = binio.read_matrix(args.W)
        h0 = binio.read_matrix(args.H)
    elif args.rank:
        m, n = x.shape
        if args.init == "random":
            w0, h0 = init_mod.random_init(m, args.rank, n, seed=args.seed)
        elif args.init == "scaled":
            w0, h0 = init_mod.scaled_random_init(x, args.rank, seed=args.seed)
        else:
            w0, h0 = init_mod.nndsvd_init(x, args.rank, variant=args.init, seed=args.seed)
    else:
        return _error("provide W and H files, or --rank for generated init")

    config = _config(args)
    logger = MetricsLogger(verbose=not args.quiet, jsonl_path=args.jsonl)
    mask = None
    if args.mask:
        mask = binio.read_matrix(args.mask)
        if mask.shape != x.shape:
            return _error(f"mask shape {mask.shape} != X shape {x.shape}")
        if args.strict_compat:
            return _error("--mask runs the masked solver (no --strict-compat / "
                          "--checkpoint-dir; use --out-of-core for resumable masked runs)")
    if args.freeze and args.strict_compat:
        return _error("--freeze composes with the plain / --mesh / --out-of-core solvers only")
    if mask is not None and args.freeze:
        return _error("--freeze is not implemented for masked solves")
    with logger.timed() as t:
        if mask is not None:
            res = solve_masked(x, w0, h0, mask, config, device=dev)
        elif args.freeze:
            res = solve_semi(x, w0, h0, config, n_frozen=args.freeze, device=dev)
        else:
            # a ValueError of solve_strict (--accelerate, --beta, --algorithm
            # hals, penalties: strict mode replays one algorithm) exits 2
            # through main() with its message
            res = (solve_strict if args.strict_compat else solve)(x, w0, h0, config, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # time the run, not its enqueue
    logger.report(res, x.shape, t.seconds, check_every=config.check_every)
    w_out, h_out = _write_factors(res, args)
    if not args.quiet:
        w_path, h_path = args.output
        print(f"[nmf] wrote {w_path} {w_out.shape}, {h_path} {h_out.shape}", file=sys.stderr)
    return 0


def cmd_transform(args) -> int:
    """H-only inference: H for X against a fixed W (``nmf_tpu/cli.py:618-698``);
    with --mask only the observed entries drive the fit, in memory
    (``solve_masked_h_only``) or streamed beside X (the JAX CLI refuses
    ``--mask --out-of-core``; its library streams the mask)."""
    if args.checkpoint_dir:
        return _error("transform does not checkpoint (each streamed block is "
                      "solved in one visit; re-running re-does only unfinished work)")
    if args.strict_compat:
        return _error("--strict-compat is a full-solve replication mode (use 'run')")
    later = {flag: v for flag, v in _SOLVER_LATER.items() if flag != "--checkpoint-every"}
    refused = _refused(args, later)
    if refused:
        return _error("not in the PyTorch port yet: " + "; ".join(refused))
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    config = _config(args)
    w = binio.read_matrix(args.W)
    h0 = binio.read_matrix(args.h0) if args.h0 else None
    logger = MetricsLogger(verbose=not args.quiet, jsonl_path=args.jsonl)
    if args.out_of_core:
        mask = BinColumnSource(args.mask) if args.mask else None
        with logger.timed() as t:
            res = transform_out_of_core(args.X, w, h0=h0, config=config, block_n=args.block_n,
                                        seed=args.seed, mask=mask, device=dev)
        h_out = res.h
        if not args.quiet:
            print(
                f"[nmf] transform (out-of-core): {len(res.blocks)} blocks, "
                f"iters/block min {res.iterations.min()} max "
                f"{res.iterations.max()}, cost {res.cost:.6g}, {t.seconds:.2f}s",
                file=sys.stderr,
            )
    else:
        x = binio.read_matrix(args.X)
        if h0 is None:   # the bytes the JAX CLI starts from
            h0 = np.random.RandomState(args.seed).rand(w.shape[1], x.shape[1]).astype(np.float32)
        with logger.timed() as t:
            if args.mask:
                res = solve_masked_h_only(x, w, h0, binio.read_matrix(args.mask), config,
                                          device=dev)
            else:
                res = solve_h_only(x, w, h0, config, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # time the run, not its enqueue
        logger.report(res, x.shape, t.seconds, check_every=config.check_every)
        h_out = res.h.cpu().float().numpy()
    binio.write_matrix(h_out, args.output)
    if not args.quiet:
        print(f"[nmf] wrote {args.output} {h_out.shape}", file=sys.stderr)
    return 0


def _read_wav(path):
    """(rate, mono f32 audio) of a WAV file, scaled and downmixed as the JAX
    CLI does: signed integers over their max, 8-bit unsigned about 128."""
    from scipy.io import wavfile

    sr, audio = wavfile.read(path)
    if audio.dtype.kind == "i":
        audio = audio.astype(np.float32) / np.iinfo(audio.dtype).max
    elif audio.dtype.kind == "u":  # 8-bit WAV is unsigned with a 128 offset
        info = np.iinfo(audio.dtype)
        audio = (audio.astype(np.float32) - (info.max + 1) / 2) / ((info.max + 1) / 2)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)  # downmix to mono
    return sr, audio.astype(np.float32)


def write_sources(sources: np.ndarray, rate: int, out_dir: str) -> list:
    """``source_%03d.wav`` for each source, peak-normalized to int16 over
    all of them (``nmf_tpu/cli.py:860-864``); returns the paths."""
    from scipy.io import wavfile

    os.makedirs(out_dir, exist_ok=True)
    peak = max(float(np.abs(sources).max()), 1e-9)
    paths = []
    for k_i, src in enumerate(sources):
        path = os.path.join(out_dir, f"source_{k_i:03d}.wav")
        wavfile.write(path, rate, (src / peak * 32767).astype(np.int16))
        paths.append(path)
    return paths


def cmd_separate(args) -> int:
    """The paper's application: separate a WAV into spectral sources
    (``nmf_tpu/cli.py:795-870``)."""
    for flag, name in ((args.checkpoint_dir, "--checkpoint-dir"),
                       (args.out_of_core, "--out-of-core"),
                       (args.strict_compat, "--strict-compat"),
                       (args.mesh, "--mesh"),
                       (args.block_n, "--block-n")):
        if flag:
            return _error(f"{name} does not apply to 'separate' (it runs an "
                          "in-memory spectrogram factorization; factorize the "
                          "spectrogram .bin with 'run' for those modes)")
    later = {flag: v for flag, v in _SOLVER_LATER.items()
             if flag not in ("--checkpoint-dir", "--checkpoint-every", "--mesh")}
    refused = _refused(args, later)
    if refused:
        return _error("not in the PyTorch port yet: " + "; ".join(refused))
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    sr, audio = _read_wav(args.audio)
    config = _config(args)
    logger = MetricsLogger(verbose=not args.quiet, jsonl_path=args.jsonl)
    with logger.timed() as t:
        res = separate(audio, n_components=args.rank, n_fft=args.n_fft, hop=args.hop,
                       config=config, seed=args.seed, n_restarts=args.restarts, device=dev)
    if args.jsonl:
        logger.report_raw({
            "kind": "separate",
            "audio": args.audio,
            "rank": int(args.rank),
            "n_fft": int(args.n_fft),
            "hop": int(args.hop),
            "restarts": int(args.restarts),
            "iterations": int(res.solve_result.iterations),
            "cost": float(res.solve_result.cost),
            "seconds": t.seconds,
        })
    write_sources(res.sources, sr, args.out_dir)
    if not args.quiet:
        print(
            f"[nmf] separated {args.audio} into {args.rank} sources in "
            f"{args.out_dir} ({int(res.solve_result.iterations)} iters, "
            f"cost {float(res.solve_result.cost):.4e}, {t.seconds:.2f}s)",
            file=sys.stderr,
        )
    return 0


def cmd_gen(args) -> int:
    for path in fixtures.write_reference_fixtures(args.directory).values():
        print(f"wrote {path}")
    return 0


def cmd_info(args) -> int:
    for path in args.files:
        a = binio.read_matrix(path)
        print(
            f"{path}: {a.shape[0]}x{a.shape[1]} f32, "
            f"min {a.min():.6g} max {a.max():.6g} mean {a.mean():.6g}"
        )
    return 0


def _add_solver_flags(p: argparse.ArgumentParser) -> None:
    """The solver flags of ``run`` and ``transform`` (the JAX CLI's
    ``_add_solver_flags``, nmf_tpu/cli.py:29-134), with ``--device``."""
    p.add_argument("--max-iter", type=int, default=200, help="MAX_ITER (nmf.cu:10)")
    p.add_argument(
        "--thresh", type=float, default=0.0,
        help="relative cost-change convergence threshold; 0 = exactly "
        "max-iter iterations (CONVERGE_THRESH, nmf.cu:11)",
    )
    p.add_argument("--check-every", type=int, default=25, help="ITER_CHECK (nmf.cu:9)")
    p.add_argument("--beta", type=float, default=1.0,
                   help="beta-divergence (1 = KL; in memory: plain torch ops)")
    p.add_argument(
        "--algorithm", choices=["mu", "hals"], default="mu",
        help="mu = multiplicative updates (reference); hals = Frobenius "
        "coordinate descent (requires --beta 2)",
    )
    for flag, what in (("--l1-w", "L1 penalty on W"), ("--l1-h", "L1 penalty on H"),
                       ("--l2-w", "L2 penalty on W"), ("--l2-h", "L2 penalty on H")):
        p.add_argument(flag, type=float, default=0.0, help=what)
    p.add_argument("--jsonl", help="append run metrics to this JSONL file")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (default; raises without a card) or cpu",
    )
    p.add_argument(
        "--dtype", choices=["float32", "float32_fast", "bfloat16"], default="float32",
        help="update-GEMM precision: float32 = exact (reference parity), "
        "float32_fast = 3-pass bf16 split-float, bfloat16 = bf16 inputs "
        "(accumulation is always float32)",
    )
    p.add_argument(
        "--x-dtype", choices=["float32", "bfloat16", "int8"], default="float32",
        help="storage dtype of X: bfloat16 halves its stream; int8 quarters it "
        "(uint8 codes + per-column scales, dequantized in register; opt-in, "
        "lossy for entries far below their column peak)",
    )
    p.add_argument(
        "--x-quant-rows", type=int, default=0,
        help="int8-X scale granularity: one scale per (N-row block, column) "
        "instead of per column; such X takes the plain torch ops (the "
        "kernels' scales are per column)",
    )
    p.add_argument(
        "--out-of-core", action="store_true",
        help="stream X from its .bin file in column blocks (X may exceed "
        "device and host memory); one device; every family, --mask and --freeze",
    )
    p.add_argument(
        "--block-n", type=int,
        help="columns per streamed block (default: ~256 MiB of f32)",
    )
    p.add_argument(
        "--backend", choices=["auto", "jnp", "pallas", "autotune"], default="auto",
        help="auto/pallas: the CUDA kernels on the card; jnp: plain torch ops "
        f"(autotune: not ported yet, {_AUTOTUNE})",
    )
    p.add_argument("--no-cost", action="store_true", help="skip cost tracking")
    p.add_argument(
        "--accelerate", action="store_true",
        help="safeguarded Nesterov-accelerated updates (fewer iterations to a "
        "given cost; the history still never rises); reads one cost back "
        "per check block",
    )
    p.add_argument(
        "--strict-compat", action="store_true",
        help="replay the reference's padded-EPS numerics (buffers padded to "
        "32-multiples, true f32, plain torch ops); run, in memory only",
    )
    for flag, (kw, where) in _SOLVER_LATER.items():
        p.add_argument(flag, help=f"only its JAX default so far ({where})", **kw)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nmf_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="factorize X ~= W @ H")
    run.add_argument("X", help="input matrix .bin")
    run.add_argument("W", nargs="?", help="initial W .bin (optional with --rank)")
    run.add_argument("H", nargs="?", help="initial H .bin (optional with --rank)")
    run.add_argument(
        "-o", "--output", nargs=2, metavar=("WOUT", "HOUT"),
        default=("Wout.bin", "Hout.bin"),
        help="output paths (default: Wout.bin Hout.bin, as the reference)",
    )
    run.add_argument("--rank", "-k", type=int, help="rank for generated init")
    run.add_argument(
        "--init", choices=["random", "scaled", "nndsvd", "nndsvda", "nndsvdar"],
        default="nndsvda",
        help="init strategy with --rank (default nndsvda: SVD-based, MU-safe; "
        "--out-of-core takes random only)",
    )
    run.add_argument("--seed", type=int, default=0)
    run.add_argument(
        "--mask",
        help="observed-data mask .bin (same shape as X): masked/weighted NMF, "
        "zero entries excluded from the objective and both updates (missing "
        "data); KL family; composes with --l1*/--l2* and --out-of-core (the "
        "mask streams beside X)",
    )
    run.add_argument(
        "--online", action="store_true",
        help="one-pass streaming dictionary learning over X's columns (memory "
        "independent of N), then an out-of-core transform for H; see "
        "--online-passes/--online-rho/--online-inner-iters",
    )
    run.add_argument("--online-passes", type=int, default=1)
    run.add_argument("--online-rho", type=float, default=1.0,
                     help="forgetting factor in (0,1]; <1 tracks distribution drift")
    run.add_argument("--online-inner-iters", type=int, default=20)
    run.add_argument(
        "--freeze", type=int, default=0, metavar="N",
        help="keep the FIRST N dictionary columns of W fixed while the rest train "
        "(template-based fitting; order template columns first); in memory and "
        "with --out-of-core",
    )
    for flag, (kw, where) in _RUN_LATER.items():
        run.add_argument(flag, help=f"only its JAX default so far ({where})", **kw)
    _add_solver_flags(run)
    run.set_defaults(fn=cmd_run)

    tr = sub.add_parser(
        "transform",
        help="H-only inference: factor new data against a fixed W (--out-of-core "
        "streams X's columns)",
    )
    tr.add_argument("X", help="input matrix .bin (new columns)")
    tr.add_argument("W", help="learned dictionary W .bin")
    tr.add_argument("-o", "--output", default="Hout.bin", help="output H path")
    tr.add_argument("--h0", help="optional warm-start H .bin")
    tr.add_argument("--mask", help="observed-data mask .bin (same shape as X): score "
                    "partially observed columns; missing entries never drive the fit "
                    "(in memory, or streamed beside X with --out-of-core)")
    tr.add_argument("--seed", type=int, default=0,
                    help="seed of the start H without --h0 (RandomState, as JAX)")
    _add_solver_flags(tr)
    tr.set_defaults(fn=cmd_transform)

    sep = sub.add_parser("separate", help="audio source separation via spectrogram NMF")
    sep.add_argument("audio", help="input WAV file")
    sep.add_argument("--rank", "-k", type=int, default=32)
    sep.add_argument("--out-dir", default="sources")
    sep.add_argument("--n-fft", type=int, default=1024)
    sep.add_argument("--hop", type=int, default=256)
    sep.add_argument("--seed", type=int, default=0)
    sep.add_argument("--restarts", type=int, default=1,
                     help="only 1 so far (ROADMAP.md Queue 1 step 7, item 9: selection "
                     "and batched solves)")
    _add_solver_flags(sep)
    sep.set_defaults(fn=cmd_separate, thresh=1e-5)

    gen = sub.add_parser("gen", help="write the seed-0 reference fixtures")
    gen.add_argument("directory")
    gen.set_defaults(fn=cmd_gen)

    info = sub.add_parser("info", help="describe .bin files")
    info.add_argument("files", nargs="+")
    info.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except (NotImplementedError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
