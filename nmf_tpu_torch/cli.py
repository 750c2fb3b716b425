"""Command-line interface of the PyTorch port (``run``, ``transform``,
``gen``, ``info``).

    python -m nmf_tpu_torch run X.bin W.bin H.bin -o Wout.bin Hout.bin   # on the card
    python -m nmf_tpu_torch run X.bin --rank 32 --device cpu   # NNDSVDa init
    python -m nmf_tpu_torch run X.bin W.bin H.bin --accelerate       # Nesterov loop
    python -m nmf_tpu_torch run X.bin W.bin H.bin --strict-compat    # padded-EPS replay
    python -m nmf_tpu_torch run X.bin W.bin H.bin --out-of-core --block-n 4096  # X streamed
    python -m nmf_tpu_torch run X.bin W.bin H.bin --beta 2 --algorithm hals     # HALS
    python -m nmf_tpu_torch transform X.bin W.bin -o H.bin       # H against a fixed W
    python -m nmf_tpu_torch transform X.bin W.bin -o H.bin --out-of-core --block-n 4096
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
import sys

import numpy as np
import torch

from .io import binio, fixtures
from .models import init as init_mod
from .models.nmf import solve_h_only
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
    "--mask": ({}, "Queue 1 item 8: model families (masked solver)"),
    "--online": ({"action": "store_true"}, "Queue 1: model families (online NMF)"),
    "--online-passes": ({"type": int, "default": 1}, "Queue 1: model families (online NMF)"),
    "--online-rho": ({"type": float, "default": 1.0}, "Queue 1: model families (online NMF)"),
    "--online-inner-iters": ({"type": int, "default": 20},
                             "Queue 1: model families (online NMF)"),
    "--freeze": ({"type": int, "default": 0}, "Queue 1 item 8: model families (semi-adaptive NMF)"),
    "--restarts": ({"type": int, "default": 1}, "Queue 1: selection and batched solves"),
}
_AUTOTUNE = "Queue 1 step 11 (item 7): the H100 backend rules and autotune"
# The families (beta, HALS, penalties) run in memory; the streamed solve
# takes the KL MU family alone so far.
_FAMILY_FLAGS = {"--beta": 1.0, "--algorithm": "mu", "--l1-w": 0.0, "--l1-h": 0.0,
                 "--l2-w": 0.0, "--l2-h": 0.0}
_STREAMED_FAMILIES = ("Queue 1 step 6, item 8c: the streamed beta, penalized and HALS "
                      "families")


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


def _cmd_run_out_of_core(args, dev) -> int:
    """run with --out-of-core: X streamed from its .bin in column blocks,
    never loaded whole (``nmf_tpu/cli.py:302-368``)."""
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
    logger = MetricsLogger(verbose=not args.quiet, jsonl_path=args.jsonl)
    with logger.timed() as t:
        res = solve_out_of_core(source, w0, h0, config, block_n=args.block_n, device=dev)
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
    if args.out_of_core:
        refused += [f"{flag} with --out-of-core (ROADMAP.md {_STREAMED_FAMILIES})"
                    for flag, default in _FAMILY_FLAGS.items()
                    if getattr(args, _dest(flag)) != default]
    if refused:
        return _error("not in the PyTorch port yet: " + "; ".join(refused))
    dev = resolve_device(args.device)  # a missing card fails before any I/O
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
    # a ValueError of solve_strict (--accelerate, --beta, --algorithm hals,
    # penalties: strict mode replays one algorithm) exits 2 through main()
    # with its message
    run = solve_strict if args.strict_compat else solve
    with logger.timed() as t:
        res = run(x, w0, h0, config, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # time the run, not its enqueue
    logger.report(res, x.shape, t.seconds, check_every=config.check_every)
    w_out, h_out = _write_factors(res, args)
    if not args.quiet:
        w_path, h_path = args.output
        print(f"[nmf] wrote {w_path} {w_out.shape}, {h_path} {h_out.shape}", file=sys.stderr)
    return 0


def cmd_transform(args) -> int:
    """H-only inference: H for X against a fixed W (``nmf_tpu/cli.py:618-698``)."""
    if args.checkpoint_dir:
        return _error("transform does not checkpoint (each streamed block is "
                      "solved in one visit; re-running re-does only unfinished work)")
    if args.strict_compat:
        return _error("--strict-compat is a full-solve replication mode (use 'run')")
    later = {flag: v for flag, v in _SOLVER_LATER.items() if flag != "--checkpoint-every"}
    later["--mask"] = ({}, "Queue 1 step 6, item 8c: masked solver")
    refused = _refused(args, later)
    if refused:
        return _error("not in the PyTorch port yet: " + "; ".join(refused))
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    config = _config(args)
    w = binio.read_matrix(args.W)
    h0 = binio.read_matrix(args.h0) if args.h0 else None
    logger = MetricsLogger(verbose=not args.quiet, jsonl_path=args.jsonl)
    if args.out_of_core:
        with logger.timed() as t:
            res = transform_out_of_core(args.X, w, h0=h0, config=config,
                                        block_n=args.block_n, seed=args.seed, device=dev)
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
            res = solve_h_only(x, w, h0, config, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # time the run, not its enqueue
        logger.report(res, x.shape, t.seconds, check_every=config.check_every)
        h_out = res.h.cpu().float().numpy()
    binio.write_matrix(h_out, args.output)
    if not args.quiet:
        print(f"[nmf] wrote {args.output} {h_out.shape}", file=sys.stderr)
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
        "device and host memory); one device; run: KL MU family",
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
    tr.add_argument("--mask", help="only its JAX default so far (ROADMAP.md "
                    "Queue 1 step 6, item 8c: masked solver)")
    tr.add_argument("--seed", type=int, default=0,
                    help="seed of the start H without --h0 (RandomState, as JAX)")
    _add_solver_flags(tr)
    tr.set_defaults(fn=cmd_transform)

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
