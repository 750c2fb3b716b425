"""Command-line interface of the PyTorch port (``run``, ``transform``,
``separate``, ``select``, ``batch``, ``export``, ``serve``, ``gen``,
``info``, ``doctor``).

    python -m nmf_tpu_torch run X.bin W.bin H.bin -o Wout.bin Hout.bin   # on the card
    python -m nmf_tpu_torch run X.bin --rank 32 --device cpu   # NNDSVDa init
    python -m nmf_tpu_torch run X.bin W.bin H.bin --accelerate       # Nesterov loop
    python -m nmf_tpu_torch run X.bin W.bin H.bin --strict-compat    # padded-EPS replay
    python -m nmf_tpu_torch run X.bin W.bin H.bin --out-of-core --block-n 4096  # X streamed
    python -m nmf_tpu_torch run X.bin W.bin H.bin --beta 2 --algorithm hals     # HALS
    python -m nmf_tpu_torch run X.bin W.bin H.bin --mask M.bin   # observed entries only
    python -m nmf_tpu_torch run X.bin W.bin H.bin --freeze 8     # first 8 columns of W fixed
    python -m nmf_tpu_torch run X.bin --rank 32 --init random --online   # one-pass learner
    python -m nmf_tpu_torch run X.bin --rank 32 --restarts 8     # keep the best of 8 seeds
    python -m nmf_tpu_torch run X.bin W.bin H.bin --checkpoint-dir ck   # resumable
    python -m nmf_tpu_torch run X.bin W.bin H.bin --live --validate     # each check as it runs
    python -m torch.distributed.run --nproc-per-node 4 -m nmf_tpu_torch run X.bin W.bin H.bin \
        --mesh 2x2                                               # sharded over 4 ranks
    python -m nmf_tpu_torch transform X.bin W.bin -o H.bin       # H against a fixed W
    python -m nmf_tpu_torch transform X.bin W.bin -o H.bin --out-of-core --block-n 4096
    python -m nmf_tpu_torch separate song.wav --rank 32 --out-dir sources   # the paper's pipeline
    python -m nmf_tpu_torch select X.bin --ranks 4:32:4 --stability   # rank selection
    python -m nmf_tpu_torch batch specs/ --rank 32 --out-dir out    # a directory in one solve
    python -m nmf_tpu_torch export Wout.bin -o model.nmfz --block-cols 1024   # serving artifact
    python -m nmf_tpu_torch serve model.nmfz X.bin -o H.bin      # H from the artifact alone
    python -m nmf_tpu_torch serve model.nmfz X.bin -o H.bin --out-of-core   # X streamed
    python -m nmf_tpu_torch gen ./fixtures        # seed-0 reference fixtures
    python -m nmf_tpu_torch info fixtures/X.bin   # .bin header/stats, or an artifact's meta
    python -m nmf_tpu_torch doctor --json         # is the card usable?

The flags mirror ``python -m nmf_tpu``, and every flag of the JAX CLI's
subcommands is parsed: a flag is never silently ignored.  Under ``--mesh``
(launched by ``python -m torch.distributed.run``) every rank reads the
input files and rank 0 reports and writes the gathered factors;
``--restarts``, ``select`` and ``batch`` read the mesh's ranks as one
member axis, as the JAX CLI flattens its mesh.  A run leaves its process
group through :func:`~nmf_tpu_torch.parallel.mesh.shutdown`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .io import binio, fixtures
from .io.dataset import BinDataset
from .models import init as init_mod
from .models.masked import solve_masked, solve_masked_h_only
from .models.nmf import solve_h_only
from .models.online import solve_online
from .models.selection import solve_rank_sweep, solve_restarts
from .models.semi import solve_semi
from .models.separation import separate
from .models.solver import SolveResult, solve
from .models.streaming import (
    BinColumnSource,
    solve_out_of_core,
    transform_out_of_core,
    wire_itemsize,
)
from .models.stability import rank_stability
from .models.strict import solve_strict
from .parallel.batched import solve_batched
from .parallel.mesh import BOTH, FlatMesh, axis_size, init_distributed, make_mesh, shutdown
from .parallel.sharded import gather_result, solve_sharded
from .utils.checkpoint import solve_with_checkpoints
from .utils.config import Precision, SolveConfig
from .utils.device import resolve_device
from .utils.guards import validate_input, validate_result
from .utils.metrics import MetricsLogger

def _parse_mesh_shape(spec: str):
    """ROWSxCOLS (e.g. '4x2') -> (rows, cols), with the JAX CLI's error."""
    parts = spec.lower().split("x")
    try:
        r, c = (int(v) for v in parts)
    except ValueError:
        r = c = 0
    if len(parts) != 2 or r < 1 or c < 1:
        raise ValueError(f"--mesh must be ROWSxCOLS with positive factors (e.g. 4x2), got {spec!r}")
    return r, c


def _mesh_from(args, dev):
    """The RxC mesh of ``--mesh`` (None without it) over the launcher's
    ranks: ``python -m torch.distributed.run --nproc-per-node R*C -m
    nmf_tpu_torch ...`` (NCCL on the card, one rank a GPU; gloo with
    ``--device cpu``).  A world of another size is a ValueError (exit 2)."""
    if not args.mesh:
        return None
    r, c = _parse_mesh_shape(args.mesh)
    if "RANK" in os.environ:    # under a launcher
        init_distributed(dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != r * c:
        raise ValueError(
            f"--mesh {args.mesh} needs {r * c} ranks and the world has {world}: launch it "
            f"with python -m torch.distributed.run --nproc-per-node {r * c} -m nmf_tpu_torch ..."
        )
    return make_mesh((r, c), dev)


def _lead(mesh) -> bool:
    """Whether this process reports and writes: always without a mesh,
    rank 0 with one."""
    return mesh is None or dist.get_rank() == 0


def _logger(args, mesh) -> MetricsLogger:
    lead = _lead(mesh)
    return MetricsLogger(verbose=lead and not args.quiet, jsonl_path=args.jsonl if lead else None)


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _config(args) -> SolveConfig:
    return SolveConfig(
        max_iter=args.max_iter, thresh=args.thresh, check_every=args.check_every,
        precision=Precision(
            matmul_dtype=args.dtype, x_dtype=args.x_dtype, x_quant_rows=args.x_quant_rows
        ),
        backend=args.backend, track_cost=not args.no_cost, live_metrics=args.live,
        accelerate=args.accelerate,
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


def _cmd_run_online(args, dev, mesh) -> int:
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
    logger = _logger(args, mesh)
    with logger.timed() as t:
        res = solve_online(args.X, w0, config, block_n=args.block_n,
                           inner_iters=args.online_inner_iters, rho=args.online_rho,
                           passes=args.online_passes, seed=args.seed, mesh=mesh, device=dev)
        tr = transform_out_of_core(args.X, res.w, config=config, block_n=args.block_n,
                                   seed=args.seed, mesh=mesh, device=dev)
    if not _lead(mesh):
        return 0
    if args.validate:
        validate_input("W", res.w)
        validate_input("H", tr.h)
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


def _cmd_run_out_of_core(args, dev, mesh) -> int:
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
    logger = _logger(args, mesh)
    with logger.timed() as t:
        res = solve_out_of_core(source, w0, h0, config, block_n=args.block_n,
                                checkpoint_dir=args.checkpoint_dir,
                                checkpoint_every=args.checkpoint_every, mesh=mesh, mask=mask,
                                n_frozen=args.freeze, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # time the run, not its enqueue
    logger.report(res, (m, n), t.seconds, check_every=config.check_every)
    if args.validate:
        validate_result(res)
    if not _lead(mesh):
        return 0
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
    if args.strict_compat and args.mesh:
        return _error("--strict-compat is a single-device exact-replication mode "
                      "(no --mesh / --checkpoint-dir)")
    if args.restarts > 1 and (args.out_of_core or args.online):
        return _error("--restarts batches whole in-memory solves (no --out-of-core / --online)")
    if args.online and args.out_of_core:
        return _error("pick one streaming mode — --out-of-core (full alternating "
                      "solve, one X stream per iteration) or --online (one-pass "
                      "dictionary learning)")
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    mesh = _mesh_from(args, dev)
    if args.online:
        return _cmd_run_online(args, dev, mesh)
    if args.out_of_core:
        return _cmd_run_out_of_core(args, dev, mesh)
    x = binio.read_matrix(args.X)
    if bool(args.W) != bool(args.H):
        return _error(_LONE_INIT)
    if args.W and args.H:
        w0 = binio.read_matrix(args.W)
        h0 = binio.read_matrix(args.H)
    elif args.rank:
        m, n = x.shape
        if args.restarts > 1:
            w0 = h0 = None  # solve_restarts makes each member's seeded init
        elif args.init == "random":
            w0, h0 = init_mod.random_init(m, args.rank, n, seed=args.seed)
        elif args.init == "scaled":
            w0, h0 = init_mod.scaled_random_init(x, args.rank, seed=args.seed)
        else:
            w0, h0 = init_mod.nndsvd_init(x, args.rank, variant=args.init, seed=args.seed)
    else:
        return _error("provide W and H files, or --rank for generated init")

    config = _config(args)
    logger = _logger(args, mesh)
    mask = None
    if args.mask:
        mask = binio.read_matrix(args.mask)
        if mask.shape != x.shape:
            return _error(f"mask shape {mask.shape} != X shape {x.shape}")
        if args.strict_compat or args.checkpoint_dir:
            return _error("--mask runs the masked solver (no --strict-compat / "
                          "--checkpoint-dir; use --out-of-core for resumable masked runs)")
    if args.validate:
        validate_input("X", x)
        if w0 is not None:   # --restarts makes its inits later
            validate_input("W0", w0)
            validate_input("H0", h0)
    if args.freeze and (args.strict_compat or args.checkpoint_dir):
        return _error("--freeze composes with the plain / --mesh / --out-of-core solvers only")
    if mask is not None and args.freeze:
        return _error("--freeze is not implemented for masked solves")
    if args.restarts > 1:
        return _cmd_run_restarts(args, x, config, logger, mask, dev, mesh)
    if args.strict_compat and args.checkpoint_dir:
        return _error("--strict-compat is a single-device exact-replication mode "
                      "(no --mesh / --checkpoint-dir)")
    if args.checkpoint_dir:
        return _cmd_run_checkpointed(args, x, w0, h0, config, logger, dev, mesh)
    with logger.timed() as t:
        if mask is not None:
            res = solve_masked(x, w0, h0, mask, config, mesh=mesh, device=dev)
        elif args.freeze:
            res = solve_semi(x, w0, h0, config, n_frozen=args.freeze, mesh=mesh, device=dev)
        elif mesh is not None:
            res = solve_sharded(x, w0, h0, config, mesh=mesh)
        else:
            # a ValueError of solve_strict (--accelerate, --beta, --algorithm
            # hals, penalties: strict mode replays one algorithm) exits 2
            # through main() with its message
            res = (solve_strict if args.strict_compat else solve)(x, w0, h0, config, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # time the run, not its enqueue
    if mesh is not None:
        res = gather_result(res, mesh)   # the global W and H on every rank
    logger.report(res, x.shape, t.seconds, check_every=config.check_every)
    if args.validate:
        validate_result(res)
    if not _lead(mesh):
        return 0
    w_out, h_out = _write_factors(res, args)
    if not args.quiet:
        w_path, h_path = args.output
        print(f"[nmf] wrote {w_path} {w_out.shape}, {h_path} {h_out.shape}", file=sys.stderr)
    return 0


def _state_as_result(state) -> SolveResult:
    """A checkpointed run's final state in the shape of a ``SolveResult``,
    for the metrics report and the guards (``nmf_tpu/cli.py:197-214``): its
    stitched cost history plays the solver's history."""
    hist = np.asarray(state.cost_history, dtype=np.float32)
    return SolveResult(
        w=state.w, h=state.h, iterations=np.int32(state.iteration),
        cost=hist[-1] if hist.size else np.float32("nan"), cost_history=hist,
        num_checks=np.int32(hist.size), converged=np.bool_(state.converged),
        momentum=np.float32(state.momentum),
    )


def _cmd_run_checkpointed(args, x, w0, h0, config, logger, dev, mesh) -> int:
    """run with --checkpoint-dir: the solve in segments of
    --checkpoint-every iterations, each checkpointed, resumed from the
    newest checkpoint there (``nmf_tpu/cli.py:548-570``); on a mesh the
    factors are gathered and rank 0 writes the .bin checkpoints."""
    with logger.timed() as t:
        state = solve_with_checkpoints(x, w0, h0, config, args.checkpoint_dir,
                                       every=args.checkpoint_every, mesh=mesh, device=dev)
    res = _state_as_result(state)
    logger.report(res, x.shape, t.seconds, check_every=config.check_every,
                  check_iterations=state.check_iterations)
    if args.validate:
        validate_result(res)
    if not _lead(mesh):
        return 0
    w_path, h_path = args.output
    binio.write_matrix(state.w, w_path)
    binio.write_matrix(state.h, h_path)
    if not args.quiet:
        print(f"[nmf] checkpointed run: {state.iteration} iters, converged={state.converged}, "
              f"{t.seconds:.2f}s", file=sys.stderr)
        print(f"[nmf] wrote {w_path} {state.w.shape}, {h_path} {state.h.shape}", file=sys.stderr)
    return 0


def _cmd_run_restarts(args, x, config, logger, mask, dev, mesh) -> int:
    """run with --restarts N: N seeded solves in one batched solve, the
    lowest-cost one written (``nmf_tpu/cli.py:458-523``); on a mesh the
    members split over all its ranks."""
    if not args.rank or args.W or args.H:
        return _error("--restarts generates its own seeded inits; use --rank (not W/H files)")
    if args.strict_compat or args.checkpoint_dir or mask is not None or args.freeze:
        return _error("--restarts composes with --mesh only (no --strict-compat / "
                      "--checkpoint-dir / --mask / --freeze)")
    if mesh is not None:
        # restarts are pure data parallelism over members: one flat axis
        n_dev = axis_size(mesh, BOTH)
        mesh = FlatMesh(mesh, "b")
        if args.restarts % n_dev:
            return _error(f"--restarts {args.restarts} must be a multiple of the mesh "
                          f"device count {n_dev}")
    # the deterministic nndsvd variants would make identical members
    init = args.init if args.init in ("random", "scaled", "nndsvdar") else "scaled"
    if init != args.init and not args.quiet:
        print(f"[nmf] --init {args.init} is deterministic (identical restart members); "
              "using 'scaled' with per-member seeds", file=sys.stderr)
    with logger.timed() as t:
        sel = solve_restarts(x, rank=args.rank, n_restarts=args.restarts, config=config,
                             seed=args.seed, init=init, mesh=mesh, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # time the run, not its enqueue
    w_b, h_b = sel.best
    res = dataclasses.replace(sel.best_solve_result(), w=w_b, h=h_b)
    logger.report(res, x.shape, t.seconds, check_every=config.check_every)
    if args.validate:
        validate_result(res)
    if mesh is not None and not _lead(mesh.mesh):
        return 0
    if not args.quiet:
        costs = ", ".join(f"{c:.6g}" for c in sel.costs)
        print(f"[nmf] {args.restarts} restarts (seeds {args.seed}.."
              f"{args.seed + args.restarts - 1}): costs [{costs}]; kept #{sel.best_index}",
              file=sys.stderr)
    _write_factors(res, args)
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
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    mesh = _mesh_from(args, dev)
    config = _config(args)
    w = binio.read_matrix(args.W)
    h0 = binio.read_matrix(args.h0) if args.h0 else None
    logger = _logger(args, mesh)
    if args.out_of_core:
        mask = BinColumnSource(args.mask) if args.mask else None
        with logger.timed() as t:
            res = transform_out_of_core(args.X, w, h0=h0, config=config, block_n=args.block_n,
                                        mesh=mesh, seed=args.seed, mask=mask, device=dev)
        h_out = res.h
        if not _lead(mesh):
            return 0
        if args.validate:
            validate_input("H", h_out)
            if config.track_cost and not np.isfinite(res.cost):
                print("error: non-finite transform cost", file=sys.stderr)
                return 1
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
                                          mesh=mesh, device=dev)
            else:
                res = solve_h_only(x, w, h0, config, mesh=mesh, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # time the run, not its enqueue
        if mesh is not None:
            res = gather_result(res, mesh)
        logger.report(res, x.shape, t.seconds, check_every=config.check_every)
        if args.validate:
            validate_result(res)
        h_out = res.h.cpu().float().numpy()
        if not _lead(mesh):
            return 0
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
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    sr, audio = _read_wav(args.audio)
    config = _config(args)
    logger = MetricsLogger(verbose=not args.quiet, jsonl_path=args.jsonl)
    with logger.timed() as t:
        res = separate(audio, n_components=args.rank, n_fft=args.n_fft, hop=args.hop,
                       config=config, seed=args.seed, n_restarts=args.restarts, device=dev)
    if args.validate:
        validate_result(res.solve_result)
        if not np.all(np.isfinite(res.sources)):
            print("error: non-finite separated sources", file=sys.stderr)
            return 1
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


def _parse_ranks(spec: str) -> list:
    """'8,16,32' or 'START:STOP:STEP' (stop inclusive) -> sorted ranks."""
    try:
        if ":" in spec:
            parts = [int(v) for v in spec.split(":")]
            if len(parts) == 2:
                parts.append(1)
            start, stop, step = parts
            ranks = list(range(start, stop + 1, step))
        else:
            ranks = [int(v) for v in spec.split(",")]
    except ValueError:
        ranks = []
    if not ranks or any(r < 1 for r in ranks):
        raise ValueError(
            f"--ranks must be a comma list ('8,16,32') or START:STOP:STEP "
            f"('4:40:4', stop inclusive) of positive ranks, got {spec!r}"
        )
    return sorted(set(ranks))


def _in_memory_only(args, what: str):
    """The exit of a flag that needs a mode ``select`` and ``batch`` lack,
    in the JAX CLI's words, or None."""
    for flag, name in ((args.checkpoint_dir, "--checkpoint-dir"),
                       (args.out_of_core, "--out-of-core"),
                       (args.strict_compat, "--strict-compat"),
                       (args.block_n, "--block-n")):
        if flag:
            return _error(f"{name} is not supported for {what}")
    return None


def cmd_select(args) -> int:
    """Rank selection: candidate ranks swept in one batched solve; with
    --stability, Brunet's consensus clustering recommends the rank
    (``nmf_tpu/cli.py:899-1016``)."""
    rc = _in_memory_only(args, "rank selection (the sweep is one in-memory batched solve)")
    if rc is not None:
        return rc
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    x = binio.read_matrix(args.X)
    if args.validate:
        validate_input("X", x)
    config = _config(args)
    mesh2d = _mesh_from(args, dev)
    # the member axis is pure data parallelism: all R*C ranks (cli.py:923-930)
    mesh = None if mesh2d is None else FlatMesh(mesh2d, "members")
    ranks = _parse_ranks(args.ranks)
    restarts = args.restarts
    if args.stability:
        restarts = 4 if restarts is None else restarts
        st = rank_stability(x, ranks, n_restarts=restarts, config=config, seed=args.seed,
                            init=args.init, mesh=mesh, device=dev)
        sel, rec = st.sweep, st.best_rank()
    else:
        restarts = 1 if restarts is None else restarts
        if restarts < 1:
            raise ValueError(f"--restarts must be >= 1, got {restarts}")
        members = [r for r in ranks for _ in range(restarts)]
        sel = solve_rank_sweep(x, members, config, seed=args.seed, init=args.init, mesh=mesh,
                               device=dev)
        st, rec = None, None
    if not _lead(mesh2d):
        return 0
    member_ranks = np.asarray(sel.ranks)
    costs = np.asarray(sel.costs, np.float64)
    per_rank = {r: float(np.min(costs[member_ranks == r])) for r in ranks}
    if not args.quiet:
        hdr = f"{'rank':>6s} {'best cost':>14s}"
        if st is not None:
            hdr += f" {'cophenetic':>11s} {'dispersion':>11s}"
        print(hdr, file=sys.stderr)
        for i, r in enumerate(ranks):
            line = f"{r:6d} {per_rank[r]:14.6g}"
            if st is not None:
                line += f" {st.cophenetic[i]:11.4f} {st.dispersion[i]:11.4f}"
            print(line, file=sys.stderr)
        if st is not None:
            print(f"[nmf] recommended rank (Brunet first-drop): {rec}", file=sys.stderr)
        else:
            print("[nmf] note: the divergence decreases monotonically with rank — use "
                  "--stability for a principled recommendation", file=sys.stderr)
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            f.write(json.dumps({
                "command": "select",
                "ranks": ranks,
                "restarts": restarts,
                "best_cost_per_rank": per_rank,
                "cophenetic": [float(v) for v in st.cophenetic] if st is not None else None,
                "recommended_rank": rec,
            }) + "\n")
    if args.output:
        if rec is None and len(ranks) > 1:
            return _error("-o needs one rank to write — pass --stability (the "
                          "recommendation picks it) or a single --ranks value")
        target = rec if rec is not None else ranks[0]
        at_rank = np.nonzero(member_ranks == target)[0]
        w_b, h_b = sel.factors(int(at_rank[np.argmin(costs[at_rank])]))
        w_out, h_out = (t.cpu().float().numpy() for t in (w_b, h_b))
        binio.write_matrix(w_out, args.output[0])
        binio.write_matrix(h_out, args.output[1])
        if not args.quiet:
            print(f"[nmf] wrote {args.output[0]} {w_out.shape}, {args.output[1]} "
                  f"{h_out.shape} at rank {target}", file=sys.stderr)
    return 0


def cmd_batch(args) -> int:
    """Factorize every .bin matrix of a directory in one batched solve
    (``nmf_tpu/cli.py:1017-1096``): ``<stem>.W.bin`` and ``<stem>.H.bin``
    for each, from random inits drawn from ``--seed``."""
    rc = _in_memory_only(args, "batch runs (the batch is one in-memory batched solve)")
    if rc is not None:
        return rc
    dev = resolve_device(args.device)  # a missing card fails before any I/O
    ds = BinDataset(args.directory)
    xs = ds.load_batch()
    b, m, n = xs.shape
    if args.validate:
        validate_input("X batch", xs)
    rng = np.random.RandomState(args.seed)
    ws = rng.rand(b, m, args.rank).astype(np.float32)
    hs = rng.rand(b, args.rank, n).astype(np.float32)
    mesh = _mesh_from(args, dev)
    if mesh is not None:
        # pure data parallelism over the batch: all R*C ranks (cli.py:1048-1063)
        n_dev = axis_size(mesh, BOTH)
        if b % n_dev:
            return _error(f"batch of {b} matrices must be a multiple of the mesh device "
                          f"count {n_dev}")
    config = _config(args)
    logger = _logger(args, mesh)
    with logger.timed() as t:
        res = solve_batched(xs, ws, hs, config, mesh=None if mesh is None else
                            FlatMesh(mesh, "batch"), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # time the run, not its enqueue
    if mesh is not None:     # every member's factors, for rank 0 to write
        res = gather_result(res, mesh, w_spec=(BOTH, None, None), h_spec=(BOTH, None, None))
        if not _lead(mesh):
            return 0
    os.makedirs(args.out_dir, exist_ok=True)
    w_all, h_all = (a.cpu().float().numpy() for a in (res.w, res.h))
    for i, path in enumerate(ds.paths):
        stem = os.path.splitext(os.path.basename(path))[0]
        binio.write_matrix(w_all[i], os.path.join(args.out_dir, f"{stem}.W.bin"))
        binio.write_matrix(h_all[i], os.path.join(args.out_dir, f"{stem}.H.bin"))
    costs = res.cost.cpu().numpy()
    if args.jsonl:
        logger.report_raw({
            "kind": "batch",
            "batch": int(b),
            "shape": [int(m), int(n)],
            "rank": int(args.rank),
            "seconds": t.seconds,
            "median_cost": float(np.median(costs)),
            "iterations": res.iterations.tolist(),
        })
    if not args.quiet:
        print(f"[nmf] batch of {b} ({m}x{n}, rank {args.rank}): {t.seconds:.2f}s, median "
              f"cost {np.median(costs):.4e}, outputs in {args.out_dir}", file=sys.stderr)
    return 0


def cmd_gen(args) -> int:
    for path in fixtures.write_reference_fixtures(args.directory).values():
        print(f"wrote {path}")
    return 0


def cmd_doctor(args) -> int:
    """Environment diagnosis (``utils/doctor.py``): exit 0 iff a bounded
    subprocess ran the matmul check on the device and fetched the verified
    result."""
    from .utils import doctor

    report = doctor.diagnose(platform=args.platform, timeout=args.timeout)
    print(json.dumps(report) if args.json else doctor.format_report(report))
    return 0 if report["up"] else 1


def cmd_export(args) -> int:
    """Package W and the H-only solve's config into a ``.nmfz`` serving
    artifact (``nmf_tpu/cli.py:700-753``); ``--mesh RxC`` bakes the sharded
    solve in and needs no process group.  Exporting needs no device."""
    for flag, name in ((args.out_of_core, "--out-of-core"),
                       (args.checkpoint_dir, "--checkpoint-dir"),
                       (args.live, "--live"),
                       (args.strict_compat, "--strict-compat"),
                       # the STREAMING block flag; the artifact's width is --block-cols
                       (args.block_n, "--block-n"),
                       (args.jsonl, "--jsonl")):
        if flag:
            return _error(f"{name} does not apply to an exported program (the artifact is "
                          "a fixed-shape solve; stream on the serving side by calling it "
                          "per block)")
    from .serving import save_transform

    config = _config(args)
    mesh_shape = _parse_mesh_shape(args.mesh) if args.mesh else None
    w = binio.read_matrix(args.W)
    if args.validate:
        validate_input("W", w)
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    save_transform(args.output, w, args.block_cols, config, platforms, mesh_shape=mesh_shape,
                   masked=args.masked, quantized_input=args.quantized_input)
    if not args.quiet:
        notes = (f", mesh {args.mesh}" if mesh_shape else "") + (
            ", masked" if args.masked else "") + (
            ", quantized-input" if args.quantized_input else "")
        print(f"[nmf] exported {args.output}: W {w.shape[0]}x{w.shape[1]}, block "
              f"{args.block_cols} cols, platforms {','.join(platforms)}{notes}, "
              f"{os.path.getsize(args.output)} bytes", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """H for new data from an exported artifact alone (``nmf_tpu/cli.py:
    756-795``): in memory, or ``--out-of-core`` with X (and a mask)
    streamed off disk and H appended block by block.  A mesh artifact
    serves on ``--mesh`` (under ``torch.distributed.run``; rank 0 writes)
    or on a mesh of its shape over the world."""
    from .serving import load_transform

    dev = resolve_device(args.device)  # a missing card fails before any I/O
    mesh = _mesh_from(args, dev)
    t = load_transform(args.artifact, mesh=mesh, device=dev)
    h0 = binio.read_matrix(args.h0) if args.h0 else None
    t0 = time.perf_counter()
    prefetch = not args.no_prefetch
    lead = _lead(t.mesh)
    if args.out_of_core:
        # host memory stays at one block whatever N is
        res = t.stream_bin(args.X, out_path=args.output, h0=h0, seed=args.seed,
                           prefetch=prefetch, mask_path=args.mask or None)
        n_cols, shape = None, None
    else:
        x = binio.read_matrix(args.X)
        mask = binio.read_matrix(args.mask) if args.mask else None
        res = t(x, h0=h0, seed=args.seed, prefetch=prefetch, mask=mask)
        n_cols, shape = x.shape[1], res.h.shape
        if lead:
            binio.write_matrix(res.h, args.output)
    dt = time.perf_counter() - t0
    if lead and not args.quiet:
        n_note = f"{n_cols} cols in " if n_cols is not None else ""
        print(f"[nmf] serve: {n_note}{len(res.block_iterations)} blocks of {res.n_block}, "
              f"iters/block max {res.iterations}, cost {res.cost:.6g}, {dt:.2f}s",
              file=sys.stderr)
        shape_note = f" {shape}" if shape is not None else " (streamed)"
        print(f"[nmf] wrote {args.output}{shape_note}", file=sys.stderr)
    return 0


def _describe_artifact(path: str) -> str:
    """``info``'s line for a zip: a serving artifact described from its
    ``meta.json`` alone (no device, nothing loaded)."""
    import zipfile

    from .serving import _JAX_MAGIC, _MAGIC

    with zipfile.ZipFile(path) as zf:
        if "meta.json" not in zf.namelist():
            # e.g. an .npz is a zip too
            return f"{path}: zip, but not an nmf_tpu_torch serving artifact"
        meta = json.loads(zf.read("meta.json"))
    if meta.get("magic") == _JAX_MAGIC:
        return (f"{path}: the JAX package's serving artifact v{meta.get('format_version')} "
                "(a jax.export program); carry it across with "
                "nmf_tpu_torch.utils.convert.serving_from_jax")
    if meta.get("magic") != _MAGIC:
        return f"{path}: zip, but not an nmf_tpu_torch serving artifact"
    cfg = meta.get("config", {})
    mesh = meta.get("mesh_shape")
    notes = f", mesh {mesh[0]}x{mesh[1]}" if mesh else ""
    if meta.get("masked"):
        notes += ", masked (serve needs --mask)"
    if meta.get("quantized_input"):
        notes += ", quantized-input (host int8 quantization)"
    return (f"{path}: serving artifact v{meta['format_version']} — W {meta['m']}x{meta['k']}, "
            f"block {meta['n_block']} cols, platforms {','.join(meta['platforms'])}{notes}, "
            f"max_iter {cfg.get('max_iter')} thresh {cfg.get('thresh')} "
            f"{cfg.get('algorithm')}/beta={cfg.get('beta')} backend {cfg.get('backend')}, "
            f"torch {meta.get('torch_version')}")


def cmd_info(args) -> int:
    import zipfile

    for path in args.files:
        if zipfile.is_zipfile(path):
            print(_describe_artifact(path))
            continue
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
        help="pallas: the CUDA kernels on the card; jnp: plain torch ops (cuBLAS); "
        "auto: the card's measured rule per shape; autotune: measure both once per "
        "shape, cached in ~/.cache/nmf_tpu_torch/autotune.json "
        "(NMF_TPU_TORCH_AUTOTUNE_CACHE names another file)",
    )
    p.add_argument("--no-cost", action="store_true", help="skip cost tracking")
    p.add_argument(
        "--live", action="store_true",
        help="print each check's cost and relative change as the solve runs "
        "(one host read a check; the factors do not change)",
    )
    p.add_argument("--validate", action="store_true",
                   help="check inputs (finite, non-negative) and results (finite)")
    p.add_argument("--checkpoint-dir",
                   help="checkpoint/resume directory (run: in memory and --out-of-core)")
    p.add_argument("--checkpoint-every", type=int, default=100,
                   help="iterations per checkpoint")
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
    p.add_argument(
        "--mesh",
        help="shard over a ROWSxCOLS mesh of ranks, e.g. --mesh 2x2, launched as "
        "python -m torch.distributed.run --nproc-per-node R*C -m nmf_tpu_torch ... "
        "(NCCL, one rank a card; gloo with --device cpu); run (plain, --freeze, "
        "--mask) and transform (plain, --mask) in memory",
    )


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
    run.add_argument(
        "--restarts", type=int, default=1,
        help="solve from N seeded inits (--rank; seeds --seed..--seed+N-1) in one "
        "batched solve and keep the lowest-divergence factorization",
    )
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
                     help="factorize from N seeded inits in one batched solve and keep "
                     "the lowest-divergence decomposition")
    _add_solver_flags(sep)
    sep.set_defaults(fn=cmd_separate, thresh=1e-5)

    sel = sub.add_parser(
        "select",
        help="rank selection: sweep candidate ranks in one batched solve (every member "
        "is the lower-rank factorization); --stability adds Brunet consensus "
        "clustering and a recommendation",
    )
    sel.add_argument("X", help="input matrix .bin")
    sel.add_argument("--ranks", required=True,
                     help="candidate ranks: comma list ('8,16,32') or START:STOP:STEP "
                     "('4:40:4', stop inclusive)")
    sel.add_argument("--restarts", type=int, default=None,
                     help="restarts per rank (default 1; with --stability 4: a consensus "
                     "needs several seeded members)")
    sel.add_argument("--stability", action="store_true",
                     help="consensus-clustering study (Brunet 2004): per-rank cophenetic "
                     "correlation and the first-drop rank recommendation")
    sel.add_argument("--init", choices=["random", "scaled", "nndsvdar"], default="scaled",
                     help="seed-sensitive init families only (nndsvd/nndsvda would make "
                     "identical restart members)")
    sel.add_argument("--seed", type=int, default=0)
    sel.add_argument("-o", "--output", nargs=2, metavar=("WOUT", "HOUT"), default=None,
                     help="write the best factors at the recommended rank (--stability) "
                     "or at a single --ranks value")
    _add_solver_flags(sel)
    sel.set_defaults(fn=cmd_select)

    batch = sub.add_parser("batch",
                           help="factorize a directory of .bin matrices in one batched solve")
    batch.add_argument("directory", help="directory of same-shaped .bin files")
    batch.add_argument("--rank", "-k", type=int, required=True)
    batch.add_argument("--out-dir", default="batch_out")
    batch.add_argument("--seed", type=int, default=0)
    _add_solver_flags(batch)
    batch.set_defaults(fn=cmd_batch)

    exp = sub.add_parser(
        "export",
        help="package W and the H-only solve into a serving artifact (.nmfz; the config "
        "is rebuilt at load, the backend resolved on the serving device)",
    )
    exp.add_argument("W", help="learned dictionary W .bin")
    exp.add_argument("-o", "--output", default="model.nmfz", help="artifact output path")
    exp.add_argument("--block-cols", type=int, default=1024,
                     help="columns a program call serves (the artifact's fixed X width; "
                     "serve pads the tail block)")
    exp.add_argument("--platforms", default="cuda,cpu",
                     help="comma-separated device types the artifact may serve on (cuda, cpu)")
    exp.add_argument("--masked", action="store_true",
                     help="export the MASKED transform (missing-data scoring): 'serve' then "
                     "requires --mask with the observed-entry weights")
    exp.add_argument("--quantized-input", action="store_true",
                     help="int8 configs only: the program takes host-quantized (codes, "
                     "scales) instead of f32 X — a quarter of the serve-time transfer, the "
                     "same results (composes with --mesh and --masked)")
    _add_solver_flags(exp)
    exp.set_defaults(fn=cmd_export)

    srv = sub.add_parser(
        "serve",
        help="H-only inference from an exported artifact: no W file; the dictionary and "
        "the solve's config come from the .nmfz",
    )
    srv.add_argument("artifact", help=".nmfz from 'export'")
    srv.add_argument("X", help="input matrix .bin (new columns)")
    srv.add_argument("-o", "--output", default="Hout.bin", help="output H path")
    srv.add_argument("--h0", help="optional warm-start H .bin")
    srv.add_argument("--mask", help="observed-entry mask .bin (same shape as X; 0 = "
                     "missing), required by artifacts exported with --masked; with "
                     "--out-of-core its column blocks stream off disk alongside X's")
    srv.add_argument("--seed", type=int, default=0)
    srv.add_argument("--mesh", help="serve a mesh artifact on a ROWSxCOLS mesh of ranks "
                     "(its export shape), launched as python -m torch.distributed.run "
                     "--nproc-per-node R*C -m nmf_tpu_torch serve ...; rank 0 writes")
    srv.add_argument("--out-of-core", action="store_true",
                     help="stream X from its .bin in column blocks and append H blocks to "
                     "the output as they finish (X and H never load into host memory)")
    srv.add_argument("--no-prefetch", action="store_true",
                     help="serve blocks strictly one at a time instead of overlapping the "
                     "next block's copy with the current solve (same bytes)")
    srv.add_argument("--device", default="cuda",
                     help="torch device: cuda (default; raises without a card) or cpu")
    srv.add_argument("--quiet", "-q", action="store_true")
    srv.set_defaults(fn=cmd_serve)

    gen = sub.add_parser("gen", help="write the seed-0 reference fixtures")
    gen.add_argument("directory")
    gen.set_defaults(fn=cmd_gen)

    info = sub.add_parser("info", help="describe .bin files and serving artifacts")
    info.add_argument("files", nargs="+")
    info.set_defaults(fn=cmd_info)

    doc = sub.add_parser(
        "doctor",
        help="diagnose the environment: a bounded device probe (an exact matmul, "
        "a paired copy), versions and the kernel build directory",
    )
    doc.add_argument("--platform", default=None,
                     help="probe this device type instead of cuda (e.g. cpu)")
    doc.add_argument("--timeout", type=float, default=180.0,
                     help="seconds before the device probe is declared hung (it runs in "
                     "a subprocess, so a hang cannot wedge this process)")
    doc.add_argument("--json", action="store_true", help="machine-readable output")
    doc.set_defaults(fn=cmd_doctor)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    grouped = dist.is_initialized()
    rc = 1
    try:
        rc = args.fn(args)
        return rc
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        rc = 2
        return rc
    except (NotImplementedError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        rc = 2
        return rc
    finally:
        if dist.is_initialized() and not grouped:   # the group --mesh joined
            # the ranks meet before they leave only when this one finished:
            # a failed rank must not wait for peers still in a collective
            shutdown(barrier=rc == 0)


if __name__ == "__main__":
    sys.exit(main())
