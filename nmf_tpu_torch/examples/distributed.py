"""Distributed NMF over a mesh of ranks.

Run as a plain script it is a 1x1 mesh over this one process (NCCL on the
card, gloo with ``--device cpu``).  Under a launcher every rank joins the
launcher's group first (``init_distributed``), one rank a card:

    python -m nmf_tpu_torch.examples.distributed
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m nmf_tpu_torch.examples.distributed --device cpu
    # four ranks sharing one card (NCCL takes one rank a card): gloo
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m nmf_tpu_torch.examples.distributed --gloo
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

import nmf_tpu_torch as nt
from nmf_tpu_torch.parallel.mesh import FlatMesh, mesh_coordinate, shutdown

from ._common import host, parser, quick, sections


def inputs(rows: int, cols: int, rank: int, n_dev: int, quick_sizes: bool):
    """((X, W0, H0), (Xs, Ws, Hs)): the sharded problem and one batched
    problem a rank, drawn from ``RandomState(0)`` in the JAX script's order."""
    rng = np.random.RandomState(0)
    x = rng.rand(rows, cols).astype(np.float32)
    w0 = rng.rand(rows, rank).astype(np.float32)
    h0 = rng.rand(rank, cols).astype(np.float32)
    bm, bn = (128, 64) if quick_sizes else (512, 256)
    xs = rng.rand(n_dev, bm, bn).astype(np.float32)
    ws = rng.rand(n_dev, bm, 16).astype(np.float32)
    hs = rng.rand(n_dev, 16, bn).astype(np.float32)
    return (x, w0, h0), (xs, ws, hs)


def _join(device: str, gloo: bool) -> None:
    """Join the launcher's group, when there is a launcher."""
    if not os.environ.get("WORLD_SIZE"):
        return      # a plain script: make_mesh makes a one-rank group
    if gloo:
        # ranks that share a card join a gloo group themselves
        dist.init_process_group("gloo")
        if torch.device(device).type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local % torch.cuda.device_count())
    else:
        nt.init_distributed(device)


def _run(args, mesh, section) -> dict:
    out = {}
    world = dist.get_world_size()
    me = dist.get_rank()
    say = print if me == 0 else (lambda *a, **k: None)
    r, c = (int(v) for v in mesh.shape)
    out["mesh"] = {"shape": [r, c], "world": world}
    say(f"mesh: {{'mr': {r}, 'mc': {c}}} over {world} ranks ({mesh.device_type})")

    q = quick()
    if q:
        args.rows, args.cols, args.rank = 512, 256, 16
    (x, w0, h0), (xs, ws, hs) = inputs(args.rows, args.cols, args.rank, r * c, q)

    with section("sharded"):
        res = nt.solve_sharded(
            x, w0, h0,
            nt.SolveConfig(max_iter=20 if q else 100, thresh=1e-4, check_every=25),
            mesh=mesh,
        )
        full = nt.gather_result(res, mesh)
        i, _ = mesh_coordinate(mesh)
        rows = res.w.shape[0]
        out["sharded"] = {"iterations": int(res.iterations), "num_checks": int(res.num_checks),
                          "cost": float(res.cost), "w": host(full.w), "h": host(full.h),
                          "w_rows": [i * rows, (i + 1) * rows], "w_cols": [0, res.w.shape[1]]}
    say(f"{out['sharded']['iterations']} iterations, cost {out['sharded']['cost']:.4e}")
    (a, b), (c0, c1) = out["sharded"]["w_rows"], out["sharded"]["w_cols"]
    print(f"W: rank {me} holds rows {a}:{b}, cols {c0}:{c1}", flush=True)

    # batched data parallelism: one problem per rank
    n_dev = r * c
    with section("batched"):
        bres = nt.solve_batched(xs, ws, hs, nt.SolveConfig(max_iter=20 if q else 50),
                                mesh=FlatMesh(mesh, "batch"))
        out["batched"] = {"costs": host(bres.cost), "iterations": host(bres.iterations),
                          "num_checks": host(bres.num_checks)}
    say(f"batched: {n_dev} problems, costs {out['batched']['costs'].round(2)}")

    # distributed serving artifact: the sharded transform for THIS mesh
    # shape, then new columns served on the live mesh from the one file
    with tempfile.TemporaryDirectory() as td:
        art = os.path.join(td, "mesh-model.nmfz")
        nt.save_transform(art, out["sharded"]["w"], n_block=args.cols // 2,
                          config=nt.SolveConfig(max_iter=10 if q else 40, backend="jnp"),
                          platforms=(mesh.device_type,), mesh_shape=(r, c))
        with section("serving"):
            served = nt.load_transform(art, mesh=mesh)(x)
            out["serving"] = {"cost": float(served.cost), "h": served.h,
                              "block_iterations": served.block_iterations}
    say(f"mesh serving: {x.shape[1]} cols on the {r}x{c} mesh, cost {out['serving']['cost']:.4e}")
    return out


def main(argv=None, section=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--cols", type=int, default=2048)
    ap.add_argument("--rank", type=int, default=128)
    ap.add_argument("--gloo", action="store_true",
                    help="under a launcher, join a gloo group (several ranks on one card)")
    args = ap.parse_args(argv)
    _join(args.device, args.gloo)
    mesh = nt.make_mesh(device=args.device)  # 2-D ('mr', 'mc') over all ranks
    try:
        out = _run(args, mesh, sections(section))
    except BaseException:
        shutdown(barrier=False)     # peers may sit in a collective
        raise
    shutdown()
    return out


if __name__ == "__main__":
    main()
