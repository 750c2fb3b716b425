"""One rank of a CPU mesh for ``tests/test_torch_serving.py`` (not collected).

    python tests/torch_serving_ranks.py RANK WORLD STORE OUT_DIR

joins a gloo group of four processes through ``file://STORE``; rank 0
writes every case's mesh artifact (``nmf_tpu_torch.serving.save_transform``
with ``mesh_shape``) into OUT_DIR, then every rank loads it on the port's
2x2 or 1x4 CPU mesh and serves the problem of :func:`problem`
(``RandomState(7)``, 48 x 5, blocks of 16).  Rank 0 writes each case's H
to ``OUT_DIR/<case>.npz``; every rank writes its block scalars and any
error to ``OUT_DIR/<case>.r<RANK>.json``.  The rank leaves through
``nmf_tpu_torch.parallel.mesh.shutdown`` and exits normally.  Imports
torch, NumPy and ``nmf_tpu_torch`` only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

M, K, NB = 48, 5, 16
N = 3 * NB
N_CUT = 2 * NB + 5          # a ragged tail block: 5 real columns, 11 padded
EPS = float(np.float32(2.2204e-16))
BASE = dict(max_iter=25)
# case -> mesh shape, config fields ("precision" as Precision fields), the
# artifact's flags and how it is called
CASES = {
    "plain": dict(mesh=(2, 2)),
    "plain_1x4": dict(mesh=(1, 4)),
    "hals": dict(mesh=(2, 2), beta=2.0, algorithm="hals"),
    "reg": dict(mesh=(1, 4), l1_h=0.01, l2_h=0.1),
    "accel": dict(mesh=(2, 2), accelerate=True),
    "bf16_x": dict(mesh=(2, 2), precision=dict(matmul_dtype="bfloat16", x_dtype="bfloat16")),
    "ragged": dict(mesh=(2, 2), cut=True),
    "seeded": dict(mesh=(2, 2), seeded=True),
    "default_mesh": dict(mesh=(2, 2), default_mesh=True),
    "masked": dict(mesh=(2, 2), masked=True, l1_h=0.01),
    "masked_1x4": dict(mesh=(1, 4), masked=True, cut=True),
    "quant_cols": dict(mesh=(2, 2), quant=True, precision=dict(x_dtype="int8")),
    "quant_rows": dict(mesh=(2, 2), quant=True, precision=dict(x_dtype="int8", x_quant_rows=16)),
    "quant_rows_1x4": dict(mesh=(1, 4), quant=True, cut=True,
                           precision=dict(x_dtype="int8", x_quant_rows=16)),
    "masked_quant_rows": dict(mesh=(2, 2), masked=True, quant=True, cut=True,
                              precision=dict(x_dtype="int8", x_quant_rows=4)),
    "stream_bin": dict(mesh=(2, 2), stream=True),
    "wrong_mesh": dict(mesh=(2, 2), wrong=True),
}
FLAGS = ("mesh", "cut", "seeded", "default_mesh", "masked", "quant", "stream", "wrong")


def problem():
    """(x, w, h0, mask): JAX's serving test problem, and a 70% mask."""
    rng = np.random.RandomState(7)
    w = rng.rand(M, K).astype(np.float32) + 0.1
    x = rng.rand(M, N).astype(np.float32)
    h0 = np.maximum(rng.rand(K, N).astype(np.float32), np.float32(EPS))
    mask = (np.random.RandomState(11).rand(M, N) > 0.3).astype(np.float32)
    return x, w, h0, mask


def config_kwargs(case: str) -> dict:
    c = CASES[case]
    return dict(BASE, **{k: v for k, v in c.items() if k not in FLAGS})


def call_inputs(case: str):
    """(x, h0 or None, mask or None) of the case's call."""
    x, _, h0, mask = problem()
    c = CASES[case]
    n = N_CUT if c.get("cut") else N
    return (x[:, :n], None if c.get("seeded") or c.get("stream") else h0[:, :n],
            mask[:, :n] if c.get("masked") else None)


def _run(nt, case, meshes, out, rank):
    from nmf_tpu_torch.io.binio import read_matrix, write_matrix
    from nmf_tpu_torch.serving import load_transform

    c = CASES[case]
    path = os.path.join(out, f"{case}.nmfz")
    if c.get("wrong"):
        load_transform(path, mesh=meshes[(1, 4)], device="cpu")
        raise AssertionError("a 2x2 artifact loaded on a 1x4 mesh")
    mesh = None if c.get("default_mesh") else meshes[c["mesh"]]
    t = load_transform(path, mesh=mesh, device="cpu")
    x, h0, mask = call_inputs(case)
    extra = {}
    if c.get("stream"):
        xp, hp = os.path.join(out, "X.bin"), os.path.join(out, "H_stream.bin")
        if rank == 0:
            write_matrix(x, xp)
        import torch.distributed as dist

        dist.barrier()
        res = t.stream_bin(xp, out_path=hp, seed=2)
        mem = t(x, seed=2)
        dist.barrier()      # rank 0 has written the file
        extra = {"streamed_h_none": res.h is None,
                 "file_bitwise": read_matrix(hp).tobytes() == mem.h.tobytes()}
        res = mem
    else:
        res = t(x, h0=h0, mask=mask)
        again = t(x, h0=h0, mask=mask, prefetch=False)
        extra = {"no_prefetch_bitwise": again.h.tobytes() == res.h.tobytes()}
    return {"h": res.h}, {
        "block_costs": res.block_costs.tolist(),
        "block_iterations": res.block_iterations.tolist(),
        "block_converged": res.block_converged.tolist(),
        "mesh_shape": list(t.mesh_shape), "backend": t.backend, **extra,
    }


def main(argv) -> int:
    rank, world, store, out = argv[1:5]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.parallel.mesh import shutdown
    from nmf_tpu_torch.serving import save_transform

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    _, w, _, _ = problem()
    if rank == 0:
        for case, c in CASES.items():
            kw = config_kwargs(case)
            kw["precision"] = nt.Precision(**kw.get("precision", {}))
            save_transform(os.path.join(out, f"{case}.nmfz"), w, NB, nt.SolveConfig(**kw),
                           platforms=("cpu",), mesh_shape=c["mesh"],
                           masked=bool(c.get("masked")), quantized_input=bool(c.get("quant")))
    dist.barrier()
    meshes = {shape: nt.make_mesh(shape, device="cpu") for shape in ((2, 2), (1, 4))}
    for case in CASES:
        try:
            arrays, info = _run(nt, case, meshes, out, rank)
            if rank == 0:
                np.savez(os.path.join(out, f"{case}.npz"), **arrays)
        except (ValueError, NotImplementedError, TypeError) as e:
            info = {"error": type(e).__name__, "message": str(e)}
        with open(os.path.join(out, f"{case}.r{rank}.json"), "w") as f:
            json.dump(info, f)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
