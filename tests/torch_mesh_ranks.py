"""One rank of a CPU mesh for ``tests/test_torch_mesh.py`` (not collected).

    python tests/torch_mesh_ranks.py RANK WORLD STORE ROWS COLS OUT_DIR

joins a gloo group of WORLD processes through ``file://STORE``, builds the
ROWS x COLS mesh of ``nmf_tpu_torch`` on the CPU and runs every case of
``GROUPS[(ROWS, COLS)]`` on the problem of ``tests/test_sharded.py``
(``RandomState(3)``, 128 x 16 x 160).  Rank 0 writes each case's gathered
result to ``OUT_DIR/<case>.npz``; every rank writes its own scalars, its
live-metrics lines and any error to ``OUT_DIR/<case>.r<RANK>.json``.  The rank
leaves through ``nmf_tpu_torch.parallel.mesh.shutdown``, drops its mesh,
records the gloo threads still alive (:func:`record_exit`) and exits
normally.
Imports torch, NumPy and ``nmf_tpu_torch`` only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

M, K, N = 128, 16, 160
BASE = dict(max_iter=20, check_every=5)
# case -> the entry point it drives and its config (SolveConfig fields;
# "precision" as Precision fields); the test builds the same config for
# nmf_tpu
CASES = {
    "kl": dict(entry="solve"),
    "kl_pallas": dict(entry="solve", backend="pallas"),
    "reg": dict(entry="solve", l1_w=0.01, l1_h=0.02, l2_w=0.05, l2_h=0.03),
    "beta2": dict(entry="solve", beta=2.0),
    "beta05": dict(entry="solve", beta=0.5),
    "hals": dict(entry="solve", beta=2.0, algorithm="hals"),
    "int8": dict(entry="solve", precision=dict(x_dtype="int8")),
    "int8_rows": dict(entry="solve", precision=dict(x_dtype="int8", x_quant_rows=48)),
    "pair": dict(entry="solve_pair", precision=dict(x_dtype="int8")),
    "accel": dict(entry="solve", accelerate=True),
    "thresh": dict(entry="solve", max_iter=100_000, thresh=1e-3, check_every=10),
    "live": dict(entry="solve", live_metrics=True),
    "masked": dict(entry="masked"),
    "masked_reg": dict(entry="masked", l1_h=0.02, l2_w=0.01),
    "masked_int8": dict(entry="masked", precision=dict(x_dtype="int8")),
    "h_kl": dict(entry="h_only"),
    "h_reg": dict(entry="h_only", l1_h=0.02, l2_h=0.04),
    "h_beta2": dict(entry="h_only", beta=2.0),
    "h_hals": dict(entry="h_only", beta=2.0, algorithm="hals"),
    "masked_h": dict(entry="masked_h_only"),
    "masked_h_int8_rows": dict(entry="masked_h_only",
                               precision=dict(x_dtype="int8", x_quant_rows=32)),
    "w_only": dict(entry="w_only"),
    "semi": dict(entry="semi", n_frozen=4),
    "nmf": dict(entry="nmf"),
    # the refusals: a pair under a float policy, 2-D scales where the
    # policy says 1-D, backend="pallas" with int8 X, a mesh that does not
    # divide X
    "pair_not_int8": dict(entry="solve_pair"),
    "pair_ndim": dict(entry="solve_pair_rows", precision=dict(x_dtype="int8")),
    "pallas_int8": dict(entry="solve", backend="pallas", precision=dict(x_dtype="int8")),
    "indivisible": dict(entry="indivisible"),
}
GROUPS = {
    (1, 1): ["kl"],
    (2, 1): ["kl", "masked"],
    (1, 2): ["kl", "semi"],
    (2, 2): list(CASES),
    (4, 1): ["kl", "int8_rows", "hals"],
    (1, 4): ["kl", "h_kl"],
}


def problem():
    rng = np.random.RandomState(3)
    x = rng.rand(M, N).astype(np.float32)
    w = rng.rand(M, K).astype(np.float32)
    h = rng.rand(K, N).astype(np.float32)
    mask = (np.random.RandomState(9).rand(M, N) > 0.3).astype(np.float32)
    return x, w, h, mask


def config_kwargs(case: str) -> dict:
    """The case's SolveConfig fields (``precision`` as a dict), over BASE."""
    spec = {k: v for k, v in CASES[case].items() if k not in ("entry", "n_frozen")}
    return {**BASE, **spec}


def _config(nt, case):
    kw = config_kwargs(case)
    kw["precision"] = nt.Precision(**kw.get("precision", {}))
    return nt.SolveConfig(**kw)


def _run(nt, case, mesh):
    """(result arrays, live lines) of one case on this rank."""
    from nmf_tpu_torch.ops.quant import quantize_policy_np
    from nmf_tpu_torch.utils import metrics

    x, w, h, mask = problem()
    cfg = _config(nt, case)
    entry = CASES[case]["entry"]
    lines = []
    metrics.set_live_handler(lambda it, c, r: lines.append([it, c, r]))
    try:
        if entry == "indivisible":
            from nmf_tpu_torch.parallel.mesh import factor_shapes

            factor_shapes(M + 1, K, N, mesh)
        if entry in ("solve_pair", "solve_pair_rows"):
            xc = np.maximum(x, np.float32(cfg.eps))
            x = quantize_policy_np(xc, cfg.eps, 48 if entry == "solve_pair_rows" else 0)
        if entry in ("solve", "solve_pair", "solve_pair_rows"):
            res = nt.solve_sharded(x, w, h, cfg, mesh=mesh)
        elif entry == "masked":
            res = nt.solve_masked(x, w, h, mask, cfg, mesh=mesh)
        elif entry == "h_only":
            res = nt.solve_h_only(x, w, h, cfg, mesh=mesh)
        elif entry == "masked_h_only":
            res = nt.solve_masked_h_only(x, w, h, mask, cfg, mesh=mesh)
        elif entry == "w_only":
            res = nt.solve_w_only(x, w, h, cfg, mesh=mesh)
            res = nt.gather_result(res, mesh, w_spec=(nt.COL_AXIS, None),
                                   h_spec=(None, nt.ROW_AXIS))
        elif entry == "semi":
            res = nt.solve_semi(x, w, h, cfg, n_frozen=CASES[case]["n_frozen"], mesh=mesh)
        elif entry == "nmf":
            est = nt.NMF(n_components=8, init="random", max_iter=20, mesh=mesh)
            w_fit = est.fit_transform(x)
            return {"w": w_fit, "h": est.transform(x, max_iter=10),
                    "components": est.components_, "err": est.reconstruction_err_}, lines
        if entry != "w_only":
            res = nt.gather_result(res, mesh)
    finally:
        metrics.set_live_handler(None)
    return {
        "w": res.w.float().numpy(), "h": res.h.float().numpy(),
        "cost_history": res.cost_history.numpy(), "cost": float(res.cost),
        "iterations": int(res.iterations), "num_checks": int(res.num_checks),
        "converged": bool(res.converged),
    }, lines


def record_exit(out, rank):
    """The names of the native threads gloo still runs in this process
    (its transport loops, the process groups' workers; from ``/proc``) to
    ``OUT_DIR/exit.r<RANK>.json``: none once the groups are destroyed and
    the last mesh over them dropped."""
    names = (open(f"/proc/self/task/{t}/comm").read().strip()
             for t in os.listdir("/proc/self/task"))
    with open(os.path.join(out, f"exit.r{rank}.json"), "w") as f:
        json.dump({"gloo_threads": sorted(n for n in names if "gloo" in n)}, f)


def main(argv) -> int:
    rank, world, store, rows, cols, out = argv[1:7]
    rank, world, rows, cols = int(rank), int(world), int(rows), int(cols)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.parallel.mesh import shutdown

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    mesh = nt.make_mesh((rows, cols), device="cpu")
    for case in GROUPS[(rows, cols)]:
        info = {}
        try:
            arrays, lines = _run(nt, case, mesh)
            info = {"live": lines, **{k: v for k, v in arrays.items() if np.ndim(v) == 0}}
            if rank == 0:
                np.savez(os.path.join(out, f"{case}.npz"),
                         **{k: np.asarray(v) for k, v in arrays.items()})
        except (ValueError, NotImplementedError, TypeError) as e:
            info = {"error": type(e).__name__, "message": str(e)}
        with open(os.path.join(out, f"{case}.r{rank}.json"), "w") as f:
            json.dump(info, f)
    shutdown()
    del mesh        # the last reference to the mesh: its groups end here
    record_exit(out, rank)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
