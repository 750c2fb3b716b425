"""One rank of a CPU mesh for ``tests/test_torch_mesh_paths.py`` (not collected).

    python tests/torch_mesh_paths_ranks.py RANK WORLD STORE ROWS COLS OUT_DIR

joins a gloo group of WORLD processes through ``file://STORE``, builds the
ROWS x COLS mesh of ``nmf_tpu_torch`` on the CPU and runs every case of
``GROUPS[(ROWS, COLS)]``: the streamed, transform, online, batched,
selection, tiled and checkpointed solves on a mesh, on the problem of
:func:`problem` (``RandomState(5)``, 48 x 6 x 96).  Rank 0 writes each
case's result to ``OUT_DIR/<case>.npz``; every rank writes its scalars and
any error to ``OUT_DIR/<case>.r<RANK>.json``.  The rank leaves through
``nmf_tpu_torch.parallel.mesh.shutdown``, drops its mesh, records the gloo
threads still alive (``torch_mesh_ranks.record_exit``) and exits normally.  Imports
torch, NumPy and ``nmf_tpu_torch`` only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

M, K, N = 48, 6, 96
BLOCK_N = 40            # streamed blocks 40, 40, 16: every width divides 1, 2 and 4 columns
BASE = dict(max_iter=20, check_every=5)
TILE = (8, 8)
BATCH = 8               # members of the batched solves
# case -> the entry point it drives and its config (SolveConfig fields;
# "precision" as Precision fields) and the entry's own arguments under "args"
CASES = {
    "ooc_kl": dict(entry="ooc"),
    "ooc_kl_pallas": dict(entry="ooc", backend="pallas"),
    "ooc_beta2": dict(entry="ooc", beta=2.0),
    "ooc_reg": dict(entry="ooc", l1_w=0.01, l1_h=0.02, l2_w=0.05, l2_h=0.03),
    "ooc_hals": dict(entry="ooc", beta=2.0, algorithm="hals"),
    "ooc_masked": dict(entry="ooc_masked", l1_h=0.02),
    "ooc_int8": dict(entry="ooc", precision=dict(x_dtype="int8")),
    "ooc_int8_rows": dict(entry="ooc", precision=dict(x_dtype="int8", x_quant_rows=12)),
    "ooc_bf16": dict(entry="ooc", precision=dict(x_dtype="bfloat16")),
    "ooc_accel": dict(entry="ooc", accelerate=True),
    "ooc_frozen": dict(entry="ooc", args=dict(n_frozen=2)),
    "ooc_live": dict(entry="ooc", live_metrics=True),
    "ooc_resume": dict(entry="ooc_resume"),
    "ooc_resume_accel": dict(entry="ooc_resume", accelerate=True),
    "ooc_indivisible": dict(entry="ooc_indivisible"),
    "tr_ooc": dict(entry="tr_ooc"),
    "tr_ooc_masked": dict(entry="tr_ooc_masked"),
    "tr_ooc_int8": dict(entry="tr_ooc", precision=dict(x_dtype="int8")),
    "nmf_tr_ooc": dict(entry="nmf_tr_ooc"),
    "online": dict(entry="online"),
    "online_int8": dict(entry="online", precision=dict(x_dtype="int8")),
    "online_block": dict(entry="online", args=dict(block_n=42)),
    "batched": dict(entry="batched"),
    "batched_pallas": dict(entry="batched", backend="pallas"),
    "batched_thresh": dict(entry="batched", max_iter=400, thresh=1e-4, check_every=10),
    "batched_indivisible": dict(entry="batched", args=dict(batch=6)),
    "restarts": dict(entry="restarts"),
    "restarts_indivisible": dict(entry="restarts", args=dict(n_restarts=3)),
    "rank_sweep": dict(entry="rank_sweep"),
    "stability": dict(entry="stability"),
    "nmf_restarts": dict(entry="nmf_restarts"),
    "tiled": dict(entry="tiled"),
    "tiled_int8": dict(entry="tiled", precision=dict(x_dtype="int8")),
    "tiled_accel": dict(entry="tiled", accelerate=True),
    "tiled_pallas": dict(entry="tiled", backend="pallas"),
    "ckpt": dict(entry="ckpt"),
    "ckpt_accel": dict(entry="ckpt", accelerate=True),
    "ckpt_sharded": dict(entry="ckpt", args=dict(sharded=True)),
    "ckpt_sharded_accel": dict(entry="ckpt", accelerate=True, args=dict(sharded=True)),
    "ckpt_tiled": dict(entry="ckpt_tiled"),
    "ckpt_other_mesh": dict(entry="ckpt_other_mesh"),
}
_EVERY = ["ooc_kl", "ooc_kl_pallas", "tr_ooc", "online", "batched", "restarts", "tiled", "ckpt",
          "ckpt_sharded"]
GROUPS = {
    (1, 1): _EVERY + ["ooc_resume", "nmf_restarts"],
    (2, 1): _EVERY + ["ooc_masked", "ooc_int8_rows", "rank_sweep", "restarts_indivisible"],
    (1, 2): _EVERY + ["ooc_hals", "tr_ooc_masked", "online_int8", "batched_pallas",
                      "tiled_int8"],
    (2, 2): list(CASES),
    (4, 1): _EVERY + ["ooc_beta2", "ooc_int8", "batched_indivisible", "stability",
                      "ooc_indivisible"],
    (1, 4): _EVERY + ["ooc_reg", "online_block", "tr_ooc_int8", "nmf_tr_ooc"],
}


def problem():
    rng = np.random.RandomState(5)
    x = rng.rand(M, N).astype(np.float32)
    w = rng.rand(M, K).astype(np.float32)
    h = rng.rand(K, N).astype(np.float32)
    mask = (np.random.RandomState(9).rand(M, N) > 0.3).astype(np.float32)
    return x, w, h, mask


def tiled_problem():
    """X with about a third of its 8 x 8 tiles occupied, as a dense array."""
    rng = np.random.RandomState(6)
    x = rng.rand(M, N).astype(np.float32)
    keep = rng.rand(M // TILE[0], N // TILE[1]) < 0.35
    keep[0, 0] = keep[-1, -1] = True
    return x * np.kron(keep, np.ones(TILE)).astype(np.float32)


def batch_problem(b=BATCH):
    rng = np.random.RandomState(8)
    return (rng.rand(b, 24, 32).astype(np.float32), rng.rand(b, 24, 4).astype(np.float32),
            rng.rand(b, 4, 32).astype(np.float32))


def config_kwargs(case: str) -> dict:
    """The case's SolveConfig fields (``precision`` as a dict), over BASE."""
    spec = {k: v for k, v in CASES[case].items() if k not in ("entry", "args")}
    return {**BASE, **spec}


def args_of(case: str) -> dict:
    return dict(CASES[case].get("args", {}))


def _config(nt, case):
    kw = config_kwargs(case)
    kw["precision"] = nt.Precision(**kw.get("precision", {}))
    return nt.SolveConfig(**kw)


def _solve_dict(res):
    return {"w": res.w.float().cpu().numpy(), "h": res.h.float().cpu().numpy(),
            "cost_history": res.cost_history.cpu().numpy(), "cost": float(res.cost),
            "iterations": int(res.iterations), "num_checks": int(res.num_checks),
            "converged": bool(res.converged)}


def _bits_equal(a: dict, b: dict) -> bool:
    return all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


def _state_dict(st):
    out = {"w": np.asarray(st.w), "h": np.asarray(st.h), "iteration": st.iteration,
           "cost_history": np.asarray(st.cost_history, np.float64)}
    if st.w_ex is not None:
        out.update(w_ex=np.asarray(st.w_ex), h_ex=np.asarray(st.h_ex))
    return out


def _run(nt, case, mesh, tmp):
    """(result arrays, extra scalars, live lines) of one case on this rank."""
    import torch

    from nmf_tpu_torch.parallel.mesh import BOTH, Placement, gather
    from nmf_tpu_torch.utils import checkpoint as ck
    from nmf_tpu_torch.utils import metrics

    x, w, h, mask = problem()
    cfg = _config(nt, case)
    entry, a = CASES[case]["entry"], args_of(case)
    lines = []
    metrics.set_live_handler(lambda it, c, r: lines.append([it, c, r]))
    try:
        if entry == "ooc":
            res = nt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK_N, mesh=mesh, **a)
            return _solve_dict(res), {}, lines
        if entry == "ooc_masked":
            res = nt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK_N, mesh=mesh, mask=mask)
            return _solve_dict(res), {}, lines
        if entry == "ooc_indivisible":
            nt.solve_out_of_core(x[:M - 1], w[:M - 1], h, cfg, block_n=BLOCK_N, mesh=mesh)
        if entry == "ooc_resume":
            # a run checkpointed at 10 and resumed to 20, against the
            # uninterrupted mesh run: bit for bit
            whole = _solve_dict(nt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK_N, mesh=mesh))
            d = os.path.join(tmp, case)
            first = dataclasses.replace(cfg, max_iter=10)
            nt.solve_out_of_core(x, w, h, first, block_n=BLOCK_N, mesh=mesh,
                                 checkpoint_dir=d, checkpoint_every=5)
            res = _solve_dict(nt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK_N, mesh=mesh,
                                                   checkpoint_dir=d, checkpoint_every=5))
            return res, {"bitwise": _bits_equal(res, whole)}, lines
        if entry in ("tr_ooc", "tr_ooc_masked"):
            tr = nt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK_N, mesh=mesh, seed=3,
                                          mask=mask if entry == "tr_ooc_masked" else None)
            return ({"h": tr.h, "block_costs": tr.block_costs, "iterations": tr.iterations},
                    {"cost": tr.cost}, lines)
        if entry == "nmf_tr_ooc":
            est = nt.NMF(n_components=K, init="random", max_iter=20, mesh=mesh).fit(x)
            return {"h": est.transform(x, out_of_core=True), "w": est.w_}, {}, lines
        if entry == "online":
            res = nt.solve_online(x, w, cfg, block_n=a.get("block_n", BLOCK_N), inner_iters=5,
                                  passes=2, seed=4, mesh=mesh)
            return {"w": res.w, "curve": res.learning_curve}, {}, lines
        if entry == "batched":
            xs, ws, hs = batch_problem(a.get("batch", BATCH))
            res = nt.solve_batched(xs, ws, hs, cfg, mesh=mesh)
            full = nt.gather_result(res, mesh, w_spec=(BOTH, None, None),
                                    h_spec=(BOTH, None, None))
            out = {"w": full.w.numpy(), "h": full.h.numpy(), "cost": full.cost.numpy(),
                   "cost_history": full.cost_history.numpy(),
                   "iterations": full.iterations.numpy(), "converged": full.converged.numpy()}
            return out, {"local_members": int(res.w.shape[0])}, lines
        if entry == "restarts":
            sel = nt.solve_restarts(x, rank=K, n_restarts=a.get("n_restarts", 4), config=cfg,
                                    seed=2, mesh=mesh)
            return ({"costs": sel.costs, "iterations": sel.iterations, "w": sel.best[0].numpy(),
                     "h": sel.best[1].numpy()}, {"best": sel.best_index}, lines)
        if entry == "rank_sweep":
            sel = nt.solve_rank_sweep(x, [2, 3, 4, 5], cfg, seed=2, mesh=mesh)
            return ({"costs": sel.costs, "w": sel.results.w.numpy(),
                     "h": sel.results.h.numpy()}, {}, lines)
        if entry == "stability":
            st = nt.rank_stability(x, [2, 3], n_restarts=2, config=cfg, seed=1, mesh=mesh)
            return ({"cophenetic": st.cophenetic, "dispersion": st.dispersion,
                     "costs": st.sweep.costs}, {"best_rank": int(st.best_rank())}, lines)
        if entry == "nmf_restarts":
            est = nt.NMF(n_components=K, n_restarts=4, init="random", max_iter=20, mesh=mesh)
            return {"w": est.fit_transform(x), "h": est.components_}, {
                "err": float(est.reconstruction_err_)}, lines
        if entry == "tiled":
            tx = nt.tiles_from_dense(tiled_problem(), TILE)
            res = nt.solve_sparse_tiled(tx, w, h, cfg, tile=TILE, mesh=mesh)
            out = _solve_dict(nt.gather_result(res, mesh))
            out["w"], out["h"] = out["w"][:M], out["h"][:, :N]
            return out, {}, lines
        if entry == "ckpt":
            sharded = a.get("sharded", False)
            d1, d2 = os.path.join(tmp, case + "_whole"), os.path.join(tmp, case + "_parts")
            whole = ck.solve_with_checkpoints(x, w, h, cfg, d1, every=10, mesh=mesh,
                                              sharded_checkpoints=sharded)
            ck.solve_with_checkpoints(x, w, h, dataclasses.replace(cfg, max_iter=10), d2,
                                      every=10, mesh=mesh, sharded_checkpoints=sharded)
            again = ck.solve_with_checkpoints(x, w, h, cfg, d2, every=10, mesh=mesh,
                                              sharded_checkpoints=sharded)
            out = _state_dict(whole)
            if sharded:     # this rank's blocks: gathered here for the comparison
                dev = torch.device("cpu")
                out["w"] = gather(torch.from_numpy(out["w"]).to(dev),
                                  Placement(mesh, ("mr", None))).numpy()
                out["h"] = gather(torch.from_numpy(out["h"]).to(dev),
                                  Placement(mesh, (None, "mc"))).numpy()
                for key in ("w_ex", "h_ex"):
                    out.pop(key, None)
            steps = sorted(os.listdir(d2))
            return out, {"bitwise": _bits_equal(_state_dict(again), _state_dict(whole)),
                         "steps": steps}, lines
        if entry == "ckpt_tiled":
            tx = nt.tiles_from_dense(tiled_problem(), TILE)
            d1, d2 = os.path.join(tmp, case + "_whole"), os.path.join(tmp, case + "_parts")
            whole = ck.solve_with_checkpoints(tx, w, h, cfg, d1, every=10, mesh=mesh)
            ck.solve_with_checkpoints(tx, w, h, dataclasses.replace(cfg, max_iter=10), d2,
                                      every=10, mesh=mesh)
            again = ck.solve_with_checkpoints(tx, w, h, cfg, d2, every=10, mesh=mesh)
            return _state_dict(whole), {
                "bitwise": _bits_equal(_state_dict(again), _state_dict(whole))}, lines
        if entry == "ckpt_other_mesh":
            d = os.path.join(tmp, case)
            ck.solve_with_checkpoints(x, w, h, dataclasses.replace(cfg, max_iter=10), d,
                                      every=10, mesh=mesh, sharded_checkpoints=True)
            other = nt.make_mesh((1, 4), device="cpu")
            ck.solve_with_checkpoints(x, w, h, cfg, d, every=10, mesh=other,
                                      sharded_checkpoints=True)
        raise AssertionError(f"case {case} returned nothing")
    finally:
        metrics.set_live_handler(None)


def main(argv) -> int:
    rank, world, store, rows, cols, out = argv[1:7]
    rank, world, rows, cols = int(rank), int(world), int(rows), int(cols)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.parallel.mesh import shutdown
    from torch_mesh_ranks import record_exit

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    mesh = nt.make_mesh((rows, cols), device="cpu")
    # one scratch directory for the group's checkpoints, shared by its ranks
    tmp = os.path.join(out, "ckpt")
    os.makedirs(tmp, exist_ok=True)
    for case in GROUPS[(rows, cols)]:
        info = {}
        try:
            arrays, extra, lines = _run(nt, case, mesh, tmp)
            info = {"live": lines, **extra,
                    **{k: v for k, v in arrays.items() if np.ndim(v) == 0}}
            if rank == 0:
                np.savez(os.path.join(out, f"{case}.npz"),
                         **{k: np.asarray(v) for k, v in arrays.items()})
        except (ValueError, NotImplementedError, TypeError) as e:
            info = {"error": type(e).__name__, "message": str(e)}
        with open(os.path.join(out, f"{case}.r{rank}.json"), "w") as f:
            json.dump(info, f, default=lambda v: v.tolist() if hasattr(v, "tolist") else str(v))
    shutdown()
    del mesh        # the last reference to the mesh: its groups end here
    record_exit(out, rank)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
