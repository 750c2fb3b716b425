"""Feature tour: precision tiers, quantized X, out-of-core, strict
replication, sparse X, live metrics, checkpoint/resume, selection,
serving, stability, online and semi-adaptive NMF.

Runs end-to-end on the card or the CPU; sizes are kept small so the whole
script finishes in seconds.

    python -m nmf_tpu_torch.examples.advanced_features [--device cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

import nmf_tpu_torch as nt

from ._common import host, parser, quick, sections


def _solved(res) -> dict:
    return {"cost": float(res.cost), "iterations": int(res.iterations),
            "num_checks": int(res.num_checks), "w": host(res.w), "h": host(res.h)}


def main(argv=None, section=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    section = sections(section)
    dev = args.device
    out = {}

    rng = np.random.RandomState(0)
    m, k, n = (128, 8, 200) if quick() else (256, 16, 400)
    x = rng.rand(m, n).astype(np.float32)
    w0 = rng.rand(m, k).astype(np.float32)
    h0 = rng.rand(k, n).astype(np.float32)

    with tempfile.TemporaryDirectory() as work:
        # --- precision tiers -------------------------------------------------
        # float32        : exact f32 GEMMs (reference parity)
        # float32_fast   : 3-pass bf16 split-float, ~1e-7-grade accuracy
        # bfloat16       : full-rate tensor cores
        out["tiers"] = {}
        for tier in ("float32", "float32_fast", "bfloat16"):
            with section(f"tier {tier}"):
                res = nt.solve(x, w0, h0, nt.SolveConfig(max_iter=50, precision=nt.Precision(tier)),
                               device=dev)
                out["tiers"][tier] = _solved(res)
            print(f"{tier:14s} cost {out['tiers'][tier]['cost']:.4f}")

        # --- quantized X storage (4x denser; opt-in, lossy) ------------------
        with section("int8"):
            res8 = nt.solve(x, w0, h0,
                            nt.SolveConfig(max_iter=50, precision=nt.Precision(x_dtype="int8")),
                            device=dev)
            out["int8"] = _solved(res8)
        print(f"{'int8 X':14s} cost {out['int8']['cost']:.4f}  (quantization-grade)")

        # --- live per-check metrics ------------------------------------------
        with section("live"):
            live = nt.solve(x, w0, h0,
                            nt.SolveConfig(max_iter=30, check_every=10, live_metrics=True),
                            device=dev)  # prints "[nmf] iter ... (live)" lines to stderr
            out["live"] = _solved(live)

        # --- out-of-core: X streamed from its .bin file ----------------------
        xpath = os.path.join(work, "X.bin")
        nt.write_matrix(x, xpath)
        with section("out_of_core"):
            res_ooc = nt.solve_out_of_core(
                xpath, w0, h0, nt.SolveConfig(max_iter=30, check_every=10), block_n=128,
                checkpoint_dir=os.path.join(work, "ck"),  # resumable
                device=dev,
            )
            out["out_of_core"] = _solved(res_ooc)
        with section("in_memory"):
            ref = nt.solve(x, w0, h0, nt.SolveConfig(max_iter=30, check_every=10), device=dev)
            out["in_memory"] = _solved(ref)
        print(f"{'out-of-core':14s} cost {out['out_of_core']['cost']:.4f}  "
              f"(in-memory: {out['in_memory']['cost']:.4f})")

        # accelerate=True composes: on this link-bound path fewer iterations
        # to a target cost means fewer streamed bytes
        with section("ooc_accel"):
            res_ooa = nt.solve_out_of_core(
                xpath, w0, h0, nt.SolveConfig(max_iter=30, check_every=10, accelerate=True),
                block_n=128, device=dev,
            )
            out["ooc_accel"] = _solved(res_ooa)
        print(f"{'ooc+accel':14s} cost {out['ooc_accel']['cost']:.4f}  "
              f"(<= plain streamed by the monotone safeguard)")

    # --- strict reference replication (padded-EPS numerics) -----------------
    with section("strict"):
        res_strict = nt.solve_strict(x, w0, h0, nt.SolveConfig(max_iter=30), device=dev)
        out["strict"] = _solved(res_strict)
    print(f"{'strict-compat':14s} cost {out['strict']['cost']:.4f}")

    # --- sparse X (memory ~ nnz; deprecated, warns) -------------------------
    xs = x.copy()
    xs[rng.rand(m, n) < 0.95] = 0.0
    with section("sparse"):
        res_sp = nt.solve_sparse(xs, w0, h0, nt.SolveConfig(max_iter=30), chunk=4096, device=dev)
        nnz = int(nt.sparse_from_dense(xs).data.shape[0])
        out["sparse"] = {**_solved(res_sp), "nnz": nnz}
    print(f"{'sparse (5%)':14s} cost {out['sparse']['cost']:.4f}  nnz={nnz}")

    # --- tile-sparse X (block-sparse; scales with occupied tiles) -----------
    xt = np.zeros((m, n), np.float32)
    xt[:128, :128] = x[:128, :128]          # clustered nonzeros: 2 occupied
    xt[128:256, 256:384] = x[128:256, 256:384]  # (128,128) tiles out of 8
    tx = nt.tiles_from_dense(xt, tile=(128, 128))
    with section("tile_sparse"):
        res_t = nt.solve_sparse_tiled(tx, w0, h0, nt.SolveConfig(max_iter=30), device=dev)
        out["tile_sparse"] = {**_solved(res_t), "occupancy": float(tx.occupancy()),
                              "tiles": int(tx.tiles.shape[0])}
    print(f"{'tile-sparse':14s} cost {out['tile_sparse']['cost']:.4f}  "
          f"occupancy={out['tile_sparse']['occupancy']:.2f} ({out['tile_sparse']['tiles']} tiles)")

    # --- HALS everywhere: a second solver family, orthogonal to parallelism -
    cfg_h = nt.SolveConfig(max_iter=30, beta=2.0, algorithm="hals")
    with section("hals"):
        res_h = nt.solve(x, w0, h0, cfg_h, device=dev)
        res_ho = nt.solve_out_of_core(x, w0, h0, cfg_h, block_n=128, device=dev)
        out["hals"] = {**_solved(res_h), "out_of_core": _solved(res_ho)}
    print(f"{'hals':14s} cost {out['hals']['cost']:.4f}  "
          f"(out-of-core: {out['hals']['out_of_core']['cost']:.4f}; also mesh-shardable)")

    # --- model selection: restarts + rank sweep, each one batched solve -----
    with section("restarts"):
        sel = nt.solve_restarts(x, rank=8, n_restarts=4, config=nt.SolveConfig(max_iter=30),
                                device=dev)
        out["restarts"] = {"costs": np.asarray(sel.costs, np.float32),
                           "best_index": int(sel.best_index)}
    print(f"{'restarts':14s} costs {[round(float(c), 2) for c in sel.costs]}  "
          f"kept #{sel.best_index}")
    with section("rank_sweep"):
        sweep = nt.solve_rank_sweep(x, [4, 8, 16], config=nt.SolveConfig(max_iter=30), device=dev)
        out["rank_sweep"] = {"ranks": [int(r) for r in sweep.ranks],
                             "costs": np.asarray(sweep.costs, np.float32)}
    print(f"{'rank sweep':14s} " +
          "  ".join(f"K={r}:{c:.2f}" for r, c in zip(sweep.ranks, sweep.costs)))

    # --- out-of-core transform: stream-once H-only inference ----------------
    # reuse the dictionary already learned above (`ref`): re-solving the
    # same problem would pay another 30 iterations for bitwise-equal W
    w_learned = out["in_memory"]["w"]
    with section("ooc_transform"):
        tr = nt.transform_out_of_core(x, w_learned, config=nt.SolveConfig(max_iter=30),
                                      block_n=128, device=dev)
        out["ooc_transform"] = {"cost": float(tr.cost), "blocks": len(tr.blocks),
                                "iterations": np.asarray(tr.iterations), "h": host(tr.h)}
    print(f"{'ooc transform':14s} cost {out['ooc_transform']['cost']:.4f}  "
          f"({out['ooc_transform']['blocks']} blocks, one X stream total)")

    # --- serving artifact: export once, serve anywhere ----------------------
    # one .nmfz packages the dictionary W and the SolveConfig; the H-only
    # solve is rebuilt from the config at load, so a serving process needs
    # only the file and the package
    with tempfile.TemporaryDirectory() as td:
        art = os.path.join(td, "model.nmfz")
        nt.save_transform(art, w_learned, n_block=64,
                          config=nt.SolveConfig(max_iter=30, backend="jnp"),
                          platforms=("cuda", "cpu"))
        with section("serving"):
            served = nt.load_transform(art, device=dev)(x[:, :100])  # 100 cols -> 2 blocks
            out["serving"] = {"cost": float(served.cost), "bytes": os.path.getsize(art),
                              "blocks": len(served.block_iterations), "h": served.h}
    print(f"{'serving':14s} cost {out['serving']['cost']:.4f}  "
          f"({out['serving']['bytes']} byte artifact, {out['serving']['blocks']} blocks)")

    # --- consensus-clustering rank selection (Brunet et al. 2004) -----------
    with section("stability"):
        stab = nt.rank_stability(x, ranks=[4, 8], n_restarts=2 if quick() else 6,
                                 config=nt.SolveConfig(max_iter=20 if quick() else 60), seed=1,
                                 device=dev)
        out["stability"] = {"ranks": [int(r) for r in stab.ranks],
                            "cophenetic": np.asarray(stab.cophenetic, np.float64)}
    print(f"{'stability':14s} " +
          "  ".join(f"K={r}:coph={c:.3f}" for r, c in zip(stab.ranks, stab.cophenetic)))

    # --- online NMF: one-pass streaming dictionary learning -----------------
    with section("online"):
        onl = nt.solve_online(x, w0, nt.SolveConfig(), block_n=128, inner_iters=15, passes=2,
                              device=dev)
        out["online"] = {"pass_costs": np.asarray([sum(p) for p in onl.block_costs]),
                         "w": host(onl.w)}
    print(f"{'online':14s} pass costs {[round(float(c), 1) for c in out['online']['pass_costs']]}"
          f"  (W learned in one stream/pass; rho<1 tracks drift)")

    # --- semi-adaptive NMF: frozen template columns (paper's drum workflow) -
    with section("semi"):
        semi = nt.solve_semi(x, w0, h0, nt.SolveConfig(max_iter=30), n_frozen=4, device=dev)
        w_semi = host(semi.w)
        frozen_ok = bool(np.all(w_semi[:, :4] == np.maximum(w0[:, :4], 2.2204e-16)))
        out["semi"] = {**_solved(semi), "frozen_ok": frozen_ok}
    print(f"{'semi-adaptive':14s} cost {out['semi']['cost']:.4f}  "
          f"(4 frozen template cols intact: {frozen_ok})")
    return out


if __name__ == "__main__":
    main()
