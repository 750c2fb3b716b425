"""Production serving pipeline: train once, export a `.nmfz` artifact,
score new data forever: in memory, streamed off disk, with missing-data
masks, and with host-quantized int8 inputs for link-bound deployments.

The reference's one application refits both factors per run; a production
deployment instead learns the dictionary W once and scores a stream of new
columns against it.  This example walks that whole lifecycle:

  1. learn W on training data (NNDSVD init, accelerated solver);
  2. `save_transform` -> a self-contained `.nmfz` (W + config: the H-only
     solve is rebuilt from the config at load, where `auto` picks the
     kernels or the plain ops for the serving device; serves on the card
     and on the CPU);
  3. serve new columns in memory and out-of-core (`stream_bin`);
  4. the quantized-input variant: the HOST quantizes each block, so the
     wire carries uint8 codes (~4x less: the lever when serving across a
     slow host<->device link), bit-identical results;
  5. masked serving for missing-data scoring, streamed mask included.

    python -m nmf_tpu_torch.examples.serving_pipeline [--device cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

import nmf_tpu_torch as nt
from nmf_tpu_torch.serving import load_transform, save_transform

from ._common import host, parser, quick, sections


def main(argv=None, section=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    section = sections(section)
    dev = args.device
    out = {}

    rng = np.random.RandomState(0)
    m, k = (96, 6) if quick() else (256, 16)
    n_train, n_serve = (160, 200) if quick() else (400, 1000)
    block = 64 if quick() else 200

    # ground-truth parts + noise so the learned dictionary means something
    w_true = rng.rand(m, k).astype(np.float32)
    x_train = (w_true @ rng.rand(k, n_train) + 0.01 * rng.rand(m, n_train)).astype(np.float32)

    # --- 1. train the dictionary once ---------------------------------------
    with section("train"):
        w0, h0 = nt.nndsvd_init(x_train, k, variant="nndsvda")
        fit = nt.solve(x_train, w0, h0,
                       nt.SolveConfig(max_iter=60 if quick() else 200, check_every=20,
                                      accelerate=True),
                       device=dev)
        w = host(fit.w)
        out["train"] = {"cost": float(fit.cost), "iterations": int(fit.iterations),
                        "num_checks": int(fit.num_checks), "w": w}
    print(f"trained: {m}x{k} dictionary, cost {out['train']['cost']:.4f}, "
          f"{out['train']['iterations']} iterations")

    with tempfile.TemporaryDirectory() as d:
        # --- 2. export the serving artifact ---------------------------------
        art = os.path.join(d, "model.nmfz")
        save_transform(art, w, n_block=block, config=nt.SolveConfig(max_iter=30, check_every=30),
                       platforms=("cuda", "cpu"))
        out["export"] = {"bytes": os.path.getsize(art)}
        print(f"exported {out['export']['bytes']} bytes "
              f"(W + config; the H-only solve is rebuilt at load, self-contained)")

        # --- 3. serve new data: in memory and streamed off disk -------------
        x_new = (w_true @ rng.rand(k, n_serve) + 0.01 * rng.rand(m, n_serve)).astype(np.float32)
        with section("serve"):
            t = load_transform(art, device=dev)    # `auto` resolved here, for the block
            res = t(x_new)  # any column count; blocks of `block`, tail padded
            out["serve"] = {"blocks": len(res.block_iterations), "cost": float(res.cost),
                            "block_iterations": res.block_iterations, "h": res.h}
        print(f"served {n_serve} columns in {out['serve']['blocks']} blocks, "
              f"total cost {out['serve']['cost']:.4f}")

        xp = os.path.join(d, "X_new.bin")
        nt.write_matrix(x_new, xp)
        hp = os.path.join(d, "H_new.bin")
        with section("stream"):
            t.stream_bin(xp, out_path=hp)  # constant host memory at any N
            streamed = nt.read_matrix(hp)
            out["stream"] = {"bitwise": bool(np.array_equal(streamed, res.h)), "h": streamed}
        assert out["stream"]["bitwise"], "the streamed serve differs from the in-memory call"
        print("streamed serve (disk -> disk) matches the in-memory call bitwise")

        # --- 4. quantized-input serving (int8 wire) -------------------------
        qart = os.path.join(d, "model_q.nmfz")
        save_transform(qart, w, n_block=block,
                       config=nt.SolveConfig(max_iter=30, check_every=30,
                                             precision=nt.Precision(x_dtype="int8")),
                       platforms=("cuda", "cpu"), quantized_input=True)
        with section("quantized"):
            tq = load_transform(qart, device=dev)
            resq = tq(x_new)  # each block host-quantizes; uint8 codes ride the link
            out["quantized"] = {"cost": float(resq.cost),
                                "block_iterations": resq.block_iterations, "h": resq.h}
        print(f"quantized-input serve: total cost {out['quantized']['cost']:.4f} "
              f"(wire payload ~4x smaller; bit-identical to the in-program-"
              f"quantization artifact)")

        # --- 5. masked serving: score only the observed entries -------------
        mask = (rng.rand(m, n_serve) > 0.3).astype(np.float32)
        x_holes = x_new.copy()
        x_holes[mask == 0] = np.nan  # unobserved entries may be garbage, incl. NaN
        mart = os.path.join(d, "model_masked.nmfz")
        save_transform(mart, w, n_block=block, config=nt.SolveConfig(max_iter=30, check_every=30),
                       platforms=("cuda", "cpu"), masked=True)
        with section("masked"):
            tm = load_transform(mart, device=dev)
            resm = tm(x_holes, mask=mask)
            out["masked"] = {"cost": float(resm.cost), "finite": bool(np.isfinite(resm.h).all()),
                             "h": resm.h}
        print(f"masked serve (30% missing, garbage holes): "
              f"cost {out['masked']['cost']:.4f}, finite={out['masked']['finite']}")

        # ...and streamed: the mask .bin's column blocks ride alongside X's
        mp = os.path.join(d, "mask.bin")
        xh = os.path.join(d, "X_holes.bin")
        nt.write_matrix(np.nan_to_num(x_holes), xh)  # zeroed holes; the solve
        # zeroes everything under mask==0 anyway, so the two encodings agree
        nt.write_matrix(mask, mp)
        hm = os.path.join(d, "H_masked.bin")
        with section("masked_stream"):
            tm.stream_bin(xh, out_path=hm, mask_path=mp)
            out["masked_stream"] = {"h": nt.read_matrix(hm)}
        print("masked streamed serve wrote", os.path.basename(hm))

    print("serving pipeline complete")
    return out


if __name__ == "__main__":
    main()
