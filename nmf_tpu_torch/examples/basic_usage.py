"""Basic usage: factorize a matrix, reference-compatible end to end.

    python -m nmf_tpu_torch.examples.basic_usage               # on the card
    python -m nmf_tpu_torch.examples.basic_usage --device cpu
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

import nmf_tpu_torch as nt

from ._common import host, parser, quick, sections


def main(argv=None, section=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--out-dir", default=None,
                    help="where Wout.bin and Hout.bin go (default: the temporary directory)")
    args = ap.parse_args(argv)
    section = sections(section)
    dev = args.device
    out = {}

    # A random low-rank-ish problem (or read your own .bin files with
    # nt.read_matrix: the format is byte-compatible with the CUDA tools).
    rng = np.random.RandomState(0)
    m, k, n = (256, 16, 200) if quick() else (2048, 64, 1024)
    iters = 30 if quick() else 200
    x = rng.rand(m, n).astype(np.float32)

    # Option A: bring your own init (the reference pipeline)
    w0, h0 = rng.rand(m, k).astype(np.float32), rng.rand(k, n).astype(np.float32)
    with section("A"):
        res = nt.solve(x, w0, h0, nt.SolveConfig(max_iter=iters, thresh=1e-4, check_every=25),
                       device=dev)
        out["A"] = {"iterations": int(res.iterations), "num_checks": int(res.num_checks),
                    "converged": bool(res.converged), "cost": float(res.cost),
                    "w": host(res.w), "h": host(res.h)}
    print(f"A: {out['A']['iterations']} iterations, converged={out['A']['converged']}, "
          f"KL cost {out['A']['cost']:.4e}")

    # Option B: the estimator API with NNDSVD init
    with section("B"):
        model = nt.NMF(n_components=k, init="nndsvda", max_iter=iters, tol=1e-4, device=dev)
        w = model.fit_transform(x)
        out["B"] = {"iterations": model.n_iter_, "cost": model.reconstruction_err_,
                    "w": w, "h": model.components_}
    print(f"B: {model.n_iter_} iterations, KL cost {model.reconstruction_err_:.4e}")

    # project new data onto the learned dictionary (H-only solve)
    x_new = rng.rand(m, 100).astype(np.float32)
    with section("transform"):
        h_new = model.transform(x_new)
        out["transform"] = {"h": h_new}
    print(f"   transform: H_new {h_new.shape}")

    # write results in the reference .bin format
    d = args.out_dir or tempfile.gettempdir()
    paths = [os.path.join(d, "Wout.bin"), os.path.join(d, "Hout.bin")]
    nt.write_matrix(out["A"]["w"], paths[0])
    nt.write_matrix(out["A"]["h"], paths[1])
    out["write"] = {"paths": paths}
    print(f"   wrote {paths[0]} {paths[1]}")
    return out


if __name__ == "__main__":
    main()
