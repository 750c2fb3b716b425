#!/usr/bin/env python3
"""Digest the kernel results of ``chip_smoke.py``'s checks, to hold two trees
of the port to each other bit for bit on one card.

    python3 kernel_digest.py --root PATH --out A.json   # nmf_tpu_torch under PATH
    python3 kernel_digest.py --compare A.json B.json    # exit 1 where they differ
    python3 kernel_digest.py --compare A.json B.json --changed kl_cost

With ``--root``, runs phases 2, 3, 8 and 9a of the ``chip_smoke.py`` beside
this file (its shapes, modes and operands, its plain-version checks; no
timing), importing ``nmf_tpu_torch`` and building its kernels from PATH,
and records the SHA-256 of every kernel result by the check that computed
it; then K1-K3 once at the 10240^2 K=256 flagship under each GEMM
policy (phase 7's operands), and the extrapolation kernel at phase 10a's
gate (each carry it wrote; a tree without it records none: compare with
``--changed extrapolate``).  Two trees give equal digests exactly where
their kernels give equal bits.  ``--compare`` counts equal, differing and
unmatched checks per kernel (the kernel named in each check); with
``--changed``, only the kernels named there may differ or be unmatched.
"""

import argparse
import hashlib
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_digest", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import nmf_tpu_torch as nt

    pkg = pathlib.Path(nt.__file__).resolve()
    if root.resolve() not in pkg.parents:
        raise SystemExit(f"nmf_tpu_torch came from {pkg}, not from {root}")
    smoke = _load_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    digests = {}

    def record(where, t):
        key, i = where, 1
        while key in digests:
            i += 1
            key = f"{where} #{i}"
        digests[key] = hashlib.sha256(smoke._bits(t.contiguous()).cpu().numpy().tobytes()).hexdigest()

    run_pair = smoke._run_pair

    def recording_pair(kern, plain, w, h, x, where):
        out, ref = run_pair(kern, plain, w, h, x, where)
        record(where, out)
        return out, ref

    smoke._run_pair = recording_pair
    smoke.timed_pair = lambda *a, **k: (0.0, 0.0)
    smoke.graph_ms = lambda *a, **k: 0.0
    card = smoke.card_name_and_limit()
    out = {"kernels": {name: {"max_abs_err": 0.0, "modes": {}, "flagship": {}, "long_walks": {}}
                       for name, _, _ in smoke.KERNELS}}
    smoke.phase_kernels(card, out)
    smoke.phase_modes(card, out)
    smoke.phase_tilesparse_kernels(card, out)
    smoke.phase_numerators(card, out)
    g = torch.Generator(device="cuda").manual_seed(0)
    x, w, h = (torch.rand(s, generator=g, device="cuda")
               for s in ((10240, 10240), (10240, 256), (256, 10240)))
    for dtype in ("float32", "bfloat16", "float32_fast"):
        for name, (kern, _) in smoke._pairs(nt.Precision(dtype)).items():
            record(f"flagship {name} [{dtype}]", kern(w, h, x))
    torch.cuda.synchronize()
    if hasattr(smoke, "_check_extrapolation"):
        from nmf_tpu_torch.ops.kernels import fused_mu

        extrapolate_into = fused_mu.extrapolate_into

        def recording_extrapolate(pairs, m, eps):
            extrapolate_into(pairs, m, eps)
            for i, (_, _, ex) in enumerate(pairs):
                record(f"extrapolate {ex.dtype} {tuple(ex.shape)} pair {i}", ex)

        fused_mu.extrapolate_into = recording_extrapolate
        out["kernels"]["extrapolate"] = {"max_abs_err": 0.0, "modes": {}}
        smoke._check_extrapolation(card, out)
        fused_mu.extrapolate_into = extrapolate_into
    return {"card": card, "digests": digests}


KERNEL_NAMES = ("update_h", "update_w", "kl_cost", "h_numerator", "w_numerator", "extrapolate")


def kernel_of(check):
    """The kernel a check's name names (its first word among KERNEL_NAMES),
    or "?"."""
    return next((w for w in check.replace("[", " ").split() if w in KERNEL_NAMES), "?")


def compare(a_path, b_path, changed=()) -> int:
    a, b = (json.loads(pathlib.Path(p).read_text())["digests"] for p in (a_path, b_path))
    same = [k for k in a if b.get(k) == a[k]]
    differ = [k for k in a if k in b and b[k] != a[k]]
    only = sorted(set(a) ^ set(b))
    for k in differ:
        print(f"differs: {k}")
    for k in only:
        print(f"in one file only: {k}")
    by_kernel = {}
    for what, keys in (("equal", same), ("differ", differ), ("unmatched", only)):
        for k in keys:
            counts = by_kernel.setdefault(kernel_of(k), {"equal": 0, "differ": 0, "unmatched": 0})
            counts[what] += 1
    print(json.dumps({"equal": len(same), "differ": len(differ), "unmatched": len(only),
                      "by_kernel": by_kernel, "changed": list(changed)}))
    return 1 if any(kernel_of(k) not in changed for k in (*differ, *only)) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, help="tree whose nmf_tpu_torch to digest")
    ap.add_argument("--out", type=pathlib.Path, help="JSON file of the digests")
    ap.add_argument("--compare", nargs=2, metavar="JSON", help="two digest files to compare")
    ap.add_argument("--changed", nargs="*", default=(), choices=KERNEL_NAMES,
                    help="kernels whose results may differ between the two files")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare, changed=tuple(args.changed))
    if not (args.root and args.out):
        ap.error("give --root and --out, or --compare")
    import torch

    if not torch.cuda.is_available():
        print("kernel_digest: no card", file=sys.stderr)
        return 1
    args.out.write_text(json.dumps(digest(args.root), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
