#!/usr/bin/env python3
"""Check K1-K3 over a member axis on one NVIDIA card, briefly.

    python3 probe_batched.py          # from the root of a checkout, on the card

Each batched wrapper call (``nmf_tpu_torch.ops.kernels.fused_mu``) against
the 2-D call on each of its members, bit for bit: five shapes (config 4's
513 x 2000 K=32, K = 8, 64 and 300, and 65 x 129 x 17, whose members start
off 16 bytes), every precision mode, X per member and shared, K1/K2 in
full and ``numerator_only``, K3.  Then whether torch's f32 sums of a stack
(``torch.sum`` over a member axis) equal the sums of each member, the
launch in groups past ``gridDim.z``'s 65535 (130 members of 528 splits),
and config 4's calls (128 x 513 x 2000, K=32) timed with CUDA events
beside a loop of 128 2-D calls.  Prints the card's name and power limit;
exits 1 on a differing member.  A card is needed.
"""

import itertools
import subprocess
import sys

import torch

sys.path.insert(0, ".")
from nmf_tpu_torch.ops.kernels import fused_mu as fm  # noqa: E402
from nmf_tpu_torch.ops.quant import quantize_columns  # noqa: E402
from nmf_tpu_torch.utils.config import Precision  # noqa: E402

EPS = 2.2204e-16
# mode -> (Precision, state dtype, X storage)
MODES = {
    "f32": (Precision(), torch.float32, "f32"),
    "bfloat16": (Precision(matmul_dtype="bfloat16"), torch.float32, "f32"),
    "float32_fast": (Precision(matmul_dtype="float32_fast"), torch.float32, "f32"),
    "x_bfloat16": (Precision(x_dtype="bfloat16"), torch.float32, "bf16"),
    "x_int8": (Precision(x_dtype="int8"), torch.float32, "u8"),
    "bf16_state": (Precision("bfloat16", "bfloat16", "bfloat16"), torch.bfloat16, "f32"),
    "bf16_state_f32_gemm": (Precision(state_dtype="bfloat16"), torch.bfloat16, "f32"),
}
SHAPES = [(513, 2000, 32, 3), (100, 70, 8, 3), (333, 333, 64, 2), (257, 129, 300, 2),
          (65, 129, 17, 3)]   # M, N, K, members


def bits(t):
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)).cpu().numpy().tobytes()


def stack_x(xf, kind, shared):
    x = xf[0] if shared else xf
    if kind == "bf16":
        return x.to(torch.bfloat16)
    if kind == "u8":
        if shared:
            return quantize_columns(x, EPS)
        pairs = [quantize_columns(xi, EPS) for xi in xf]
        return tuple(torch.stack(t) for t in zip(*pairs))
    return x


def member_x(x, i, shared):
    if shared:
        return x
    return (x[0][i], x[1][i]) if isinstance(x, tuple) else x[i]


def member_checks(dev):
    calls = [("K1", fm.update_h_fused, {}), ("K2", fm.update_w_fused, {}),
             ("K1 numerator_only", fm.update_h_fused, {"numerator_only": True}),
             ("K2 numerator_only", fm.update_w_fused, {"numerator_only": True})]
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    for (m, n, k, b), (mode, (prec, sd, xk)) in itertools.product(SHAPES, MODES.items()):
        w = (torch.rand((b, m, k), generator=g, device=dev) + 0.1).to(sd)
        h = (torch.rand((b, k, n), generator=g, device=dev) + 0.1).to(sd)
        xf = torch.rand((b, m, n), generator=g, device=dev) + 1e-3
        for shared in (False, True):
            x = stack_x(xf, xk, shared)
            for name, fn, kw in calls:
                out = fn(w, h, x, precision=prec, **kw)
                for i in range(b):
                    one = fn(w[i].contiguous(), h[i].contiguous(), member_x(x, i, shared),
                             precision=prec, **kw)
                    results.append((bits(out[i]) == bits(one), (m, n, k, mode, shared, name, i)))
            out = fm.kl_cost_fused(x, w, h, precision=prec)
            for i in range(b):
                one = fm.kl_cost_fused(member_x(x, i, shared), w[i].contiguous(), h[i].contiguous(),
                                       precision=prec)
                results.append((bits(out[i]) == bits(one), (m, n, k, mode, shared, "K3", i)))
    return sum(eq for eq, _ in results), [case for eq, case in results if not eq]


def sum_orders(dev):
    for b, r, c in [(128, 513, 32), (16, 512, 32), (4, 4096, 128), (8, 512, 8), (3, 100, 8)]:
        w = torch.rand((b, r, c), device=dev)
        h = torch.rand((b, c, 4 * r), device=dev)
        col = bits(torch.sum(w, dim=-2, dtype=torch.float32)) == bits(
            torch.stack([torch.sum(w[i], dim=-2, dtype=torch.float32) for i in range(b)]))
        row = bits(torch.sum(h, dim=-1, dtype=torch.float32)) == bits(
            torch.stack([torch.sum(h[i], dim=-1, dtype=torch.float32) for i in range(b)]))
        print(f"torch.sum of a [{b}, {r}, {c}] stack equal to its members' sums: columns {col}, "
              f"rows (of [{b}, {c}, {4 * r}]) {row}")


def grouped(dev):
    m, n, k, b = 64 * 528, 64, 16, 130
    w = torch.rand((b, m, k), device=dev) + 0.1
    h = torch.rand((b, k, n), device=dev) + 0.1
    x = torch.rand((m, n), device=dev) + 1e-3
    out, c = fm.update_h_fused(w, h, x), fm.kl_cost_fused(x, w, h)
    return all(bits(out[i]) == bits(fm.update_h_fused(w[i], h[i], x))
               and bits(c[i]) == bits(fm.kl_cost_fused(x, w[i], h[i])) for i in (0, 1, 123, 124, 129))


def event_ms(fn, calls=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def config4_times(dev):
    b, m, n, k = 128, 513, 2000, 32
    w = torch.rand((b, m, k), device=dev) + 0.1
    h = torch.rand((b, k, n), device=dev) + 0.1
    x = torch.rand((b, m, n), device=dev) + 1e-3
    for prec in (Precision(), Precision(matmul_dtype="bfloat16")):
        print(f"config 4 ({b} x {m}x{n}, K={k}) {prec.matmul_dtype}: one batched call K1 "
              f"{event_ms(lambda: fm.update_h_fused(w, h, x, precision=prec))} ms, K2 "
              f"{event_ms(lambda: fm.update_w_fused(w, h, x, precision=prec))} ms, K3 "
              f"{event_ms(lambda: fm.kl_cost_fused(x, w, h, precision=prec))} ms; {b} 2-D K1 calls "
              f"{event_ms(lambda: [fm.update_h_fused(w[i], h[i], x[i], precision=prec) for i in range(b)], 2)} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_batched: no card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ok, bad = member_checks("cuda")
    print(f"members bit-equal to their 2-D call: {ok}, differing: {len(bad)}")
    for case in bad[:20]:
        print("differs:", case)
    sum_orders("cuda")
    group_ok = grouped("cuda")
    print(f"130 members of 528 splits (launched in groups): bit-equal {group_ok}")
    config4_times("cuda")
    return 0 if not bad and group_ok else 1


if __name__ == "__main__":
    sys.exit(main())
