"""K1-K3 over a member axis against ``jax.vmap`` of the Pallas kernels.

The port's wrappers take W ``[B, M, K]`` and H ``[B, K, N]`` with X per
member or shared (``in_axes=None``); on the CPU they run their plain
version member by member.  They are held here to ``jax.vmap`` of
``nmf_tpu.ops.pallas.fused_mu``'s ``update_h_fused``, ``update_w_fused``
and ``kl_cost_fused`` in interpret mode, per mode and X form, with
``tests/test_torch_precision.py``'s tolerances (f32-GEMM modes: rtol 1e-4
/ atol 1e-6, costs rel 1e-5; bf16 GEMMs rtol 2e-3; bf16 state one bf16
ulp more).  Each member is also held to the port's own 2-D call on that
member bit for bit (the CPU route of the 2-D wrapper), and the CUDA
operand checks of a batched call run on CPU tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from nmf_tpu.ops import quant as jq  # noqa: E402
from nmf_tpu.ops.pallas import fused_mu as jfm  # noqa: E402
from nmf_tpu.utils import config as jcfg  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils import config as tcfg  # noqa: E402

from oracle import clamp  # noqa: E402

EPS = np.float32(2.2204e-16)
F32_TOL = (1e-4, 1e-6, 1e-5)             # factors rtol, atol; cost rel
BF16_TOL = (2e-3, 1e-6, 1e-4)
BF16_STATE_TOL = (2.0 ** -7 + 2e-3, 1e-6, 1e-4)
BLOCKS = dict(interpret=True, block_m=32, block_n=128)
B, M, K, N = 3, 48, 8, 40

# mode -> (Precision fields, state bf16, X form, tolerance)
MODES = {
    "float32": (("float32", "float32", "float32"), False, "f32", F32_TOL),
    "bfloat16": (("bfloat16", "float32", "float32"), False, "f32", BF16_TOL),
    "float32_fast": (("float32_fast", "float32", "float32"), False, "f32", F32_TOL),
    "x_bfloat16": (("float32", "float32", "bfloat16"), False, "bf16", F32_TOL),
    "x_int8": (("float32", "float32", "int8"), False, "int8", F32_TOL),
    "bf16_full_state": (("bfloat16", "bfloat16", "bfloat16"), True, "bf16", BF16_STATE_TOL),
}
KERNELS = ("update_h", "update_w", "update_h_numerator", "update_w_numerator", "kl_cost")


@pytest.fixture(autouse=True)
def _zero_counts():
    tfm.reset_counts()
    yield
    tfm.reset_counts()


@pytest.fixture(scope="module")
def members():
    rng = np.random.RandomState(3)
    return (clamp(rng.rand(B, M, N).astype(np.float32)),
            clamp(rng.rand(B, M, K).astype(np.float32)),
            clamp(rng.rand(B, K, N).astype(np.float32)))


def _bf16_t(a):
    bits = np.asarray(a).astype(ml_dtypes.bfloat16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _operands(members, mode, shared):
    """(torch w, h, x) and (JAX w, h, x) of a mode; shared X is member 0's."""
    x, w, h = members
    if shared:
        x = x[0]
    _, state_bf16, xform, _ = MODES[mode]
    if state_bf16:
        wt, ht = _bf16_t(w), _bf16_t(h)
        wj, hj = jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(h).astype(jnp.bfloat16)
    else:
        wt, ht = torch.from_numpy(w), torch.from_numpy(h)
        wj, hj = jnp.asarray(w), jnp.asarray(h)
    if xform == "bf16":
        return (wt, ht, _bf16_t(x)), (wj, hj, jnp.asarray(x).astype(jnp.bfloat16))
    if xform == "int8":
        if shared:
            q, s = jq.quantize_columns_np(x, EPS)
        else:
            pairs = [jq.quantize_columns_np(xi, EPS) for xi in x]
            q, s = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
        return ((wt, ht, (torch.from_numpy(q), torch.from_numpy(s))),
                (wj, hj, (jnp.asarray(q), jnp.asarray(s))))
    return (wt, ht, torch.from_numpy(x)), (wj, hj, jnp.asarray(x))


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _ours(kernel, ops, prec):
    w, h, x = ops
    if kernel == "kl_cost":
        return tfm.kl_cost_fused(x, w, h, EPS, prec)
    fn = tfm.update_h_fused if kernel.startswith("update_h") else tfm.update_w_fused
    return fn(w, h, x, EPS, prec, numerator_only=kernel.endswith("_numerator"))


def _reference(kernel, ops, prec, shared):
    """``jax.vmap`` of the Pallas kernel, X's axis None when shared."""
    w, h, x = ops
    x_axis = None if shared else 0
    if kernel == "kl_cost":
        fn = lambda x_, w_, h_: jfm.kl_cost_fused(x_, w_, h_, EPS, prec, **BLOCKS)  # noqa: E731
        return jax.vmap(fn, in_axes=(x_axis, 0, 0))(x, w, h)
    pallas = jfm.update_h_fused if kernel.startswith("update_h") else jfm.update_w_fused
    num = kernel.endswith("_numerator")
    fn = lambda w_, h_, x_: pallas(w_, h_, x_, EPS, prec, numerator_only=num, **BLOCKS)  # noqa: E731
    return jax.vmap(fn, in_axes=(0, 0, x_axis))(w, h, x)


@pytest.mark.parametrize("shared", [False, True], ids=["per_member_x", "shared_x"])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mode", list(MODES))
def test_member_axis_matches_vmapped_pallas(members, mode, kernel, shared):
    """Each batched wrapper against ``jax.vmap`` of its Pallas kernel: shapes
    with the member axis in front, values within the mode's tolerance."""
    fields, _, _, tol = MODES[mode]
    ops_t, ops_j = _operands(members, mode, shared)
    ours = _ours(kernel, ops_t, tcfg.Precision(*fields))
    ref = np.asarray(_reference(kernel, ops_j, jcfg.Precision(*fields), shared)).astype(np.float32)
    assert tuple(ours.shape) == ref.shape
    if kernel == "kl_cost":
        assert ours.dtype == torch.float32 and ref.shape == (B,)
        np.testing.assert_allclose(_np(ours), ref, rtol=tol[2])
    else:
        np.testing.assert_allclose(_np(ours), ref, rtol=tol[0], atol=tol[1])


def _member_ops(ops, i, shared):
    w, h, x = ops
    if not shared:
        x = (x[0][i], x[1][i]) if isinstance(x, tuple) else x[i]
    return w[i], h[i], x


@pytest.mark.parametrize("shared", [False, True], ids=["per_member_x", "shared_x"])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mode", ["float32", "x_int8", "bf16_full_state"])
def test_member_is_the_2d_call(members, mode, kernel, shared):
    """Member i of a batched call has the bits of the 2-D call on member i."""
    fields = MODES[mode][0]
    prec = tcfg.Precision(*fields)
    ops, _ = _operands(members, mode, shared)
    out = _ours(kernel, ops, prec)
    for i in range(B):
        one = _ours(kernel, _member_ops(ops, i, shared), prec)
        assert torch.equal(out[i], one)


def test_cpu_route_counts_no_launch(members):
    """On CPU tensors the plain version runs: no launch, no member counted."""
    ops, _ = _operands(members, "float32", False)
    tfm.mu_step_fused(*ops)
    tfm.kl_cost_fused(ops[2], ops[0], ops[1])
    assert not any(tfm.LAUNCHES.values()) and not any(tfm.MEMBERS.values())


def test_reset_counts_clears_members():
    tfm.MEMBERS["update_h"] = 5
    tfm.reset_counts()
    assert tfm.MEMBERS == dict.fromkeys(tfm.MEMBERS, 0)


def _batched(w=(2, 10, 4), h=(2, 4, 12), x=(2, 10, 12), wdt=torch.float32, xdt=torch.float32):
    return torch.ones(w, dtype=wdt), torch.ones(h, dtype=wdt), torch.ones(x, dtype=xdt)


@pytest.mark.parametrize("x_shape,shared", [((2, 10, 12), False), ((10, 12), True)])
def test_batched_operand_check_reads_the_member_axis(x_shape, shared):
    """The CUDA route's operand check: (b, m, n, k, x, scales, shared)."""
    w, h, x = _batched(x=x_shape)
    b, m, n, k, xd, scales, got_shared = tfm._check_batched_operands(w, h, x)
    assert (b, m, n, k, scales, got_shared) == (2, 10, 12, 4, None, shared)


@pytest.mark.parametrize(
    "kw,scales,err,match",
    [
        (dict(x=(3, 10, 12)), None, ValueError, "shape mismatch"),
        (dict(h=(2, 5, 12)), None, ValueError, "shape mismatch"),
        (dict(x=(10, 13)), None, ValueError, "shape mismatch"),
        (dict(wdt=torch.float16), None, NotImplementedError, "both float32 or both bfloat16"),
        (dict(xdt=torch.float16), None, NotImplementedError, "x is torch.float16"),
        (dict(xdt=torch.uint8), (2, 3, 12), NotImplementedError, "per-row-block"),
        (dict(xdt=torch.uint8), (12,), ValueError, "scales must be float32 of shape"),
        (dict(xdt=torch.uint8, x=(10, 12)), (2, 12), NotImplementedError, "per-row-block"),
    ],
    ids=["members", "rank", "shared_shape", "state_dtype", "x_dtype", "rowblock_scales",
         "scale_shape", "shared_rowblock_scales"],
)
def test_batched_operand_check_refuses(kw, scales, err, match):
    w, h, x = _batched(**kw)
    if scales is not None:
        x = (x, torch.ones(scales))
    with pytest.raises(err, match=match):
        tfm._check_batched_operands(w, h, x)
