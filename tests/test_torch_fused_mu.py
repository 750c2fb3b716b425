"""The port's kernel wrappers (``ops/kernels/fused_mu``) against the JAX
Pallas kernels in interpret mode, the cases of ``tests/test_pallas.py``.

On the CPU a wrapper takes its plain version, so these tests hold the plain
path and the wrapper's dispatch to the TPU kernels' results; the CUDA
kernels themselves are held to the plain versions on the card by
``chip_smoke.py``.  Tolerances are those of ``tests/test_pallas.py``:
factors rtol 1e-5 / atol 1e-7 against the kernel epilogue ``h * acc / sum``
(the plain path computes ``h * (acc / sum)``), costs rel 1e-5.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from nmf_tpu.ops.pallas import fused_mu as jfm  # noqa: E402
from nmf_tpu.utils import config as jcfg  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.config import Precision  # noqa: E402

from oracle import clamp  # noqa: E402

RTOL, ATOL, COST_RTOL = 1e-5, 1e-7, 1e-5
BLOCKS = dict(interpret=True, block_m=32, block_n=128)


@pytest.fixture(autouse=True)
def _zero_counts():
    tfm.reset_counts()
    yield
    tfm.reset_counts()


def _problem(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = clamp(rng.rand(m, n).astype(np.float32))
    w = clamp(rng.rand(m, k).astype(np.float32))
    h = clamp(rng.rand(k, n).astype(np.float32))
    return x, w, h


@pytest.fixture(scope="module")
def problem():
    return _problem(96, 12, 130, 7)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_update_h_fused_matches_pallas(problem):
    x, w, h = problem
    ours = tfm.update_h_fused(*_t(w, h, x)).numpy()
    ref = np.asarray(jfm.update_h_fused(*_j(w, h, x), **BLOCKS))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_update_w_fused_matches_pallas(problem):
    x, w, h = problem
    ours = tfm.update_w_fused(*_t(w, h, x)).numpy()
    ref = np.asarray(jfm.update_w_fused(*_j(w, h, x), **BLOCKS))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_mu_step_fused_multi_iter(problem):
    x, w, h = problem
    wt, ht, xt = _t(w, h, x)
    wj, hj, xj = _j(w, h, x)
    for _ in range(3):
        wt, ht = tfm.mu_step_fused(wt, ht, xt)
        wj, hj = jfm.mu_step_fused(wj, hj, xj, interpret=True)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=5e-5, atol=ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=5e-5, atol=ATOL)


@pytest.mark.parametrize(
    "m,k,n,bm,bn",
    [
        (8, 4, 128, 8, 128),      # single tile
        (64, 16, 256, 16, 128),   # multi-tile both grid dims
        (100, 30, 300, 32, 128),  # ragged edges everywhere (paper K=30)
        (256, 128, 384, 128, 128),
    ],
)
def test_fused_shapes_grid(m, k, n, bm, bn):
    x, w, h = _problem(m, k, n, m + n)
    blocks = dict(interpret=True, block_m=bm, block_n=bn)
    np.testing.assert_allclose(
        tfm.update_h_fused(*_t(w, h, x)).numpy(),
        np.asarray(jfm.update_h_fused(*_j(w, h, x), **blocks)),
        rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_allclose(
        tfm.update_w_fused(*_t(w, h, x)).numpy(),
        np.asarray(jfm.update_w_fused(*_j(w, h, x), **blocks)),
        rtol=RTOL, atol=ATOL,
    )


def test_large_k_goes_to_plain_ops(problem):
    """Above MAX_FUSED_K both packages use the plain ops (the rank rule)."""
    x, _, _ = problem
    big_k = tfm.MAX_FUSED_K + 8
    assert tfm.MAX_FUSED_K == jfm.MAX_FUSED_K
    assert not tfm.supported(big_k) and tfm.supported(tfm.MAX_FUSED_K)
    rng = np.random.RandomState(0)
    w2 = clamp(rng.rand(x.shape[0], big_k).astype(np.float32))
    h2 = clamp(rng.rand(big_k, x.shape[1]).astype(np.float32))
    ours = tfm.update_h_fused(*_t(w2, h2, x)).numpy()
    ref = np.asarray(jfm.update_h_fused(*_j(w2, h2, x), interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_kl_cost_fused_matches_pallas(problem):
    x, w, h = problem
    ours = float(tfm.kl_cost_fused(*_t(x, w, h)))
    ref = float(jfm.kl_cost_fused(*_j(x, w, h), **BLOCKS))
    assert ours == pytest.approx(ref, rel=COST_RTOL)


def test_kl_cost_fused_padding_masked():
    """Ragged shapes: zero padding must contribute exactly nothing."""
    rng = np.random.RandomState(1)
    x = clamp(rng.rand(33, 170).astype(np.float32))
    w = clamp(rng.rand(33, 5).astype(np.float32))
    h = clamp(rng.rand(5, 170).astype(np.float32))
    ours = float(tfm.kl_cost_fused(*_t(x, w, h)))
    ref = float(jfm.kl_cost_fused(*_j(x, w, h), interpret=True, block_m=16, block_n=128))
    assert np.isfinite(ours)
    assert ours == pytest.approx(ref, rel=COST_RTOL)


def test_kl_cost_fused_unclamped_zeros_match_pallas():
    """Genuine x == 0 entries take the x->0 limit and keep their +y."""
    rng = np.random.RandomState(3)
    x = rng.rand(33, 170).astype(np.float32)
    x[x < 0.3] = 0.0
    w = clamp(rng.rand(33, 5).astype(np.float32))
    h = clamp(rng.rand(5, 170).astype(np.float32))
    ours = float(tfm.kl_cost_fused(*_t(x, w, h)))
    ref = float(jfm.kl_cost_fused(*_j(x, w, h), interpret=True, block_m=16, block_n=128))
    assert np.isfinite(ours)
    assert ours == pytest.approx(ref, rel=COST_RTOL)


def test_cpu_calls_launch_nothing(problem):
    x, w, h = problem
    wt, ht, xt = _t(w, h, x)
    tfm.mu_step_fused(wt, ht, xt)
    tfm.kl_cost_fused(xt, wt, ht)
    tfm.update_h_fused(wt, ht, xt, numerator_only=True)
    tfm.update_w_fused(wt, ht, xt, numerator_only=True)
    zero = {"update_h": 0, "update_w": 0, "kl_cost": 0,
            "update_h_numerator": 0, "update_w_numerator": 0}
    assert tfm.LAUNCHES == zero
    assert tfm.PLAIN_CALLS == zero


@pytest.mark.parametrize("fn", ["update_h_fused", "update_w_fused", "kl_cost_fused"])
def test_non_cpu_tensors_never_take_the_plain_version(problem, fn):
    """A tensor off the CPU goes to the kernel or raises: here, a tensor on
    the meta device (no data, no card) raises instead of running plain ops."""
    x, w, h = problem
    wt, ht, xt = (t.to("meta") for t in _t(w, h, x))
    args = (xt, wt, ht) if fn == "kl_cost_fused" else (wt, ht, xt)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tfm, fn)(*args)
    assert not any(tfm.LAUNCHES.values()) and not any(tfm.PLAIN_CALLS.values())


def test_mixed_devices_raise(problem):
    x, w, h = problem
    wt, ht, xt = _t(w, h, x)
    with pytest.raises(ValueError, match="different devices"):
        tfm.update_h_fused(wt, ht.to("meta"), xt)


def test_cuda_path_without_a_card_raises(problem):
    """Building the kernels needs nvcc; resolving CUDA needs a card."""
    from nmf_tpu_torch.ops.kernels import _build
    from nmf_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available() or shutil.which("nvcc"):
        pytest.skip("this check is for a machine without nvcc and a card")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()


@pytest.mark.parametrize(
    "kw",
    [
        {"numerator_only": True},
        {"precision": Precision("bfloat16")},
        {"precision": Precision("float32_fast")},
        {"precision": Precision(state_dtype="bfloat16")},
    ],
)
def test_unported_modes_raise(problem, kw):
    """Parity now: the modes refused when this test was named run and match
    the Pallas kernel in interpret mode (bf16 GEMMs: rtol 2e-3, a last-ulp
    difference in W H may flip the bf16 rounding of a Z entry; bf16 state:
    one bf16 ulp more; ``numerator_only``: the f32 numerators at rtol
    1e-5, every mode in :func:`test_numerator_only_matches_pallas`)."""
    x, w, h = problem
    if kw.get("numerator_only"):
        for ours_fn, ref_fn in ((tfm.update_h_fused, jfm.update_h_fused),
                                (tfm.update_w_fused, jfm.update_w_fused)):
            ours = ours_fn(*_t(w, h, x), **kw)
            ref = np.asarray(ref_fn(*_j(w, h, x), **kw, **BLOCKS))
            assert ours.dtype == torch.float32
            np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
        return
    prec = kw["precision"]
    jprec = jcfg.Precision(*dataclasses.astuple(prec))
    wt, ht, xt = _t(w, h, x)
    wj, hj, xj = _j(w, h, x)
    rtol = 2e-3 if prec.matmul_dtype == "bfloat16" else 1e-4
    if prec.state_dtype == "bfloat16":
        wt, ht = wt.to(torch.bfloat16), ht.to(torch.bfloat16)
        wj, hj = wj.astype(jnp.bfloat16), hj.astype(jnp.bfloat16)
        rtol += 2.0 ** -7
    for ours_fn, ref_fn in ((tfm.update_h_fused, jfm.update_h_fused),
                            (tfm.update_w_fused, jfm.update_w_fused)):
        ours = ours_fn(wt, ht, xt, precision=prec)
        ref = ref_fn(wj, hj, xj, precision=jprec, **BLOCKS)
        assert ours.dtype == wt.dtype
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref).astype(np.float32),
                                   rtol=rtol, atol=1e-6)


# mode -> (Precision fields, state dtype, X form, rtol); the rtols of
# test_unported_modes_raise (bf16 GEMMs 2e-3: a flipped bf16 rounding of one
# Z entry), here on the f32 numerator, which takes no bf16 epilogue.
NUMERATOR_MODES = {
    "float32": ((), "float32", "f32", RTOL),
    "x_bfloat16": (("float32", "float32", "bfloat16"), "float32", "bf16", RTOL),
    "x_int8": (("float32", "float32", "int8"), "float32", "int8", RTOL),
    "bfloat16": (("bfloat16",), "float32", "f32", 2e-3),
    "float32_fast": (("float32_fast",), "float32", "f32", 1e-4),
    "bf16_state": (("bfloat16", "bfloat16", "bfloat16"), "bfloat16", "bf16", 2e-3),
}


@pytest.mark.parametrize("target", ["h", "w"])
@pytest.mark.parametrize("mode", list(NUMERATOR_MODES))
def test_numerator_only_matches_pallas(problem, mode, target):
    """``numerator_only=True`` against the Pallas kernel in interpret mode,
    in every mode: the f32 numerator with no epilogue, whatever the state
    dtype (nmf_tpu fused_mu.py:357, :482)."""
    from nmf_tpu.ops.quant import quantize_columns_np

    fields, state, xform, rtol = NUMERATOR_MODES[mode]
    prec = Precision(*fields)
    jprec = jcfg.Precision(*fields)
    x, w, h = problem
    if xform == "int8":
        q, s = quantize_columns_np(x, np.float32(2.2204e-16))
        xt, xj = _t(q, s), _j(q, s)
    else:
        (xt,), (xj,) = _t(x), _j(x)
        if xform == "bf16":
            xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    wt, ht = (a.to(getattr(torch, state)) for a in _t(w, h))
    wj, hj = (a.astype(getattr(jnp, state)) for a in _j(w, h))
    ours_fn = tfm.update_h_fused if target == "h" else tfm.update_w_fused
    ref_fn = jfm.update_h_fused if target == "h" else jfm.update_w_fused
    ours = ours_fn(wt, ht, xt, precision=prec, numerator_only=True)
    ref = np.asarray(ref_fn(wj, hj, xj, precision=jprec, numerator_only=True, **BLOCKS))
    assert ours.dtype == torch.float32 and ref.dtype == np.float32
    assert tuple(ours.shape) == ((12, 130) if target == "h" else (96, 12))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("target", ["h", "w"])
def test_numerator_only_large_k_goes_to_plain_ops(problem, target):
    """Above MAX_FUSED_K the numerator takes JAX's plain branch
    (fused_mu.py:310-312, 436-438) in both packages."""
    x, _, _ = problem
    k = tfm.MAX_FUSED_K + 8
    rng = np.random.RandomState(1)
    w2 = clamp(rng.rand(x.shape[0], k).astype(np.float32))
    h2 = clamp(rng.rand(k, x.shape[1]).astype(np.float32))
    ours_fn = tfm.update_h_fused if target == "h" else tfm.update_w_fused
    ref_fn = jfm.update_h_fused if target == "h" else jfm.update_w_fused
    ours = ours_fn(*_t(w2, h2, x), numerator_only=True)
    ref = np.asarray(ref_fn(*_j(w2, h2, x), numerator_only=True, interpret=True))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_int8_codes_raise(problem):
    """Mostly parity now: uint8 codes with per-column scales, refused when
    this test was named, match the Pallas kernels' in-register dequant.
    Per-row-block scales, which the CUDA kernels lack, still raise on the
    kernel path's operand check (it reads only dtypes and shapes, so it
    runs here on CPU tensors)."""
    from nmf_tpu.ops.quant import quantize_columns_np, quantize_rowblocks_np

    x, w, h = problem
    wt, ht, _ = _t(w, h, x)
    wj, hj, _ = _j(w, h, x)
    q, s = quantize_columns_np(x, np.float32(2.2204e-16))
    codes, codes_j = _t(q, s), _j(q, s)
    np.testing.assert_allclose(tfm.update_h_fused(wt, ht, codes).numpy(),
                               np.asarray(jfm.update_h_fused(wj, hj, codes_j, **BLOCKS)),
                               rtol=RTOL, atol=ATOL)
    assert float(tfm.kl_cost_fused(codes, wt, ht)) == pytest.approx(
        float(jfm.kl_cost_fused(codes_j, wj, hj, **BLOCKS)), rel=COST_RTOL)
    rows = _t(*quantize_rowblocks_np(x, np.float32(2.2204e-16), 16))
    with pytest.raises(NotImplementedError, match="per-row-block"):
        tfm._check_cuda_operands(wt, ht, rows)


@pytest.mark.parametrize(
    "k,kc,chunks",
    [(1, 16, 1), (16, 16, 1), (17, 32, 1), (30, 32, 1), (128, 128, 1),
     (129, 256, 1), (256, 256, 1), (257, 256, 2), (2048, 256, 8)],
)
def test_chunk_width(k, kc, chunks):
    assert tfm.chunk_width(k) == kc
    assert -(-k // tfm.chunk_width(k)) == chunks


@pytest.mark.parametrize(
    "m,n,k",
    [(4096, 350, 128), (1025, 4000, 32), (513, 3445, 30), (10240, 10240, 256),
     (64, 64, 8), (1, 1, 1), (100, 7000, 2048)],
)
def test_plan_split_covers_the_walk_once(m, n, k):
    """Every split owns a non-empty run of tiles; together they cover the
    contraction walk exactly once, so the fixed-order sum sees each tile
    once."""
    tile = tfm.TILE
    m_tiles, n_tiles = -(-m // tile), -(-n // tile)
    chunks = -(-k // tfm.chunk_width(k))
    for out_tiles, walk in ((n_tiles, m_tiles), (m_tiles, n_tiles)):
        splits, per = tfm.plan_split(out_tiles, chunks, walk)
        runs = [range(s * per, min((s + 1) * per, walk)) for s in range(splits)]
        assert all(len(r) > 0 for r in runs)
        assert sorted(t for r in runs for t in r) == list(range(walk))
        assert splits == 1 or out_tiles * chunks * splits <= 2 * tfm.TARGET_BLOCKS
