"""The port's quantizer (``nmf_tpu_torch.ops.quant``) against ``nmf_tpu.ops.quant``.

Codes and scales are compared bit for bit (no tolerance): the torch
quantizers, the port's NumPy twins, the JAX quantizers and the JAX NumPy
twins must all give the same bytes, including for values placed exactly on
a rounding threshold ``f32(s*(q +- 0.5))``, all-eps columns, and row counts
that are not a multiple of ``rows_per_block``.  Dequantized values are
compared bit for bit as well (one f32 multiply each).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from nmf_tpu.ops import quant as jq  # noqa: E402
from nmf_tpu_torch.ops import quant as tq  # noqa: E402

EPS = np.float32(2.2204e-16)


def _x(m, n, seed):
    rng = np.random.RandomState(seed)
    # spectrogram-like: per-column magnitudes over orders of magnitude
    x = rng.rand(m, n).astype(np.float32) * (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    return np.maximum(x, EPS)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes(), f"{int((a != b).sum())} entries differ"


def _all_columns(x):
    """Codes and scales from the four per-column quantizers."""
    t = tq.quantize_columns(torch.from_numpy(x), EPS)
    return [
        (t[0].numpy(), t[1].numpy()),
        tq.quantize_columns_np(x, EPS),
        tuple(np.asarray(a) for a in jq.quantize_columns(jnp.asarray(x), EPS)),
        jq.quantize_columns_np(x, EPS),
    ]


def _assert_all_same(results):
    (q0, s0), rest = results[0], results[1:]
    assert q0.dtype == np.uint8 and s0.dtype == np.float32
    for q, s in rest:
        _same(q, q0)
        _same(s, s0)


@pytest.mark.parametrize("m,n,seed", [(96, 130, 0), (1, 1, 1), (7, 300, 2), (64, 48, 3)])
def test_quantize_columns_bitwise(m, n, seed):
    _assert_all_same(_all_columns(_x(m, n, seed)))


@pytest.mark.parametrize("colmax", [1.0, 3.7, 1e-12, 5e7])
def test_threshold_values_bitwise(colmax):
    """Values exactly on f32(s*(q+0.5)) and f32(s*(q-0.5)), and one ulp on
    either side: the canonical fixup decides them the same way everywhere."""
    s = np.float32(colmax) * np.float32(1.0 / 255.0)
    q = np.arange(1, 255, dtype=np.float32)
    on = np.concatenate([s * (q + np.float32(0.5)), s * (q - np.float32(0.5))])
    vals = np.concatenate([on, np.nextafter(on, np.float32(0)), np.nextafter(on, np.float32(np.inf))])
    col = np.concatenate([[np.float32(colmax)], vals]).astype(np.float32)
    x = np.maximum(np.minimum(col, np.float32(colmax)), EPS)[:, None]
    x = np.repeat(x, 3, axis=1)
    results = _all_columns(x)
    _assert_all_same(results)
    assert results[0][1][0] == s  # the scale is max * f32(1/255), a multiply


def test_all_eps_columns_bitwise():
    x = _x(40, 9, 4)
    x[:, [0, 4, 8]] = EPS
    results = _all_columns(x)
    _assert_all_same(results)
    q, s = results[0]
    assert (q[:, [0, 4, 8]] == 255).all()
    assert (s[[0, 4, 8]] == EPS * np.float32(1.0 / 255.0)).all()


def test_bf16_input_bitwise():
    xb = jnp.asarray(_x(33, 20, 5)).astype(jnp.bfloat16)
    bits = np.asarray(xb).view(np.int16)
    xt = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    qt, st = tq.quantize_columns(xt, EPS)
    qj, sj = jq.quantize_columns(xb, EPS)
    _same(qt.numpy(), qj)
    _same(st.numpy(), sj)


@pytest.mark.parametrize(
    "m,n,rows_per_block",
    [
        (10, 5, 8),      # normalised to 2 blocks of 5 (nmf_tpu quant.py:128-137)
        (96, 13, 32),    # exact multiple
        (100, 7, 7),     # 15 blocks of 7, the last one padded by 5
        (33, 6, 100),    # one block larger than M
        (97, 11, 16),    # 7 blocks of 14, padded by 1
    ],
)
def test_quantize_rowblocks_bitwise(m, n, rows_per_block):
    x = _x(m, n, m + rows_per_block)
    x[: m // 3] *= np.float32(1e-4)   # magnitude varies along the rows
    qt, st = tq.quantize_rowblocks(torch.from_numpy(x), EPS, rows_per_block)
    results = [
        (qt.numpy(), st.numpy()),
        tq.quantize_rowblocks_np(x, EPS, rows_per_block),
        tuple(np.asarray(a) for a in jq.quantize_rowblocks(jnp.asarray(x), EPS, rows_per_block)),
        jq.quantize_rowblocks_np(x, EPS, rows_per_block),
    ]
    _assert_all_same(results)
    r = -(-m // rows_per_block)
    assert results[0][0].shape == (m, n) and results[0][1].shape == (r, n)
    assert qt.is_contiguous()


@pytest.mark.parametrize("rows", [0, 16])
def test_quantize_policy_dispatch_bitwise(rows):
    x = _x(50, 12, 6)
    qt, st = tq.quantize_policy(torch.from_numpy(x), EPS, rows)
    qn, sn = tq.quantize_policy_np(x, EPS, rows)
    qj, sj = jq.quantize_policy(jnp.asarray(x), EPS, rows)
    for a, b in ((qt.numpy(), qj), (st.numpy(), sj), (qn, qj), (sn, sj)):
        _same(a, b)
    assert st.dim() == (2 if rows else 1)


@pytest.mark.parametrize("rows", [0, 16])
def test_dequantize_bitwise(rows):
    x = _x(50, 12, 7)
    qn, sn = jq.quantize_policy_np(x, EPS, rows)
    ours = tq.dequantize(torch.from_numpy(qn), torch.from_numpy(sn)).numpy()
    ref = np.asarray(jq.dequantize(jnp.asarray(qn), jnp.asarray(sn)))
    _same(ours, ref)
    assert ours.dtype == np.float32


@pytest.mark.parametrize("offset,length", [(0, 50), (14, 20), (33, 17)])
def test_dequantize_rows_slice_bitwise(offset, length):
    """A row slice takes the block height of the full extent, not its own."""
    x = _x(50, 12, 8)
    qn, sn = jq.quantize_rowblocks_np(x, EPS, 16)
    part = qn[offset:offset + length]
    ours = tq.dequantize_rows(torch.from_numpy(part), torch.from_numpy(sn), offset, 50).numpy()
    ref = np.asarray(jq.dequantize_rows(jnp.asarray(part), jnp.asarray(sn), offset, 50))
    _same(ours, ref)
    full = tq.dequantize(torch.from_numpy(qn), torch.from_numpy(sn)).numpy()
    _same(ours, full[offset:offset + length])


def test_roundtrip_error_bound():
    """|dequantize(q) - x| <= s/510 per entry (half a step), up to an ulp."""
    x = _x(64, 40, 9)
    q, s = tq.quantize_columns(torch.from_numpy(x), EPS)
    err = np.abs(tq.dequantize(q, s).numpy() - x)
    bound = s.numpy()[None, :] * np.float32(0.5) * (1 + 1e-6) + np.spacing(x)
    assert (err <= bound).all()
