"""K3, the fused KL cost, of the port: ``kl_cost_fused`` against the JAX
Pallas kernel in interpret mode, the launch plan ``kl_split``, and a NumPy
model of the order in which the CUDA kernel sums the cost.

On the CPU ``kl_cost_fused`` takes its plain version (``kl_cost_plain``),
so the first tests hold that version and the wrapper's dispatch to the TPU
kernel at the edges of the CUDA kernel's walk (a block owns 64 columns and
walks a run of M tiles: M or N below a tile, N = 1, ragged edges, each
K chunk width and the streamed recon above 256); ``chip_smoke.py`` holds
the CUDA kernel to the plain version on the card.  Tolerances: cost rel
1e-5 where the recon is f32 (``tests/test_pallas.py``'s: the two packages
sum the same terms in other orders), rel 1e-4 under ``bfloat16``
(``tests/test_torch_precision.py``'s bf16-GEMM cost limit: the two
packages' bf16 dots may add their exact products in other orders).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from nmf_tpu.ops import quant as jq  # noqa: E402
from nmf_tpu.ops.pallas import fused_mu as jfm  # noqa: E402
from nmf_tpu.utils import config as jcfg  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils import config as tcfg  # noqa: E402

from oracle import clamp  # noqa: E402

EPS = np.float32(2.2204e-16)
CSRC = pathlib.Path(__file__).resolve().parents[1] / "nmf_tpu_torch" / "csrc"
BLOCKS = dict(interpret=True, block_m=32, block_n=128)

# mode -> (Precision fields, state bf16, X form, cost rel tolerance)
MODES = {
    "float32": (("float32", "float32", "float32"), False, "f32", 1e-5),
    "bf16_state": (("float32", "bfloat16", "float32"), True, "f32", 1e-5),
    "x_bfloat16": (("float32", "float32", "bfloat16"), False, "bf16", 1e-5),
    "x_int8": (("float32", "float32", "int8"), False, "int8", 1e-5),
    "bfloat16": (("bfloat16", "float32", "float32"), False, "f32", 1e-4),
    "float32_fast": (("float32_fast", "float32", "float32"), False, "f32", 1e-5),
}
# (M, N, K, genuine zeros in X): every K chunk width's edge and the
# streamed recon (K = 300, 2048), rows off 16 bytes, M < 64, N < 64, N = 1
EDGES = {
    "k8": (70, 90, 8, False),
    "k64": (70, 90, 64, False),
    "k300": (70, 90, 300, False),
    "k2048": (40, 36, 2048, False),
    "ragged": (65, 129, 17, False),
    "m_below_tile": (17, 130, 12, False),
    "n_below_tile": (100, 33, 12, False),
    "n1": (50, 1, 8, False),
    "zeros": (33, 170, 5, True),
}


@pytest.fixture(autouse=True)
def _zero_counts():
    tfm.reset_counts()
    yield
    tfm.reset_counts()


def _bf16_t(a):
    bits = np.asarray(a).astype(ml_dtypes.bfloat16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _case(m, n, k, zeros, mode):
    """(torch x, w, h), (JAX x, w, h), the two Precisions, for one mode."""
    rng = np.random.RandomState(m * 7 + n * 3 + k)
    x = rng.rand(m, n).astype(np.float32)
    if zeros:
        x[x < 0.3] = 0.0   # genuine zeros: the x -> 0 limit keeps their +y
    else:
        x = clamp(x)
    w = clamp(rng.rand(m, k).astype(np.float32))
    h = clamp(rng.rand(k, n).astype(np.float32))
    fields, state_bf16, xform, _ = MODES[mode]
    if state_bf16:
        wt, ht = _bf16_t(w), _bf16_t(h)
        wj, hj = jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(h).astype(jnp.bfloat16)
    else:
        wt, ht, wj, hj = torch.from_numpy(w), torch.from_numpy(h), jnp.asarray(w), jnp.asarray(h)
    if xform == "bf16":
        xt, xj = _bf16_t(x), jnp.asarray(x).astype(jnp.bfloat16)
    elif xform == "int8":
        q, s = jq.quantize_columns_np(x, EPS)
        xt, xj = (torch.from_numpy(q), torch.from_numpy(s)), (jnp.asarray(q), jnp.asarray(s))
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    return (xt, wt, ht), (xj, wj, hj), tcfg.Precision(*fields), jcfg.Precision(*fields)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("edge", list(EDGES))
def test_kl_cost_fused_matches_pallas_at_walk_edges(edge, mode):
    (xt, wt, ht), (xj, wj, hj), tp, jp = _case(*EDGES[edge], mode)
    ours = tfm.kl_cost_fused(xt, wt, ht, EPS, tp)
    ref = float(jfm.kl_cost_fused(xj, wj, hj, EPS, jp, **BLOCKS))
    assert ours.dtype == torch.float32 and ours.dim() == 0
    assert np.isfinite(ref) and ref > 0
    assert float(ours) == pytest.approx(ref, rel=MODES[mode][3])
    assert not any(tfm.LAUNCHES.values()) and not any(tfm.PLAIN_CALLS.values())


# --- the launch plan ----------------------------------------------------------

# (M, N, K) -> (blocks a row of splits, splits, tiles a split): the reference
# shape, the streamed block, the flagship and LONG_WALKS' hour of audio held
# wide and tall, and chip_smoke.KL_SHAPES
SPLITS = {
    (4096, 350, 128): (6, 64, 1),
    (1025, 65_408, 32): (1022, 1, 17),
    (10240, 10240, 256): (160, 4, 40),
    (1025, 619_264, 32): (9676, 1, 17),
    (619_264, 1025, 32): (17, 32, 303),
    (40, 333, 24): (6, 1, 1),
    (700, 50, 40): (1, 11, 1),
    (300, 1, 8): (1, 5, 1),
    (20_000, 100, 16): (2, 157, 2),
    (1, 1, 1): (1, 1, 1),
}


@pytest.mark.parametrize("shape", list(SPLITS), ids=lambda s: "x".join(map(str, s)))
def test_kl_split_walks_every_tile_once(shape):
    """Every split non-empty, every M tile walked by exactly one split of
    each column block, one slot a block, the grid within CUDA's limits
    (gridDim.z <= 65535), and the rule ``nmf_kl_cost`` checks before it
    launches."""
    m, n, k = shape
    kc, splits, per, slots = tfm.kl_split(m, n, k)
    n_tiles, m_tiles = -(-n // tfm.TILE), -(-m // tfm.TILE)
    assert kc == tfm.chunk_width(k)
    assert (n_tiles, splits, per) == SPLITS[shape]
    walked = np.zeros(m_tiles, int)
    for s in range(splits):
        run = range(s * per, min((s + 1) * per, m_tiles))
        assert len(run) > 0
        walked[list(run)] += 1
    assert (walked == 1).all()
    assert slots == n_tiles * splits
    assert 1 <= splits <= 65535 and n_tiles < 2**31
    assert (splits - 1) * per < m_tiles <= splits * per


# --- the order of the device's sum --------------------------------------------

THREADS, TERMS = 256, 16   # a block's threads; terms a thread adds a step


def _tree(v):
    """block_sum / kl_final's tree over the last axis (fused_mu.cu): stride
    128, 64, ..., 1, red[i] += red[i + stride]."""
    v = v.copy()
    stride = v.shape[-1] // 2
    while stride:
        v[..., :stride] = v[..., :stride] + v[..., stride:2 * stride]
        stride //= 2
    return v[..., 0]


def _final(slots):
    """kl_final: thread i adds slots i, i + 256, ... in order, then the tree."""
    acc = np.zeros(THREADS, np.float32)
    for i, v in enumerate(slots):
        acc[i % THREADS] = acc[i % THREADS] + v
    return _tree(acc)


def device_sum(terms):
    """The CUDA K3's sum of terms (blocks, steps, threads, 16) in f32, line
    for line: each step's 16 terms a thread summed in order (kl_terms),
    the step sum added into the thread's running sum with Kahan's
    compensation (KahanSum::add), the block's threads by block_sum's tree
    into one slot, and the slots in order by kl_final."""
    blocks, steps = terms.shape[:2]
    run = np.zeros((blocks, THREADS), np.float32)
    comp = np.zeros((blocks, THREADS), np.float32)
    for t in range(steps):
        step = np.zeros((blocks, THREADS), np.float32)
        for e in range(TERMS):
            step = step + terms[:, t, :, e]
        y = step - comp
        total = run + y
        comp = (total - run) - y
        run = total
    return _final(_tree(run))


def plain_chain_sum(terms):
    """The same terms, each added straight into one running f32 sum a
    thread (the first K3's rule within a tile, over a whole walk)."""
    blocks, steps = terms.shape[:2]
    run = np.zeros((blocks, THREADS), np.float32)
    for t in range(steps):
        for e in range(TERMS):
            run = run + terms[:, t, :, e]
    return _final(_tree(run))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_sum_order_holds_a_long_walk(seed):
    """Four blocks each walking 303 steps (the tall hour of audio's splits):
    the device's order reads within 1e-6 of a float64 sum of the same f32
    terms, and a plain running chain reads worse (by 2x at least)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(4, 303, THREADS, TERMS).astype(np.float32)
    y = (x * rng.uniform(0.5, 2.0, x.shape) + 1e-3).astype(np.float32)
    terms = (x * (np.log(x) - np.log(y)) - x + y).astype(np.float32)
    exact = terms.astype(np.float64).sum()
    ours = abs(float(device_sum(terms)) - exact) / exact
    chain = abs(float(plain_chain_sum(terms)) - exact) / exact
    assert ours <= 1e-6
    assert chain > 2 * ours


def test_kernel_keeps_the_bounded_chain():
    """The CUDA body sums each step's terms first and adds the step sum with
    Kahan's compensation: the order device_sum models."""
    pass1 = (CSRC / "pass1.cuh").read_text()
    mu_tile = (CSRC / "mu_tile.cuh").read_text()
    assert "struct KahanSum" in mu_tile and "c = (t - sum) - y;" in mu_tile
    assert pass1.count("total.add(kl_terms(o.eps, ") == 2
