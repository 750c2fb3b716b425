"""The ``float32_fast`` (split3) policy of the port against ``nmf_tpu`` on the CPU.

Under ``float32_fast`` every GEMM operand is split ``a = hi + lo``,
``hi = bf16(a)``, ``lo = bf16(a - hi)``, and each product taken as
``hi bh + hi bl + lo bh`` (``nmf_tpu/ops/pallas/fused_mu.py:215-237``).  The
port's plain version (``ops/mu._split3`` and ``matmul``) is what the CUDA
kernels K1/K2 are held against on the card; here it is held to the JAX
package: the split bit for bit, and the wrappers' CPU routes (full update
and ``numerator_only``) to the Pallas kernels in interpret mode.

The operands are ``chip_smoke._exposed``'s for ``float32_fast``, rebuilt with
NumPy: hi a power of two and lo = hi * 2**-8 * u, u in [0.5, 1) on 8 bits,
which bf16 splits exactly into (hi, lo).  Split3 drops lo * lo' = 2**-16 u u'
of every product, so W H under split3 sits ~8.6e-6 below the true f32 W H,
one sign everywhere: the f32-GEMM control must read above the limits that
``chip_smoke.MODE_LIMITS["float32_fast"]`` sets on the card (max relative
error 1e-4, RMS 2e-6), and the port must read within them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from nmf_tpu.ops.pallas import fused_mu as jfm  # noqa: E402
from nmf_tpu.utils import config as jcfg  # noqa: E402
from nmf_tpu_torch.ops import mu as tmu  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils import config as tcfg  # noqa: E402

EPS = np.float32(2.2204e-16)
LIMITS = (1e-4, 2e-6)            # chip_smoke.MODE_LIMITS["float32_fast"]: max, RMS
BLOCKS = dict(interpret=True, block_m=32, block_n=128)
M, N = 96, 130


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _splits(a):
    """((hi, lo) of nmf_tpu's _prep_operand, (hi, lo) of the port's _split3),
    as f32 arrays."""
    ref = (np.asarray(t.astype(jnp.float32)) for t in jfm._prep_operand(jnp.asarray(a), None, True))
    return tuple(ref), tuple(t.numpy() for t in tmu._split3(torch.from_numpy(a)))


def _lo_ties(rng, count):
    """f32 values whose residual a - bf16(a) lies halfway between two bf16
    values: lo rounds by ties-to-even."""
    a = rng.randint(0x3F800000, 0x40000000, 1 << 16, dtype=np.uint32).view(np.float32)
    r = a.astype(np.float64) - a.astype(jnp.bfloat16).astype(np.float64)
    mant, _ = np.frexp(np.abs(r))              # in [0.5, 1): 8 bits fit bf16
    frac = mant * 2 ** 9
    ties = (r != 0) & (frac == np.floor(frac)) & (frac % 2 == 1)
    assert ties.sum() >= count
    return a[ties][:count]


def _cases():
    rng = np.random.RandomState(0)
    halfway = ((0x3F80 + np.arange(1, 200, dtype=np.uint32)) << 16 | 0x8000).view(np.float32)
    return {
        "random": rng.rand(64, 48).astype(np.float32),
        # every lo a normal f32 (subnormals: the test after next)
        "wide_range": ((1 + rng.rand(256)) * np.exp2(rng.randint(-100, 100, 256)))
        .astype(np.float32),
        "negative": -rng.rand(100).astype(np.float32),
        "hi_tie": halfway,
        "lo_tie": _lo_ties(rng, 64),
        "zero": np.array([0.0, -0.0, 1.0, 0.0], np.float32),
        "eps": EPS * np.array([1, 1.5, 2, 3, 1 + 2 ** -9, 1 + 2 ** -17], np.float32),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_split3_equals_prep_operand_bitwise(case):
    a = _cases()[case]
    (hj, lj), (ht, lt) = _splits(a)
    np.testing.assert_array_equal(_bits(ht), _bits(hj))
    np.testing.assert_array_equal(_bits(lt), _bits(lj))
    if case == "lo_tie":
        assert np.all(lt != 0)


def test_split3_nan_and_inf_positions_match():
    """NaN stays NaN in both halves (its bits are the framework's own), inf
    splits into (inf, NaN) in both."""
    a = np.array([np.nan, 1.0, -np.nan, np.inf, -np.inf, 3.0], np.float32)
    (hj, lj), (ht, lt) = _splits(a)
    for ours, ref in ((ht, hj), (lt, lj)):
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
        ok = ~np.isnan(ref)
        np.testing.assert_array_equal(_bits(ours[ok]), _bits(ref[ok]))
    assert np.isnan(lt[3]) and ht[3] == np.inf


def test_split3_subnormals_differ_only_by_the_cpu_flush():
    """On subnormal inputs hi agrees bit for bit, and lo in value, except
    where XLA:CPU flushes the subnormal a in ``a - hi`` to 0 (the port, like
    the card, keeps IEEE subnormals): a lo of zero keeps its sign in the
    port, and an a that rounds up to the smallest normal gets lo = -hi in
    JAX.  No operand of the solve is subnormal (each is clamped to eps)."""
    rng = np.random.RandomState(1)
    a = np.concatenate([(rng.rand(512) * np.float32(1e-38)).astype(np.float32),
                        np.array([1e-45, 1e-40, 1.1754942e-38], np.float32)])
    (hj, lj), (ht, lt) = _splits(a)
    np.testing.assert_array_equal(_bits(ht), _bits(hj))
    flushed = hj == np.float32(2.0 ** -126)          # a rounded up to the smallest normal
    assert flushed.sum() >= 1
    np.testing.assert_array_equal(lj[flushed], -hj[flushed])
    np.testing.assert_array_equal(lt, 0 * lt)
    np.testing.assert_array_equal(lj[~flushed], lt[~flushed])   # in value: +0 == -0


def _exposed(rng, shape):
    hi = np.exp2(-rng.randint(0, 4, shape)).astype(np.float32)
    u = (128 + rng.randint(0, 128, shape)).astype(np.float32) / 256
    return hi + hi * np.float32(2.0 ** -8) * u


@pytest.fixture(scope="module", params=[8, 128, 300], ids=lambda k: f"K{k}")
def exposed(request):
    k = request.param
    rng = np.random.RandomState(k)
    x = np.maximum(rng.rand(M, N).astype(np.float32), EPS)
    return x, _exposed(rng, (M, k)), _exposed(rng, (k, N))


def test_exposed_operands_split_exactly(exposed):
    """bf16 splits each W and H entry into its (hi, lo) exactly."""
    _, w, _ = exposed
    hi, lo = (t.numpy() for t in tmu._split3(torch.from_numpy(w)))
    assert np.all(np.log2(hi) == np.round(np.log2(hi)))
    np.testing.assert_array_equal(hi + lo, w)
    np.testing.assert_array_equal(lo, w - hi)


def _rel(ours: np.ndarray, ref: np.ndarray):
    rel = np.abs(ours.astype(np.float64) - ref) / np.abs(ref.astype(np.float64))
    return float(rel.max()), float(np.sqrt(np.mean(rel ** 2)))


KINDS = [("update_h", False), ("update_w", False), ("update_h", True), ("update_w", True)]


def _pair(exposed, kind, numerator_only, policy):
    x, w, h = exposed
    ours = getattr(tfm, f"{kind}_fused")(
        torch.from_numpy(w), torch.from_numpy(h), torch.from_numpy(x), EPS,
        tcfg.Precision(policy), numerator_only=numerator_only)
    ref = getattr(jfm, f"{kind}_fused")(
        jnp.asarray(w), jnp.asarray(h), jnp.asarray(x), EPS, jcfg.Precision("float32_fast"),
        numerator_only=numerator_only, **BLOCKS)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("kind,numerator_only", KINDS,
                         ids=["update_h", "update_w", "h_numerator", "w_numerator"])
def test_float32_fast_matches_pallas_within_card_limits(exposed, kind, numerator_only):
    ours, ref = _pair(exposed, kind, numerator_only, "float32_fast")
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    assert not any(tfm.LAUNCHES.values())
    err, rms = _rel(ours, ref)
    assert err <= LIMITS[0] and rms <= LIMITS[1], (err, rms)


@pytest.mark.parametrize("kind,numerator_only", KINDS,
                         ids=["update_h", "update_w", "h_numerator", "w_numerator"])
def test_f32_gemm_control_fails_the_limit(exposed, kind, numerator_only):
    """The same call with f32 GEMMs (the split skipped) reads above the RMS
    limit: the limit can see a kernel that drops the split."""
    ours, ref = _pair(exposed, kind, numerator_only, "float32")
    _, rms = _rel(ours, ref)
    assert rms > LIMITS[1], rms
