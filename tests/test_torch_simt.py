"""K1/K2 under ``float32`` GEMMs at the edges of their SIMT pass 1, against ``nmf_tpu``.

On the card ``update_h_fused`` and ``update_w_fused`` (full update and
``numerator_only``) run ``csrc/simt_tile.cuh`` whenever the GEMMs are f32:
``Mode::F32`` on all-f32 operands, ``Mode::ANY`` on bf16 state, bf16 X or
uint8 codes with per-column scales.  Its edges are K around the staging
depths (runs of 4 k, copy groups of 64, chunks of 16 to 256 and several
chunks above 256) and rows that do not start on 16 bytes (K or N not a
multiple of 4: 4-byte copies instead of 16-byte ones), with M and N ragged
against the 64-wide tiles.  Here the wrappers' CPU route, the plain version
the kernels are held against on the card, is held at those shapes to the
Pallas kernels in interpret mode.

Tolerance: f32 results rtol 1e-5 (two f32 sums of at most a few thousand
positive terms in different orders); bf16 results (bf16 state, full
update) one bf16 ulp more, a last-ulp difference in the f32 value may round
the other way.
"""

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
RTOL = 1e-5
BF16_RTOL = 2.0 ** -7 + RTOL
BLOCKS = dict(interpret=True, block_m=32, block_n=128)
KINDS = [("update_h", False), ("update_w", False), ("update_h", True), ("update_w", True)]
KIND_IDS = ["update_h", "update_w", "h_numerator", "w_numerator"]
# f32-GEMM modes: (state dtype, X form)
MODES = {"f32": ("float32", "f32"), "bf16_state": ("bfloat16", "f32"),
         "x_bfloat16": ("float32", "bf16"), "x_int8": ("float32", "int8")}


@pytest.fixture(autouse=True)
def _zero_counts():
    tfm.reset_counts()
    yield
    assert not any(tfm.LAUNCHES.values())   # CPU tensors: the plain version
    tfm.reset_counts()


def _bf16_t(a: np.ndarray) -> torch.Tensor:
    bits = np.asarray(a).astype(ml_dtypes.bfloat16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _operands(m, n, k, mode, seed):
    """(torch w, h, x), (JAX w, h, x) in ``mode``, from one NumPy draw."""
    rng = np.random.RandomState(seed)
    x, w, h = (clamp(rng.rand(*s).astype(np.float32)) for s in ((m, n), (m, k), (k, n)))
    state, xform = MODES[mode]
    if state == "bfloat16":
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
    return (wt, ht, xt), (wj, hj, xj)


def _check(m, n, k, mode, kind, numerator_only, seed=0):
    (wt, ht, xt), (wj, hj, xj) = _operands(m, n, k, mode, seed)
    state, xform = MODES[mode]
    x_dtype = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}[xform]
    ours = getattr(tfm, f"{kind}_fused")(wt, ht, xt, EPS, tcfg.Precision("float32", state, x_dtype),
                                         numerator_only=numerator_only)
    ref = getattr(jfm, f"{kind}_fused")(wj, hj, xj, EPS, jcfg.Precision("float32", state, x_dtype),
                                        numerator_only=numerator_only, **BLOCKS)
    want = (k, n) if kind == "update_h" else (m, k)
    assert tuple(ours.shape) == want == tuple(ref.shape)
    f32_out = numerator_only or state == "float32"
    assert ours.dtype == (torch.float32 if f32_out else torch.bfloat16)
    ours = (ours.float() if ours.dtype == torch.bfloat16 else ours).numpy()
    ref = np.asarray(ref).astype(np.float32)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL if f32_out else BF16_RTOL, atol=0)


@pytest.mark.parametrize("kind,numerator_only", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("k", [1, 4, 15, 17, 30, 33, 256, 257, 300])
def test_float32_at_the_staging_depths(k, kind, numerator_only):
    """Every K chunk width (16 to 256) and two chunks, K on and off runs of
    4; rows of W off 16 bytes where K is odd, of H and X (N = 129) always."""
    _check(65, 129, k, "f32", kind, numerator_only, seed=k)


@pytest.mark.parametrize("kind,numerator_only", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("m,n", [(65, 3445), (127, 350), (129, 129), (350, 65), (3445, 127)])
def test_float32_on_ragged_unaligned_rows(m, n, kind, numerator_only):
    """M and N ragged against 64-wide tiles, K = 30: rows of W, H and X
    that do not start on 16 bytes wherever K or N is not a multiple of 4."""
    _check(m, n, 30, "f32", kind, numerator_only, seed=m + n)


@pytest.mark.parametrize("kind,numerator_only", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("mode", ["bf16_state", "x_bfloat16", "x_int8"])
@pytest.mark.parametrize("m,n,k", [(127, 350, 30), (65, 129, 257)])
def test_f32_gemms_on_other_storage(m, n, k, mode, kind, numerator_only):
    """Mode::ANY's operands, widened as they are staged: bf16 W and H, bf16
    X, uint8 codes with per-column scales, on unaligned rows, at one chunk
    and at two."""
    _check(m, n, k, mode, kind, numerator_only, seed=k)
