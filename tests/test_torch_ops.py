"""The port's plain ops (``ops/elementwise``, ``ops/mu``, ``ops/divergence``)
against ``nmf_tpu.ops`` on the CPU, at the odd sizes 96x12x130.

Tolerances: factors rtol 1e-5 / atol 1e-6 (f32 GEMMs summed in another
order by torch's and XLA's CPU kernels), costs rel 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from nmf_tpu.ops import divergence as jdiv  # noqa: E402
from nmf_tpu.ops import elementwise as jel  # noqa: E402
from nmf_tpu.ops import mu as jmu  # noqa: E402
from nmf_tpu.utils import config as jcfg  # noqa: E402
from nmf_tpu_torch.ops import divergence as tdiv  # noqa: E402
from nmf_tpu_torch.ops import elementwise as tel  # noqa: E402
from nmf_tpu_torch.ops import mu as tmu  # noqa: E402
from nmf_tpu_torch.utils import config as tcfg  # noqa: E402

from oracle import clamp  # noqa: E402

RTOL, ATOL, COST_RTOL = 1e-5, 1e-6, 1e-5


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(7)
    m, k, n = 96, 12, 130
    x = clamp(rng.rand(m, n).astype(np.float32))
    w = clamp(rng.rand(m, k).astype(np.float32))
    h = clamp(rng.rand(k, n).astype(np.float32))
    return x, w, h


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_eps_bit_identical():
    assert tel.EPS.dtype == np.float32 and jel.EPS.dtype == np.float32
    assert tel.EPS.tobytes() == jel.EPS.tobytes()
    assert tcfg.EPS_DEFAULT == jcfg.EPS_DEFAULT == float(np.float32(2.2204e-16))


def test_eps_clamp_keeps_nan_and_matches():
    v = np.array([np.nan, 0.0, -1.0, 1e-30, 2.2204e-16, 1.0, np.inf], np.float32)
    ours = tel.eps_clamp(torch.from_numpy(v)).numpy()
    ref = np.asarray(jel.eps_clamp(jnp.asarray(v)))
    assert np.isnan(ours[0]) and np.isnan(ref[0])
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True)])
def test_matmul_transposes(problem, ta, tb):
    x, w, h = problem
    a, b = {(False, False): (w, h), (True, False): (w, x), (False, True): (x, h)}[(ta, tb)]
    ours = tmu.matmul(*_t(a, b), transpose_a=ta, transpose_b=tb).numpy()
    ref = np.asarray(jmu.matmul(jnp.asarray(a), jnp.asarray(b), jcfg.Precision(),
                                transpose_a=ta, transpose_b=tb))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_update_h_matches_jax(problem):
    x, w, h = problem
    ours = tmu.update_h(*_t(w, h, x)).numpy()
    ref = np.asarray(jmu.update_h(jnp.asarray(w), jnp.asarray(h), jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_update_w_matches_jax(problem):
    x, w, h = problem
    ours = tmu.update_w(*_t(w, h, x)).numpy()
    ref = np.asarray(jmu.update_w(jnp.asarray(w), jnp.asarray(h), jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("steps", [1, 3])
def test_mu_step_matches_jax(problem, steps):
    x, w, h = problem
    wt, ht, xt = _t(w, h, x)
    wj, hj, xj = jnp.asarray(w), jnp.asarray(h), jnp.asarray(x)
    for _ in range(steps):
        wt, ht = tmu.mu_step(wt, ht, xt)
        wj, hj = jmu.mu_step(wj, hj, xj)
    # errors compound over steps: rtol grows with them (5e-5 at 3, as
    # tests/test_pallas.py::test_mu_step_fused_multi_iter allows)
    rtol = RTOL if steps == 1 else 5e-5
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=rtol, atol=ATOL)


def test_kl_divergence_matches_jax(problem):
    x, w, h = problem
    ours = float(tdiv.kl_divergence(*_t(x, w, h)))
    ref = float(jdiv.kl_divergence(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)))
    assert ours == pytest.approx(ref, rel=COST_RTOL)


def test_kl_divergence_unclamped_zeros_match_jax():
    """x == 0 takes the x->0 limit (no NaN) and keeps its +y mass."""
    rng = np.random.RandomState(3)
    x = rng.rand(33, 170).astype(np.float32)
    x[x < 0.3] = 0.0
    w = clamp(rng.rand(33, 5).astype(np.float32))
    h = clamp(rng.rand(5, 170).astype(np.float32))
    ours = float(tdiv.kl_divergence(*_t(x, w, h)))
    ref = float(jdiv.kl_divergence(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h)))
    assert np.isfinite(ours)
    assert ours == pytest.approx(ref, rel=COST_RTOL)


def test_kl_divergence_from_recon_matches_jax(problem):
    x, w, h = problem
    y = (w @ h).astype(np.float32)
    ours = float(tdiv.kl_divergence_from_recon(*_t(x, y)))
    ref = float(jdiv.kl_divergence_from_recon(jnp.asarray(x), jnp.asarray(y)))
    assert ours == pytest.approx(ref, rel=COST_RTOL)


def test_update_keeps_nan(problem):
    """A NaN in X stays NaN through the plain update (the clamp keeps it)."""
    x, w, h = problem
    x = x.copy()
    x[3, 4] = np.nan
    ours = tmu.update_h(*_t(w, h, x)).numpy()
    ref = np.asarray(jmu.update_h(jnp.asarray(w), jnp.asarray(h), jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ours[:, 4]).all()


@pytest.mark.parametrize(
    "prec",
    [
        tcfg.Precision("bfloat16"),
        tcfg.Precision("float32_fast"),
        tcfg.Precision(x_dtype="int8"),
        tcfg.Precision(state_dtype="bfloat16"),
    ],
)
def test_unported_precision_raises(problem, prec):
    """Parity now, under the name of the refusal it replaced: the bf16,
    float32_fast, int8-X and bf16-state policies run and match
    ``nmf_tpu.ops.mu`` (bf16 GEMMs: rtol 2e-3, a last-ulp difference in W H
    may flip the bf16 rounding of a Z entry; float32_fast against XLA:CPU's
    true f32: rtol 1e-4; bf16 state: one bf16 ulp more)."""
    import dataclasses

    x, w, h = problem
    wt, ht, xt = _t(w, h, x)
    wj, hj, xj = jnp.asarray(w), jnp.asarray(h), jnp.asarray(x)
    if prec.state_dtype == "bfloat16":
        wt, ht = wt.to(torch.bfloat16), ht.to(torch.bfloat16)
        wj, hj = wj.astype(jnp.bfloat16), hj.astype(jnp.bfloat16)
    ours = tmu.update_h(wt, ht, xt, precision=prec)
    ref = jmu.update_h(wj, hj, xj, precision=jcfg.Precision(*dataclasses.astuple(prec)))
    assert ours.dtype == wt.dtype
    rtol = {"bfloat16": 2e-3, "float32_fast": 1e-4, "float32": RTOL}[prec.matmul_dtype]
    rtol += 2.0 ** -7 if prec.state_dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref).astype(np.float32),
                               rtol=rtol, atol=ATOL)
