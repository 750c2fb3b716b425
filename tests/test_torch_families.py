"""The port's beta-divergence, Itakura-Saito, Euclidean, penalized-KL and HALS
families against ``nmf_tpu`` on the CPU: the costs, one step of each
update, the HALS sweeps, and ``solve`` in each family.

The same inputs, made from a seed with NumPy, go through both packages
(``torch.set_num_threads(1)``).  Neither package has a kernel for these
families: JAX sends them to plain ops on every platform, and so does the
port, so the kernel wrappers are never called (counted below).

Tolerances, between two packages whose f32 sums run in other orders
(measured on these problems):

* costs: rel 1e-5 (measured <= 2.8e-7, beta in {0, 0.5, 1, 1.5, 2, 3}).
* one MU step (beta or penalized) under ``float32`` and ``bfloat16``: rtol
  1e-5 (measured <= 1.0e-6); under ``float32_fast`` rtol 3e-5 (measured
  <= 3.8e-6: the port spells out the 3-pass bf16 split, JAX's CPU backend
  takes ``Precision.HIGH`` as full f32).
* one HALS step: the largest difference over the largest entry 1e-5
  (measured 2.3e-7; ``float32_fast`` 1e-4, measured 1.3e-5).  HALS makes
  exact zeros, so entries are not compared one by one.
* solves of 20 iterations: factors rtol 1e-4 / atol 1e-6 and costs rel
  1e-5, as tests/test_torch_solver.py holds the KL solve; HALS factors by
  relative Frobenius norm 1e-4 (measured <= 2.2e-6 plain and 1.9e-5
  accelerated after 40 iterations); bf16 state: costs rel 1e-3, factors by
  relative Frobenius norm 5e-2, as tests/test_torch_accel.py holds it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.ops import divergence as jdiv  # noqa: E402
from nmf_tpu.ops import hals as jhals  # noqa: E402
from nmf_tpu.ops import mu as jmu  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.ops import divergence as tdiv  # noqa: E402
from nmf_tpu_torch.ops import hals as thals  # noqa: E402
from nmf_tpu_torch.ops import mu as tmu  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.config import Precision as TPrecision  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, to_tensor  # noqa: E402

EPS = float(np.float32(2.2204e-16))
BETAS = [0.0, 0.5, 1.0, 1.5, 2.0, 3.0]
POLICIES = ["float32", "bfloat16", "float32_fast"]
STEP_RTOL = {"float32": 1e-5, "bfloat16": 1e-5, "float32_fast": 3e-5}
HALS_TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float32_fast": 1e-4}
COST_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
FRO, BF16_FRO, BF16_COST_RTOL = 1e-4, 5e-2, 1e-3

# the families by their SolveConfig fields
FAMILIES = {
    "beta0": dict(beta=0.0),
    "beta0.5": dict(beta=0.5),
    "beta2": dict(beta=2.0),
    "beta3": dict(beta=3.0),
    "hals": dict(beta=2.0, algorithm="hals"),
    "kl_reg": dict(l1_w=0.1, l1_h=0.2, l2_w=0.3, l2_h=0.05),
}


def _problem(m=96, k=12, n=130, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(m, n).astype(np.float32) + 1e-3, rng.rand(m, k).astype(np.float32) + 1e-3,
            rng.rand(k, n).astype(np.float32) + 1e-3)


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _max_over_peak(ours, ref):
    ours, ref = _f32(ours), _f32(ref)
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


# ---- costs -----------------------------------------------------------------


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("beta", BETAS)
def test_beta_divergence_matches_jax(problem, beta, x_dtype):
    """Every beta (0, 1 and 2 dispatch to their named costs), on f32 X and
    on bf16 X (widened to f32 in both)."""
    x, w, h = problem
    if x_dtype == "bfloat16":
        import jax.numpy as jnp

        xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
        ref = float(jdiv.beta_divergence(jnp.asarray(xb), w, h, beta))
        ours = float(tdiv.beta_divergence(to_tensor(xb, "cpu"), *_t(w, h), beta))
    else:
        ref = float(jdiv.beta_divergence(x, w, h, beta))
        ours = float(tdiv.beta_divergence(*_t(x, w, h), beta))
    assert ours == pytest.approx(ref, rel=COST_RTOL)


@pytest.mark.parametrize("name", ["euclidean_cost", "itakura_saito", "kl_divergence"])
def test_named_costs_match_jax(problem, name):
    x, w, h = problem
    ref = float(getattr(jdiv, name)(x, w, h))
    assert float(getattr(pt, name)(*_t(x, w, h))) == pytest.approx(ref, rel=COST_RTOL)


@pytest.mark.parametrize("beta", [0.0, 0.5, 3.0])
def test_costs_clamp_x_like_jax(problem, beta):
    """Itakura-Saito and the general beta term clamp X as well as Y
    (``divergence.py:78-79, 98-104``): exact zeros in X give the same finite
    cost in both packages."""
    x, w, h = problem
    x = x.copy()
    x[::7, ::5] = 0.0
    ref = float(jdiv.beta_divergence(x, w, h, beta))
    ours = float(tdiv.beta_divergence(*_t(x, w, h), beta))
    assert np.isfinite(ours) and ours == pytest.approx(ref, rel=COST_RTOL)


# ---- one step --------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("beta", BETAS)
def test_mu_step_beta_matches_jax(problem, beta, policy):
    x, w, h = problem
    wj, hj = jmu.mu_step_beta(w, h, x, beta, EPS, jt.Precision(matmul_dtype=policy))
    wp, hp = tmu.mu_step_beta(*_t(w, h, x), beta, EPS, TPrecision(matmul_dtype=policy))
    rtol = STEP_RTOL[policy]
    np.testing.assert_allclose(_f32(hp), _f32(hj), rtol=rtol)
    np.testing.assert_allclose(_f32(wp), _f32(wj), rtol=rtol)


def test_mu_step_beta_takes_x_times_inv_squared_at_beta_0():
    """beta = 0 computes ``x * inv * inv`` (not a power) in both packages;
    on powers of two every rounding is exact, so the step is equal bit for
    bit."""
    x = np.full((8, 6), 2.0, np.float32)
    w = np.full((8, 2), 0.5, np.float32)
    h = np.full((2, 6), 4.0, np.float32)
    wj, hj = jmu.mu_step_beta(w, h, x, 0.0, EPS)
    wp, hp = tmu.mu_step_beta(*_t(w, h, x), 0.0, EPS)
    assert _f32(hp).tobytes() == _f32(hj).tobytes()
    assert _f32(wp).tobytes() == _f32(wj).tobytes()


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_mu_step_beta_keeps_the_state_dtype(problem, state):
    x, w, h = problem
    sd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state]
    wp, hp = tmu.mu_step_beta(*(t.to(sd) for t in _t(w, h)), torch.from_numpy(x), 2.0, EPS)
    assert wp.dtype == hp.dtype == sd


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("pens", [(0.1, 0.2, 0.3, 0.4), (0.0, 1.5, 0.0, 0.0), (0.0, 0.0, 2.0, 0.0)],
                         ids=["all", "l1_h", "l2_w"])
def test_mu_step_kl_reg_matches_jax(problem, policy, pens):
    x, w, h = problem
    l1_w, l1_h, l2_w, l2_h = pens
    wj, hj = jmu.mu_step_kl_reg(w, h, x, EPS, jt.Precision(matmul_dtype=policy),
                                l1_w=l1_w, l1_h=l1_h, l2_w=l2_w, l2_h=l2_h)
    wp, hp = tmu.mu_step_kl_reg(*_t(w, h, x), EPS, TPrecision(matmul_dtype=policy),
                                l1_w=l1_w, l1_h=l1_h, l2_w=l2_w, l2_h=l2_h)
    rtol = STEP_RTOL[policy]
    np.testing.assert_allclose(_f32(hp), _f32(hj), rtol=rtol)
    np.testing.assert_allclose(_f32(wp), _f32(wj), rtol=rtol)


def test_mu_step_kl_reg_without_penalties_is_mu_step(problem):
    """Zero penalties add exact zeros to the denominators: ``mu_step``'s
    bits."""
    x, w, h = problem
    wr, hr = tmu.mu_step_kl_reg(*_t(w, h, x), EPS)
    wm, hm = tmu.mu_step(*_t(w, h, x), EPS)
    assert torch.equal(wr, wm) and torch.equal(hr, hm)


# ---- HALS ------------------------------------------------------------------


@pytest.mark.parametrize("side", ["h", "w"])
def test_cd_sweep_matches_jax(problem, side):
    """One sweep on the same f32 products: the sweep's own dots are true
    f32 in both."""
    import jax.numpy as jnp

    x, w, h = problem
    if side == "h":
        a, b = w.T @ x, w.T @ w
        ref = jhals.cd_sweep_h(h, jnp.asarray(a), jnp.asarray(b), EPS)
        ours = thals.cd_sweep_h(*_t(h, a, b), EPS)
    else:
        a, b = x @ h.T, h @ h.T
        ref = jhals.cd_sweep_w(w, jnp.asarray(a), jnp.asarray(b), EPS)
        ours = thals.cd_sweep_w(*_t(w, a, b), EPS)
    assert _max_over_peak(ours, ref) <= HALS_TOL["float32"]


def test_cd_sweep_leaves_its_input_alone(problem):
    x, w, h = problem
    th = torch.from_numpy(h.copy())
    out = thals.cd_sweep_h(th, *_t(w.T @ x, w.T @ w), EPS)
    assert np.array_equal(th.numpy(), h) and out.dtype == th.dtype


@pytest.mark.parametrize("policy", POLICIES)
def test_hals_step_matches_jax(problem, policy):
    x, w, h = problem
    wj, hj = jhals.hals_step(w, h, x, EPS, jt.Precision(matmul_dtype=policy))
    wp, hp = thals.hals_step(*_t(w, h, x), EPS, TPrecision(matmul_dtype=policy))
    assert _max_over_peak(hp, hj) <= HALS_TOL[policy]
    assert _max_over_peak(wp, wj) <= HALS_TOL[policy]
    # the clipped coordinates: the same exact zeros
    assert np.array_equal(_f32(wp) == 0, _f32(wj) == 0)


# ---- solves ----------------------------------------------------------------

VARIANTS = {
    "f32": dict(),
    "accelerate": dict(accelerate=True),
    "int8_x": dict(precision=jt.Precision(x_dtype="int8")),
    "bf16_state": dict(precision=jt.Precision(state_dtype="bfloat16")),
}


def _counted_solve(fn):
    """(fn(), calls of each kernel wrapper) while ``fn`` runs."""
    names = ("update_h_fused", "update_w_fused", "mu_step_fused", "kl_cost_fused")
    calls = dict.fromkeys(names, 0)
    originals = {name: getattr(tfm, name) for name in names}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return call

    for name in names:
        setattr(tfm, name, counting(name))
    try:
        res = fn()
    finally:
        for name, f in originals.items():
            setattr(tfm, name, f)
    return res, calls


def _assert_solve_match(rj, rp, family, variant):
    for f in ("iterations", "num_checks", "converged"):
        assert int(getattr(rp, f)) == int(getattr(rj, f)), f
    bf16 = variant == "bf16_state"
    cost_rtol = BF16_COST_RTOL if bf16 else COST_RTOL
    hj, hp = np.asarray(rj.cost_history), _f32(rp.cost_history)
    np.testing.assert_array_equal(np.isnan(hp), np.isnan(hj))
    np.testing.assert_allclose(hp, hj, rtol=cost_rtol)
    assert float(rp.cost) == pytest.approx(float(rj.cost), rel=cost_rtol)
    for f in ("w", "h"):
        ours, ref = _f32(getattr(rp, f)), _f32(getattr(rj, f))
        if bf16 or family == "hals":
            fro = BF16_FRO if bf16 else FRO
            assert np.linalg.norm(ours - ref) <= fro * np.linalg.norm(ref), f
        else:
            np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    if variant == "accelerate":
        assert _f32(rp.momentum).tobytes() == np.asarray(rj.momentum, np.float32).tobytes()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_solve_family_matches_jax(family, variant):
    """``solve`` in each family, plain and accelerated, with int8 X and bf16
    state, against ``nmf_tpu.solve``; the kernel wrappers are never called
    (plain ops by rule, as JAX's ``solver.py:113-127``)."""
    x, w, h = _problem(48, 5, 40, seed=8)
    jcfg = jt.SolveConfig(max_iter=20, check_every=5, **FAMILIES[family], **VARIANTS[variant])
    rj = jt.solve(x, w, h, jcfg)
    rp, calls = _counted_solve(lambda: pt.solve(x, w, h, _pcfg(jcfg), device="cpu"))
    assert not any(calls.values()), calls
    _assert_solve_match(rj, rp, family, variant)


def test_kl_solve_goes_through_the_kernel_wrappers():
    """The contrast: the KL family calls K1-K3's wrappers (their plain
    versions on the CPU), 20 steps and 4 costs."""
    x, w, h = _problem(48, 5, 40, seed=8)
    _, calls = _counted_solve(
        lambda: pt.solve(x, w, h, pt.SolveConfig(max_iter=20, check_every=5), device="cpu"))
    assert calls == {"update_h_fused": 20, "update_w_fused": 20, "mu_step_fused": 20,
                     "kl_cost_fused": 4}


@pytest.mark.parametrize("family", ["beta2", "hals", "kl_reg"])
def test_pallas_backend_with_row_block_scales_runs_a_family(family):
    """JAX refuses per-row-block int8 scales under ``backend="pallas"`` for
    the KL kernels only; the families run on plain ops before that rule."""
    x, w, h = _problem(48, 5, 40, seed=8)
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, backend="pallas",
                          precision=jt.Precision(x_dtype="int8", x_quant_rows=16),
                          **FAMILIES[family])
    _assert_solve_match(jt.solve(x, w, h, jcfg), pt.solve(x, w, h, _pcfg(jcfg), device="cpu"),
                        family, "f32")


@pytest.mark.parametrize("family", ["beta2", "hals"])
def test_family_history_does_not_rise(family):
    """MU at beta >= 1 and HALS descend monotonically (checked every 5
    iterations over 40)."""
    x, w, h = _problem(48, 5, 40, seed=8)
    res = pt.solve(x, w, h, pt.SolveConfig(max_iter=40, check_every=5, **FAMILIES[family]),
                   device="cpu")
    hist = _f32(res.cost_history)
    assert np.all(np.diff(hist) <= 1e-6 * np.abs(hist[:-1])), hist


@pytest.mark.parametrize("kw,what", [(dict(live_metrics=True), "live_metrics"),
                                     (dict(backend="autotune"), "autotune")])
def test_still_refused(kw, what):
    """``live_metrics``, refused when this test was named, runs: in every
    family the emissions are JAX's (tests/test_torch_live.py's bars) and
    the bits are those of the run without it.  ``backend="autotune"``,
    refused when this test was named, runs in every family: on the CPU it
    measures nothing, the families take their plain ops, and the bits are
    those of ``auto``."""
    x, w, h = _problem(8, 2, 6)
    if what == "autotune":
        from test_torch_live import same_bits

        from nmf_tpu_torch.utils import autotune

        autotune.reset_counts()
        for fam in FAMILIES.values():
            cfg = dict(max_iter=10, check_every=5, **fam)
            res = pt.solve(x, w, h, pt.SolveConfig(**cfg, **kw), device="cpu")
            auto = pt.solve(x, w, h, pt.SolveConfig(**cfg), device="cpu")
            assert same_bits(res.w, auto.w) and same_bits(res.h, auto.h)
            assert same_bits(res.cost_history, auto.cost_history)
        assert autotune.MEASURED["pick_backend"] == 0
        return
    if what == "live_metrics":
        from test_torch_live import (assert_emissions_match, jax_emissions, port_emissions,
                                     same_bits)

        for fam in FAMILIES.values():
            cfg = dict(max_iter=10, check_every=5, **fam)
            res, ours = port_emissions(lambda: pt.solve(
                x, w, h, pt.SolveConfig(**cfg, **kw), device="cpu"))
            _, ref = jax_emissions(lambda: jt.solve(x, w, h, jt.SolveConfig(**cfg, **kw)))
            assert_emissions_match(ours, ref)
            off = pt.solve(x, w, h, pt.SolveConfig(**cfg), device="cpu")
            assert same_bits(res.w, off.w) and same_bits(res.h, off.h)
        return
