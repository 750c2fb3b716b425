"""The port's ``solve`` on the CPU against ``nmf_tpu.solve``.

Tolerances: cost history rel 1e-5 and factors rtol 1e-4 / atol 1e-6 (the
two packages' f32 GEMMs sum in different orders; over 50-230 iterations the
factors drift apart by at most ~6e-5 relative at these sizes), iteration
counts and flags exact.  The full reference workload is held to the pinned
final cost of tests/test_parity.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.convert import (  # noqa: E402
    RESULT_FIELDS,
    config_from_dict,
    result_to_numpy,
    state_from_numpy,
)

from oracle import clamp  # noqa: E402

COST_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-6
PIN_COST = 96689.73  # tests/test_parity.py:144


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(11)
    m, k, n = 96, 12, 130
    return (
        clamp(rng.rand(m, n).astype(np.float32)),
        clamp(rng.rand(m, k).astype(np.float32)),
        clamp(rng.rand(k, n).astype(np.float32)),
    )


def _jax_dict(res):
    return {f: None if getattr(res, f) is None else np.asarray(getattr(res, f))
            for f in RESULT_FIELDS}


def _both(problem, jcfg, port_backend=None):
    """Both packages on the same config; ``port_backend`` overrides the
    port's backend (the JAX package's Pallas backend compiles only for a
    TPU, so its side keeps ``auto``, which is its jnp path on the CPU)."""
    x, w, h = problem
    rj = _jax_dict(jt.solve(x, w, h, jcfg))
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    if port_backend is not None:
        pcfg = dataclasses.replace(pcfg, backend=port_backend)
    rp = result_to_numpy(pt.solve(x, w, h, pcfg, device="cpu"))
    return rj, rp


def _assert_same_run(rj, rp):
    for f in ("iterations", "num_checks", "converged"):
        assert rp[f] == rj[f], f
    assert rp["cost_history"].shape == rj["cost_history"].shape
    assert rp["cost_history"].dtype == np.float32
    np.testing.assert_array_equal(np.isnan(rp["cost_history"]), np.isnan(rj["cost_history"]))
    np.testing.assert_allclose(rp["cost_history"], rj["cost_history"], rtol=COST_RTOL)
    np.testing.assert_allclose(rp["cost"], rj["cost"], rtol=COST_RTOL)
    np.testing.assert_allclose(rp["w"], rj["w"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rp["h"], rj["h"], rtol=RTOL, atol=ATOL)
    assert np.isnan(rp["momentum"]) and np.isnan(rj["momentum"])


@pytest.mark.parametrize("backend", ["auto", "jnp", "pallas"])
def test_thresh0_50_iterations_matches_jax(problem, backend):
    rj, rp = _both(problem, jt.SolveConfig(max_iter=50, check_every=25), backend)
    _assert_same_run(rj, rp)
    assert int(rp["iterations"]) == 50 and int(rp["num_checks"]) == 2
    assert not bool(rp["converged"])


def test_tail_chunk_matches_jax(problem):
    """max_iter=60: checks at 25, 50 and a short last block ending at 60."""
    rj, rp = _both(problem, jt.SolveConfig(max_iter=60, check_every=25))
    _assert_same_run(rj, rp)
    assert int(rp["num_checks"]) == 3 and rp["cost_history"].shape == (3,)


def test_thresh_early_stop_matches_jax(problem):
    """thresh>0 stops at the same check; the relative change there (~9.7e-4
    against 1e-3) is far from the threshold next to the 1e-5 cost tolerance."""
    rj, rp = _both(problem, jt.SolveConfig(max_iter=500, check_every=10, thresh=1e-3))
    _assert_same_run(rj, rp)
    assert bool(rp["converged"]) and int(rp["iterations"]) < 500
    hist = rp["cost_history"]
    assert np.isnan(hist[int(rp["num_checks"]):]).all()


def test_untracked_run_has_no_checks(problem):
    rj, rp = _both(problem, jt.SolveConfig(max_iter=30, check_every=10, track_cost=False))
    assert int(rp["num_checks"]) == int(rj["num_checks"]) == 0
    assert int(rp["iterations"]) == 30
    assert np.isnan(rp["cost"]) and np.isnan(rj["cost"])
    assert np.isnan(rp["cost_history"]).all() and rp["cost_history"].shape == (3,)
    np.testing.assert_allclose(rp["w"], rj["w"], rtol=RTOL, atol=ATOL)


def test_zero_iterations(problem):
    rj, rp = _both(problem, jt.SolveConfig(max_iter=0))
    assert int(rp["iterations"]) == 0 and int(rp["num_checks"]) == 0
    assert rp["cost_history"].shape == rj["cost_history"].shape == (1,)
    np.testing.assert_array_equal(rp["w"], clamp(problem[1]))


def test_unclamped_inputs_match_jax(problem):
    x, w, h = problem
    cfg = jt.SolveConfig(max_iter=20, check_every=10)
    rj = _jax_dict(jt.solve(x, w, h, cfg, clamp_inputs=False))
    rp = result_to_numpy(pt.solve(x, w, h, config_from_dict(dataclasses.asdict(cfg)),
                                  clamp_inputs=False, device="cpu"))
    _assert_same_run(rj, rp)


def test_inputs_not_modified(problem):
    x, w, h = problem
    w_t = torch.from_numpy(w.copy())
    pt.solve(x, w_t, h, pt.SolveConfig(max_iter=5), device="cpu")
    np.testing.assert_array_equal(w_t.numpy(), w)


def test_backends_agree_bitwise_on_cpu(problem):
    """On the CPU the kernel wrappers run the plain ops: same bits."""
    x, w, h = problem
    ra = pt.solve(x, w, h, pt.SolveConfig(max_iter=30, check_every=10), device="cpu")
    rb = pt.solve(x, w, h, pt.SolveConfig(max_iter=30, check_every=10, backend="jnp"),
                  device="cpu")
    assert torch.equal(ra.w, rb.w) and torch.equal(ra.h, rb.h)
    assert torch.equal(ra.cost_history, rb.cost_history)


def test_shape_mismatch_raises_like_jax(problem):
    x, w, h = problem
    with pytest.raises(ValueError) as ej:
        jt.solve(x, w[:, :5], h)
    with pytest.raises(ValueError) as et:
        pt.solve(x, w[:, :5], h, device="cpu")
    assert str(et.value) == str(ej.value)
    assert "shape mismatch" in str(et.value)


def test_prequantized_pair_requires_int8(problem):
    x, w, h = problem
    pair = (x.astype(np.uint8), np.ones(x.shape[1], np.float32))
    with pytest.raises(ValueError) as ej:
        jt.solve(pair, w, h)
    with pytest.raises(ValueError) as et:
        pt.solve(pair, w, h, device="cpu")
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize(
    "kw",
    [
        {"accelerate": True},
        {"live_metrics": True},
        {"beta": 2.0},
        {"beta": 2.0, "algorithm": "hals"},
        {"l1_w": 0.1},
        {"precision": pt.Precision("bfloat16")},
        {"precision": pt.Precision(x_dtype="int8")},
        {"backend": "autotune"},
    ],
)
def test_unported_options_raise(problem, kw):
    """Options still to port raise; the precision policies, ``accelerate``,
    ``live_metrics`` and the beta, HALS and penalized families, refused when
    this test was named, run and match ``nmf_tpu.solve`` (bf16 GEMMs: cost rel 1e-4; 2
    iterations keep the factors within rtol 2e-3; ``accelerate`` and the
    families: this file's tolerances, and the momentum bit for bit).
    ``backend="autotune"``, refused when this test was named, runs too: on
    CPU tensors it measures nothing and gives the bits of ``auto`` (the
    wrappers' plain versions), within this file's tolerances of
    ``nmf_tpu``'s autotune solve (its jnp path off a TPU)."""
    x, w, h = problem
    if "accelerate" in kw or "beta" in kw or "l1_w" in kw:
        rj = _jax_dict(jt.solve(x, w, h, jt.SolveConfig(max_iter=2, **kw)))
        rp = result_to_numpy(pt.solve(x, w, h, pt.SolveConfig(max_iter=2, **kw), device="cpu"))
        for f in ("iterations", "num_checks", "converged"):
            assert rp[f] == rj[f], f
        assert int(rp["iterations"]) == 2 and int(rp["num_checks"]) == 1
        np.testing.assert_allclose(rp["cost_history"], rj["cost_history"], rtol=COST_RTOL)
        for f in ("w", "h"):
            if kw.get("algorithm") == "hals":   # exact zeros: tests/test_torch_families.py's norm
                assert np.linalg.norm(rp[f] - rj[f]) <= 1e-4 * np.linalg.norm(rj[f]), f
            else:
                np.testing.assert_allclose(rp[f], rj[f], rtol=RTOL, atol=ATOL)
        assert rp["momentum"].tobytes() == rj["momentum"].tobytes()
        return
    if "live_metrics" in kw:
        # ported: the emissions are JAX's (tests/test_torch_live.py's bars)
        from test_torch_live import assert_emissions_match, jax_emissions, port_emissions

        rp, ours = port_emissions(lambda: pt.solve(x, w, h, pt.SolveConfig(max_iter=2, **kw),
                                                   device="cpu"))
        _, ref = jax_emissions(lambda: jt.solve(x, w, h, jt.SolveConfig(max_iter=2, **kw)))
        assert len(ours) == int(rp.num_checks) == 1
        assert_emissions_match(ours, ref)
        return
    if "backend" in kw:
        from nmf_tpu_torch.utils import autotune

        autotune.reset_counts()
        rj = _jax_dict(jt.solve(x, w, h, jt.SolveConfig(max_iter=2, **kw)))
        res = pt.solve(x, w, h, pt.SolveConfig(max_iter=2, **kw), device="cpu")
        auto = pt.solve(x, w, h, pt.SolveConfig(max_iter=2), device="cpu")
        assert autotune.MEASURED["pick_backend"] == 0
        assert autotune.CHOICES[("solve", "pallas")] == 2
        rp = result_to_numpy(res)
        for f in ("w", "h", "cost_history"):
            assert getattr(res, f).numpy().tobytes() == getattr(auto, f).numpy().tobytes(), f
            np.testing.assert_allclose(rp[f], rj[f], rtol=RTOL, atol=ATOL)
        return
    jprec = jt.Precision(*dataclasses.astuple(kw["precision"]))
    rj = jt.solve(x, w, h, jt.SolveConfig(max_iter=2, precision=jprec))
    rp = result_to_numpy(pt.solve(x, w, h, pt.SolveConfig(max_iter=2, **kw), device="cpu"))
    assert int(rp["iterations"]) == 2 and int(rp["num_checks"]) == 1
    np.testing.assert_allclose(rp["cost"], np.asarray(rj.cost), rtol=1e-4)
    np.testing.assert_allclose(rp["w"], np.asarray(rj.w), rtol=2e-3, atol=ATOL)


def test_cuda_request_without_a_card_raises(problem):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    x, w, h = problem
    with pytest.raises(RuntimeError, match="is_available"):
        pt.solve(x, w, h, pt.SolveConfig(max_iter=2))
    with pytest.raises(RuntimeError, match="is_available"):
        state_from_numpy(x, w, h, device="cuda")


def test_invalid_config_raises_like_jax():
    for kw in ({"max_iter": -1}, {"check_every": 0}, {"thresh": -1.0},
               {"backend": "triton"}, {"algorithm": "als"}):
        with pytest.raises(ValueError) as ej:
            jt.SolveConfig(**kw).validate()
        with pytest.raises(ValueError) as et:
            pt.SolveConfig(**kw).validate()
        assert str(et.value) == str(ej.value)


def test_convert_round_trips_jax_config():
    jcfg = jt.SolveConfig(
        max_iter=77, thresh=1e-4, check_every=7, backend="jnp", track_cost=False,
        precision=jt.Precision("float32_fast", "float32", "int8", 16),
        accelerate=True, accel_momentum=0.3, l1_w=0.5,
    )
    ours = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(ours) == dataclasses.asdict(jcfg)
    assert ours.num_checks == jcfg.num_checks and ours.regularized == jcfg.regularized
    assert dataclasses.asdict(pt.reference_preset()) == dataclasses.asdict(jt.reference_preset())
    assert dataclasses.asdict(pt.SolveConfig()) == dataclasses.asdict(jt.SolveConfig())
    with pytest.raises(TypeError):
        config_from_dict({"max_iter": 3, "no_such_field": 1})


def test_state_from_numpy_on_cpu(problem):
    x, w, h = problem
    xt, wt, ht = state_from_numpy(x, w.astype(np.float64), h, device="cpu")
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (xt, wt, ht))
    np.testing.assert_array_equal(wt.numpy(), w)


def test_summarize_result_matches_jax(problem):
    """The metrics layer reads both packages' results the same way."""
    from nmf_tpu.utils.metrics import summarize_result as jsum
    from nmf_tpu_torch.utils.metrics import summarize_result as tsum

    x, w, h = problem
    cfg = jt.SolveConfig(max_iter=60, check_every=25)
    rj = jt.solve(x, w, h, cfg)
    rp = pt.solve(x, w, h, config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    aj = dataclasses.asdict(jsum(rj, x.shape, 2.0, check_every=25))
    ap = dataclasses.asdict(tsum(rp, x.shape, 2.0, check_every=25))
    for key in ("m", "k", "n", "iterations", "converged", "seconds", "iters_per_sec",
                "achieved_tflops"):
        assert ap[key] == aj[key], key
    assert [c["iteration"] for c in ap["checks"]] == [25, 50, 60]
    assert [c["iteration"] for c in ap["checks"]] == [c["iteration"] for c in aj["checks"]]
    np.testing.assert_allclose([c["cost"] for c in ap["checks"]],
                               [c["cost"] for c in aj["checks"]], rtol=COST_RTOL)


def test_full_reference_workload_pin():
    """4096x350, K=128, 200 iterations on the seed-0 fixtures (the reference
    pipeline, plain path on the CPU): the pinned cost within 1e-4 and 8
    strictly decreasing checks; the wrappers launched nothing."""
    fx = pt.fixtures
    arrays = {k: fx.as_seen_by_solver(v) for k, v in fx.reference_fixture_arrays().items()}
    tfm.reset_counts()
    res = pt.solve(arrays["X"], arrays["W"], arrays["H"], pt.reference_preset(), device="cpu")
    assert int(res.iterations) == 200 and not bool(res.converged)
    hist = res.cost_history.numpy()[: int(res.num_checks)]
    assert hist.shape == (8,)
    assert np.all(np.diff(hist) < 0)
    assert float(res.cost) == pytest.approx(PIN_COST, rel=1e-4)
    assert tuple(res.w.shape) == (4096, 128) and tuple(res.h.shape) == (128, 350)
    assert not any(tfm.LAUNCHES.values())


@pytest.mark.parametrize("accel", [False, True], ids=["plain", "accelerated"])
def test_solve_jit_gives_solves_bits_and_is_cached(problem, accel):
    """``solve_jit(config)`` (``nmf_tpu.models.solver.solve_jit``'s
    counterpart) on tensors prepared as ``solve`` prepares them gives the
    bits of ``solve``; a second call with an equal config (and platform)
    returns the same object, and the caller's W and H keep their values
    (JAX donates them; nothing here writes into them)."""
    from nmf_tpu_torch.models import solver as ps

    x, w, h = problem
    cfg = pt.SolveConfig(max_iter=12, check_every=5, accelerate=accel)
    ref = pt.solve(x, w, h, cfg, device="cpu")
    xp, wp, hp = ps._prep(x, w, h, cfg, True, torch.device("cpu"))
    w_before, h_before = wp.clone(), hp.clone()
    fn = ps.solve_jit(cfg, "cpu")
    assert ps.solve_jit(pt.SolveConfig(max_iter=12, check_every=5, accelerate=accel), "cpu") is fn
    assert ps.solve_jit(cfg) is not fn and "solve_jit" in ps.__all__
    res = fn(xp, wp, hp, torch.tensor(float("nan")))
    for f in ("w", "h", "cost", "cost_history", "iterations", "num_checks", "converged"):
        assert getattr(res, f).numpy().tobytes() == getattr(ref, f).numpy().tobytes(), f
    assert torch.equal(wp, w_before) and torch.equal(hp, h_before)
    with pytest.raises(ValueError, match="platform"):
        ps.solve_jit(cfg, "tpu")
