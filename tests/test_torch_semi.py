"""The port's ``solve_semi`` (``nmf_tpu_torch.models.semi``) against
``nmf_tpu.solve_semi`` on the CPU, and its endpoints within the port.

The same inputs, made from a seed with NumPy, go through both packages
(``torch.set_num_threads(1)``); the cases mirror tests/test_semi.py that
need no mesh.  Tolerances between the two packages: factors rtol 1e-5 /
atol 1e-6, costs rel 1e-5, and under
``bfloat16`` (bf16 state or GEMMs) costs rel 1e-3 and factors by relative
Frobenius norm 5e-2, as tests/test_torch_accel.py holds bf16 state.
Two variants drift further over 20 iterations and take the solve's rtol
1e-4 of tests/test_torch_solver.py: ``float32_fast`` (the port spells out
the 3-pass bf16 split, JAX's CPU backend takes it as full f32) and
``accelerate`` (each extrapolation scales a difference by up to 1 +
momentum); measured <= 1.9e-5 and 1.6e-5.
Within the port, under ``float32``: ``n_frozen == 0`` is bitwise the port's
``solve`` and ``n_frozen == K`` gives the H of ``solve_h_only`` bitwise
(the same K1 step on the same W), and the frozen columns are the clamped
initial columns bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict  # noqa: E402

RTOL, ATOL, COST_RTOL = 1e-5, 1e-6, 1e-5
DRIFT_RTOL = 1e-4          # float32_fast and accelerate (see above)
BF16_FRO, BF16_COST_RTOL = 5e-2, 1e-3
M, K, N = 48, 6, 40


def _problem(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(M, N).astype(np.float32) + 1e-3, rng.rand(M, K).astype(np.float32) + 1e-3,
            rng.rand(K, N).astype(np.float32) + 1e-3)


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _np(t):
    return t.detach().cpu().float().numpy()


def _bits(t):
    return _np(t).tobytes()


def _assert_match(rp, rj, bf16=False, rtol=RTOL):
    for f in ("iterations", "num_checks", "converged"):
        assert int(getattr(rp, f)) == int(getattr(rj, f)), f
    for f in ("w", "h"):
        ours, ref = _np(getattr(rp, f)), np.asarray(getattr(rj, f), np.float32)
        if bf16:
            assert np.linalg.norm(ours - ref) <= BF16_FRO * np.linalg.norm(ref), f
        else:
            np.testing.assert_allclose(ours, ref, rtol=rtol, atol=ATOL, err_msg=f)
    n = int(rj.num_checks)
    np.testing.assert_allclose(_np(rp.cost_history)[:n], np.asarray(rj.cost_history)[:n],
                               rtol=BF16_COST_RTOL if bf16 else COST_RTOL)


VARIANTS = {
    "kl": dict(),
    "beta2": dict(beta=2.0),
    "beta0.5": dict(beta=0.5),
    "reg": dict(l1_h=0.1, l2_w=0.2),
    "int8_x": dict(precision=jt.Precision(x_dtype="int8")),
    "bf16_x": dict(precision=jt.Precision(x_dtype="bfloat16")),
    "bfloat16": dict(precision=jt.Precision("bfloat16")),
    "float32_fast": dict(precision=jt.Precision("float32_fast")),
    "bf16_state": dict(precision=jt.Precision(state_dtype="bfloat16")),
    "accelerate": dict(accelerate=True),
}


@pytest.mark.parametrize("n_frozen", [0, 2, K])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_solve_semi_matches_jax(variant, n_frozen):
    """Each MU family and precision policy, nothing, some or all of W frozen."""
    x, w, h = _problem()
    jcfg = jt.SolveConfig(max_iter=20, check_every=5, **VARIANTS[variant])
    rj = jt.solve_semi(x, w, h, jcfg, n_frozen=n_frozen)
    rp = pt.solve_semi(x, w, h, _pcfg(jcfg), n_frozen=n_frozen, device="cpu")
    bf16 = variant in ("bfloat16", "bf16_state")
    _assert_match(rp, rj, bf16=bf16,
                  rtol=DRIFT_RTOL if variant in ("float32_fast", "accelerate") else RTOL)
    # the frozen columns are the prepped (state-dtype, clamped) W0 in both
    assert _np(rp.w)[:, :n_frozen].tobytes() == np.asarray(rj.w, np.float32)[:, :n_frozen].tobytes()


@pytest.mark.parametrize("accelerate", [False, True], ids=["plain", "accelerate"])
def test_n_frozen_0_is_bitwise_solve(accelerate):
    x, w, h = _problem()
    cfg = pt.SolveConfig(max_iter=20, check_every=5, accelerate=accelerate)
    rs = pt.solve_semi(x, w, h, cfg, n_frozen=0, device="cpu")
    r = pt.solve(x, w, h, cfg, device="cpu")
    for f in ("w", "h", "cost_history", "momentum"):
        assert _bits(getattr(rs, f)) == _bits(getattr(r, f)), f


def test_n_frozen_k_gives_h_only_bitwise():
    """All of W frozen: H is ``solve_h_only``'s bit for bit (K1 on the same
    W every step); W is the clamped W0."""
    x, w, h = _problem()
    w[0, 0] = 0.0
    cfg = pt.SolveConfig(max_iter=20, check_every=5)
    rs = pt.solve_semi(x, w, h, cfg, n_frozen=K, device="cpu")
    rh = pt.solve_h_only(x, w, h, cfg, device="cpu")
    assert _bits(rs.h) == _bits(rh.h)
    assert _bits(rs.w) == np.maximum(w, np.float32(cfg.eps)).tobytes()


@pytest.mark.parametrize("accelerate", [False, True], ids=["plain", "accelerate"])
def test_frozen_columns_bit_equal_to_clamped_templates_free_columns_train(accelerate):
    x, w, h = _problem()
    w[:, 1] = 0.0                      # clamped to eps at load, then frozen there
    cfg = pt.SolveConfig(max_iter=30, check_every=10, accelerate=accelerate)
    res = pt.solve_semi(x, w, h, cfg, n_frozen=3, device="cpu")
    want = np.maximum(w, np.float32(cfg.eps))
    assert _np(res.w)[:, :3].tobytes() == np.ascontiguousarray(want[:, :3]).tobytes()
    assert not np.allclose(_np(res.w)[:, 3:], w[:, 3:])
    assert not np.allclose(_np(res.h), h)


def test_inputs_are_not_written():
    x, w, h = _problem()
    copies = [a.copy() for a in (x, w, h)]
    wt = torch.from_numpy(w.copy())
    pt.solve_semi(x, wt, h, pt.SolveConfig(max_iter=5), n_frozen=2, device="cpu")
    for a, c in zip((x, w, h), copies):
        assert a.tobytes() == c.tobytes()
    assert wt.numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("beta", [1.0, 2.0])
def test_semi_cost_monotone(beta):
    """The MU families descend with frozen columns too (tests/test_semi.py)."""
    x, w, h = _problem()
    res = pt.solve_semi(x, w, h, pt.SolveConfig(max_iter=50, check_every=5, beta=beta),
                        n_frozen=2, device="cpu")
    hist = _np(res.cost_history)[: int(res.num_checks)]
    assert np.all(np.diff(hist) <= 1e-6 * np.abs(hist[:-1])), hist


def test_threshold_stops_on_the_jax_iteration():
    x, w, h = _problem()
    jcfg = jt.SolveConfig(max_iter=400, check_every=5, thresh=1e-3)
    rj = jt.solve_semi(x, w, h, jcfg, n_frozen=2)
    rp = pt.solve_semi(x, w, h, _pcfg(jcfg), n_frozen=2, device="cpu")
    assert bool(rp.converged) and int(rp.iterations) == int(rj.iterations) < 400
    _assert_match(rp, rj)


def test_kl_semi_goes_through_the_kernel_wrappers(monkeypatch):
    """The KL family's step and cost are K1-K3's wrappers (their plain
    versions on the CPU): 20 steps and 4 costs."""
    calls = {"update_h_fused": 0, "update_w_fused": 0, "kl_cost_fused": 0}
    for name in calls:
        orig = getattr(tfm, name)

        def counting(*a, _n=name, _f=orig, **kw):
            calls[_n] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(tfm, name, counting)
    x, w, h = _problem()
    pt.solve_semi(x, w, h, pt.SolveConfig(max_iter=20, check_every=5), n_frozen=2, device="cpu")
    assert calls == {"update_h_fused": 20, "update_w_fused": 20, "kl_cost_fused": 4}


def _messages(ours, ref, exc):
    with pytest.raises(exc) as e_ours:
        ours()
    with pytest.raises(exc) as e_ref:
        ref()
    return str(e_ours.value), str(e_ref.value)


@pytest.mark.parametrize(
    "case,exc",
    [("hals", NotImplementedError), ("pair", NotImplementedError), ("below", ValueError),
     ("above", ValueError), ("shape", ValueError)],
)
def test_refusals_match_jax(case, exc):
    x, w, h = _problem()
    kw, cfg = {"n_frozen": 1}, dict(max_iter=2)
    if case == "hals":
        cfg.update(beta=2.0, algorithm="hals")
    elif case == "pair":
        from nmf_tpu.ops.quant import quantize_columns_np

        x = quantize_columns_np(x, 1e-16)
        cfg.update(precision=jt.Precision(x_dtype="int8"))
    elif case == "below":
        kw["n_frozen"] = -1
    elif case == "above":
        kw["n_frozen"] = K + 1
    else:
        w = w[:-1]
    jcfg = jt.SolveConfig(**cfg)
    ours, ref = _messages(lambda: pt.solve_semi(x, w, h, _pcfg(jcfg), device="cpu", **kw),
                          lambda: jt.solve_semi(x, w, h, jcfg, **kw), exc)
    assert ours == ref


@pytest.mark.parametrize(
    "kw,match",
    [(dict(mesh=object()), "step 12"), (dict(config=pt.SolveConfig(live_metrics=True)), "live"),
     (dict(config=pt.SolveConfig(backend="autotune")), "autotune")],
    ids=["mesh", "live_metrics", "autotune"],
)
def test_unported_options_refused(kw, match):
    """``live_metrics``, refused when this test was named, runs: the
    emissions are JAX's (tests/test_torch_live.py's bars) and the bits
    those of the run without it."""
    x, w, h = _problem()
    if match == "live":
        from test_torch_live import (assert_emissions_match, jax_emissions, port_emissions,
                                     same_bits)

        cfg = dict(max_iter=20, check_every=5, live_metrics=True)
        res, ours = port_emissions(lambda: pt.solve_semi(x, w, h, pt.SolveConfig(**cfg),
                                                         n_frozen=1, device="cpu"))
        _, ref = jax_emissions(lambda: jt.solve_semi(x, w, h, jt.SolveConfig(**cfg), n_frozen=1))
        assert_emissions_match(ours, ref)
        off = pt.solve_semi(x, w, h, pt.SolveConfig(max_iter=20, check_every=5), n_frozen=1,
                            device="cpu")
        assert same_bits(res.w, off.w) and same_bits(res.h, off.h)
        return
    with pytest.raises(NotImplementedError, match=match):
        pt.solve_semi(x, w, h, n_frozen=1, device="cpu", **kw)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    x, w, h = _problem()
    with pytest.raises(RuntimeError, match="is_available"):
        pt.solve_semi(x, w, h, pt.SolveConfig(max_iter=1), n_frozen=1)


def test_public_name():
    from nmf_tpu_torch.models import semi

    assert pt.solve_semi is semi.solve_semi and "solve_semi" in pt.__all__
