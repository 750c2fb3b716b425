"""The precision tiers of the port against ``nmf_tpu`` on the CPU.

Every policy of ``Precision``: GEMMs in ``float32``, ``float32_fast``
(3-pass bf16 split) or ``bfloat16``; X as f32, bf16 or uint8 codes with
per-column or per-row-block scales; W and H in f32 or bf16.  The same
inputs, made from a seed with NumPy, go through the JAX function and the
port's counterpart: ``ops.mu`` per policy, the kernel wrappers' CPU routes
against the Pallas kernels in interpret mode (as ``tests/test_pallas.py``
runs them), ``solve`` for every CLI tier, and the CLI itself.

Tolerances, between two packages whose sums run in other orders.  They are
wide enough that a bf16 rounding or split skipped in an update could hide
in them, so ``test_matmul_policies_are_spelled_out`` holds the policies
themselves to rtol 1e-6 (``chip_smoke.py`` holds the CUDA kernels to
limits that a control without the rounding fails):

* f32-GEMM modes (f32, bf16 or int8 X, ``float32_fast``): factors rtol 1e-4
  / atol 1e-6, costs rel 1e-5.  ``float32_fast`` is held against JAX's
  ``ops.mu``, which XLA:CPU computes as true f32, at the same rtol 1e-4
  (the split drops the lo*lo term, ~2^-16 relative per product).
* bf16-GEMM modes: factors rtol 2e-3 / atol 1e-6, costs rel 1e-4: a last-ulp
  difference in W H between the two packages may flip the bf16 rounding of
  a Z entry.
* bf16 state: one bf16 ulp more (rtol 2**-7 + 2e-3), the output being
  rounded to bf16 after sums taken in another order.
* Solves of 30 iterations under bf16 GEMMs: costs rel 1e-4, factors rtol
  2e-2.  One flipped Z rounding moves every later iterate by ~2^-9, and
  the flips compound: measured up to 1.1e-2 after 30 iterations at
  64 x 48, K=8 (one call agrees to 3e-7).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import nmf_tpu as jt  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu.ops import divergence as jdiv  # noqa: E402
from nmf_tpu.ops import mu as jmu  # noqa: E402
from nmf_tpu.ops import quant as jq  # noqa: E402
from nmf_tpu.ops.pallas import fused_mu as jfm  # noqa: E402
from nmf_tpu.utils import config as jcfg  # noqa: E402
from nmf_tpu_torch import cli  # noqa: E402
from nmf_tpu_torch.io import binio  # noqa: E402
from nmf_tpu_torch.ops import divergence as tdiv  # noqa: E402
from nmf_tpu_torch.ops import mu as tmu  # noqa: E402
from nmf_tpu_torch.ops import quant as tq  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils import config as tcfg  # noqa: E402
from nmf_tpu_torch.utils.convert import (  # noqa: E402
    config_from_dict,
    result_to_numpy,
    state_from_numpy,
)

from oracle import clamp  # noqa: E402

EPS = np.float32(2.2204e-16)
F32_TOL = (1e-4, 1e-6, 1e-5)             # factors rtol, atol; cost rel
BF16_TOL = (2e-3, 1e-6, 1e-4)
BF16_STATE_TOL = (2.0 ** -7 + 2e-3, 1e-6, 1e-4)
SOLVE_BF16_RTOL = 2e-2
BLOCKS = dict(interpret=True, block_m=32, block_n=128)

# kernel modes: name -> (JAX Precision fields, state bf16, X form, tolerance)
MODES = {
    "bfloat16": (("bfloat16", "float32", "float32"), False, "f32", BF16_TOL),
    "float32_fast": (("float32_fast", "float32", "float32"), False, "f32", F32_TOL),
    "x_bfloat16": (("float32", "float32", "bfloat16"), False, "bf16", F32_TOL),
    "x_int8": (("float32", "float32", "int8"), False, "int8", F32_TOL),
    "bf16_full_state": (("bfloat16", "bfloat16", "bfloat16"), True, "bf16", BF16_STATE_TOL),
}
# CLI tiers: flags -> the JAX Precision the JAX CLI builds from them
TIERS = {
    "bfloat16": (["--dtype", "bfloat16"], jt.Precision("bfloat16")),
    "float32_fast": (["--dtype", "float32_fast"], jt.Precision("float32_fast")),
    "x_bfloat16": (["--x-dtype", "bfloat16"], jt.Precision(x_dtype="bfloat16")),
    "x_int8": (["--x-dtype", "int8"], jt.Precision(x_dtype="int8")),
    "x_int8_rows16": (["--x-dtype", "int8", "--x-quant-rows", "16"],
                      jt.Precision(x_dtype="int8", x_quant_rows=16)),
}


@pytest.fixture(autouse=True)
def _zero_counts():
    tfm.reset_counts()
    yield
    tfm.reset_counts()


def _problem(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return (clamp(rng.rand(m, n).astype(np.float32)),
            clamp(rng.rand(m, k).astype(np.float32)),
            clamp(rng.rand(k, n).astype(np.float32)))


@pytest.fixture(scope="module")
def problem():
    return _problem(96, 12, 130, 7)


@pytest.fixture(scope="module")
def small():
    return _problem(64, 8, 48, 5)


def _bf16_t(a: np.ndarray) -> torch.Tensor:
    """``a`` rounded to bf16 by ml_dtypes (as JAX rounds), as a torch tensor."""
    bits = np.asarray(a).astype(ml_dtypes.bfloat16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _operands(problem, mode):
    """(torch w, h, x) and (JAX w, h, x) for a kernel mode."""
    x, w, h = problem
    _, state_bf16, xform, _ = MODES[mode]
    if state_bf16:
        wt, ht = _bf16_t(w), _bf16_t(h)
        wj, hj = jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(h).astype(jnp.bfloat16)
    else:
        wt, ht = torch.from_numpy(w), torch.from_numpy(h)
        wj, hj = jnp.asarray(w), jnp.asarray(h)
    if xform == "bf16":
        xt, xj = _bf16_t(x), jnp.asarray(x).astype(jnp.bfloat16)
    elif xform == "int8":
        q, s = jq.quantize_columns_np(x, EPS)
        xt, xj = (torch.from_numpy(q), torch.from_numpy(s)), (jnp.asarray(q), jnp.asarray(s))
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    return (wt, ht, xt), (wj, hj, xj)


def _precisions(mode):
    fields = MODES[mode][0]
    return tcfg.Precision(*fields), jcfg.Precision(*fields)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(ours, ref, tol):
    rtol, atol, _ = tol
    np.testing.assert_allclose(_np(ours), np.asarray(ref).astype(np.float32), rtol=rtol, atol=atol)


# --- ops.mu per policy -------------------------------------------------------


@pytest.mark.parametrize("policy", ["float32", "float32_fast", "bfloat16"])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True)])
def test_matmul_matches_jax(problem, policy, ta, tb):
    x, w, h = problem
    a, b = {(False, False): (w, h), (True, False): (w, x), (False, True): (x, h)}[(ta, tb)]
    ours = tmu.matmul(torch.from_numpy(a), torch.from_numpy(b), tcfg.Precision(policy),
                      transpose_a=ta, transpose_b=tb)
    ref = jmu.matmul(jnp.asarray(a), jnp.asarray(b), jcfg.Precision(policy),
                     transpose_a=ta, transpose_b=tb)
    assert ours.dtype == torch.float32
    rtol = {"float32": 1e-5, "float32_fast": 1e-4, "bfloat16": 1e-5}[policy]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol, atol=1e-6)


def test_matmul_policies_are_spelled_out(problem):
    """bf16: products of bf16-rounded operands summed in f32 (not a bf16
    sum); float32_fast: hi@bh + hi@bl + lo@bh of the bf16 split, here
    rebuilt with ml_dtypes' rounding."""
    _, w, h = problem
    bf = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float32)  # noqa: E731
    wt, ht = torch.from_numpy(w), torch.from_numpy(h)
    ours = tmu.matmul(wt, ht, tcfg.Precision("bfloat16")).numpy()
    np.testing.assert_allclose(ours, bf(w) @ bf(h), rtol=1e-6, atol=0)
    wl, hl = bf(w - bf(w)), bf(h - bf(h))
    split = bf(w) @ bf(h) + bf(w) @ hl + wl @ bf(h)
    ours = tmu.matmul(wt, ht, tcfg.Precision("float32_fast")).numpy()
    np.testing.assert_allclose(ours, split, rtol=1e-6, atol=0)
    assert np.abs(ours - w.astype(np.float64) @ h).max() < 1e-4 * np.abs(w @ h).max()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["update_h", "update_w"])
def test_update_matches_jax_ops(problem, mode, kind):
    (wt, ht, xt), (wj, hj, xj) = _operands(problem, mode)
    if isinstance(xt, tuple):  # ops.mu takes dense X: dequantized, bit for bit
        xt, xj = tq.dequantize(*xt), jq.dequantize(*xj)
    tp, jp = _precisions(mode)
    ours = getattr(tmu, kind)(wt, ht, xt, EPS, tp)
    ref = getattr(jmu, kind)(wj, hj, xj, EPS, jp)
    assert ours.dtype == wt.dtype
    _close(ours, ref, MODES[mode][3])


def test_kl_divergence_bf16_x_and_state_matches_jax(problem):
    (wt, ht, xt), (wj, hj, xj) = _operands(problem, "bf16_full_state")
    ours = float(tdiv.kl_divergence(xt, wt, ht))
    ref = float(jdiv.kl_divergence(xj, wj, hj))
    assert ours == pytest.approx(ref, rel=F32_TOL[2])


# --- the kernel wrappers' CPU routes against the Pallas kernels ---------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["update_h", "update_w"])
def test_fused_update_matches_pallas(problem, mode, kind):
    (wt, ht, xt), (wj, hj, xj) = _operands(problem, mode)
    tp, jp = _precisions(mode)
    ours = getattr(tfm, f"{kind}_fused")(wt, ht, xt, EPS, tp)
    ref = getattr(jfm, f"{kind}_fused")(wj, hj, xj, EPS, jp, **BLOCKS)
    assert ours.dtype == wt.dtype
    assert ours.shape == (wt if kind == "update_w" else ht).shape
    _close(ours, ref, MODES[mode][3])
    assert not any(tfm.LAUNCHES.values())


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_cost_matches_pallas(problem, mode):
    (wt, ht, xt), (wj, hj, xj) = _operands(problem, mode)
    tp, jp = _precisions(mode)
    ours = tfm.kl_cost_fused(xt, wt, ht, EPS, tp)
    ref = jfm.kl_cost_fused(xj, wj, hj, EPS, jp, **BLOCKS)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    assert float(ours) == pytest.approx(float(ref), rel=MODES[mode][3][2])


def test_fused_cost_bf16_takes_the_bf16_recon(problem):
    """Under bfloat16 K3 reconstructs from bf16-rounded W and H
    (fused_mu.py:586-591): the CPU route does too, and differs from the
    true-f32 kl_divergence by more than the f32 tolerance."""
    x, w, h = problem
    xt, wt, ht = (torch.from_numpy(a) for a in (x, w, h))
    bf = tfm.kl_cost_fused(xt, wt, ht, EPS, tcfg.Precision("bfloat16"))
    f32 = tfm.kl_cost_fused(xt, wt, ht, EPS, tcfg.Precision())
    ref_bf = jfm.kl_cost_fused(*(jnp.asarray(a) for a in (x, w, h)), EPS,
                               jcfg.Precision("bfloat16"), **BLOCKS)
    assert float(bf) == pytest.approx(float(ref_bf), rel=1e-5)
    assert float(f32) == pytest.approx(float(tdiv.kl_divergence(xt, wt, ht)), rel=0)
    assert abs(float(bf) - float(f32)) > 1e-5 * abs(float(f32))


@pytest.mark.parametrize("mode", ["bfloat16", "x_int8", "bf16_full_state"])
def test_fused_step_three_iterations_matches_pallas(problem, mode):
    (wt, ht, xt), (wj, hj, xj) = _operands(problem, mode)
    tp, jp = _precisions(mode)
    for _ in range(3):
        wt, ht = tfm.mu_step_fused(wt, ht, xt, EPS, tp)
        wj, hj = jfm.mu_step_fused(wj, hj, xj, EPS, jp, interpret=True)
    rtol, atol, _ = MODES[mode][3]
    rtol = max(rtol, 5e-5)   # compounding over 3 steps, as test_pallas allows
    np.testing.assert_allclose(_np(wt), np.asarray(wj).astype(np.float32), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(ht), np.asarray(hj).astype(np.float32), rtol=rtol, atol=atol)


def test_kernel_checks_refuse_missing_modes(problem):
    """What the CUDA kernels lack raises before any launch: per-row-block
    scales, mixed or f16 state, f16 X.  (The checks read only dtypes and
    shapes, so they run here on CPU tensors.)"""
    x, w, h = problem
    wt, ht, xt = (torch.from_numpy(a) for a in (w, h, x))
    q, s = tq.quantize_rowblocks(xt, EPS, 16)
    with pytest.raises(NotImplementedError, match="per-row-block"):
        tfm._check_cuda_operands(wt, ht, (q, s))
    with pytest.raises(NotImplementedError, match="both float32 or both bfloat16"):
        tfm._check_cuda_operands(wt, ht.to(torch.bfloat16), xt)
    with pytest.raises(NotImplementedError, match="both float32 or both bfloat16"):
        tfm._check_cuda_operands(wt.half(), ht.half(), xt)
    with pytest.raises(NotImplementedError, match="float16"):
        tfm._check_cuda_operands(wt, ht, xt.half())
    qc, sc = tq.quantize_columns(xt, EPS)
    m, n, k, xd, scales = tfm._check_cuda_operands(wt, ht, (qc, sc))
    assert (m, n, k) == (x.shape[0], x.shape[1], w.shape[1])
    assert xd is qc and scales.dtype == torch.float32
    assert tfm._modes(wt, xd, tcfg.Precision("float32_fast")) == (0, 2, 1)
    assert tfm._modes(wt.to(torch.bfloat16), xt.to(torch.bfloat16),
                      tcfg.Precision("bfloat16")) == (1, 1, 2)


# --- solve for every tier ------------------------------------------------------


def _solve_both(data, jprec, backend, **kw):
    x, w, h = data
    cfg = jt.SolveConfig(max_iter=30, check_every=10, precision=jprec)
    rj = jt.solve(x, w, h, cfg, **kw)
    pcfg = dataclasses.replace(config_from_dict(dataclasses.asdict(cfg)), backend=backend)
    rp = pt.solve(x, w, h, pcfg, device="cpu", **kw)
    return rj, rp


def _assert_solves_agree(rj, rp, prec):
    out = result_to_numpy(rp)
    for f in ("iterations", "num_checks", "converged"):
        assert out[f] == np.asarray(getattr(rj, f)), f
    assert rp.w.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[prec.state_dtype]
    bf16_gemm = prec.matmul_dtype == "bfloat16"
    cost_rtol = BF16_TOL[2] if bf16_gemm else F32_TOL[2]
    rtol = SOLVE_BF16_RTOL if bf16_gemm else F32_TOL[0]
    np.testing.assert_allclose(out["cost_history"], np.asarray(rj.cost_history), rtol=cost_rtol)
    for f in ("w", "h"):
        np.testing.assert_allclose(out[f], np.asarray(getattr(rj, f)).astype(np.float32),
                                   rtol=rtol, atol=F32_TOL[1])
    hist = out["cost_history"]
    assert hist.shape == (3,) and np.all(np.diff(hist) < 0)


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_solve_tier_matches_jax(small, tier, backend):
    prec = TIERS[tier][1]
    rj, rp = _solve_both(small, prec, backend)
    _assert_solves_agree(rj, rp, prec)


@pytest.mark.parametrize("backend", ["auto", "jnp"])
def test_solve_bf16_state_matches_jax(small, backend):
    prec = dataclasses.replace(jcfg.BF16_FULL, state_dtype="bfloat16")
    rj, rp = _solve_both(small, prec, backend)
    _assert_solves_agree(rj, rp, prec)


@pytest.mark.parametrize("rows", [0, 16])
def test_solve_prequantized_pair_matches_jax(small, rows):
    """A (codes, scales) pair passes through untouched (no clamp, no
    requantization), in both packages."""
    x, w, h = small
    pair = jq.quantize_policy_np(x, EPS, rows)
    prec = jt.Precision(x_dtype="int8", x_quant_rows=rows)
    rj, rp = _solve_both((pair, w, h), prec, "auto")
    _assert_solves_agree(rj, rp, prec)
    rq, _ = _solve_both(small, prec, "auto")
    np.testing.assert_array_equal(np.asarray(rq.w), np.asarray(rj.w))


@pytest.mark.parametrize("prec", [jt.Precision(x_dtype="int8"),
                                  jt.Precision("bfloat16", "bfloat16", "bfloat16")],
                         ids=["int8", "bf16_full_state"])
def test_solve_unclamped_inputs_match_jax(small, prec):
    """clamp_inputs=False casts or quantizes directly (solver.py:779-793)."""
    rj, rp = _solve_both(small, prec, "auto", clamp_inputs=False)
    _assert_solves_agree(rj, rp, prec)


def test_prep_clamps_state_in_its_dtype():
    """W and H are cast to the state dtype and clamped there, as
    max(w.astype(sd), sd(eps)) (nmf_tpu solver.py:694-695)."""
    w = np.array([[0.0, 1e-30, 3.0e-16, 0.3]], np.float32)
    prec = jt.Precision("bfloat16", "bfloat16")
    cfg = jt.SolveConfig(max_iter=0, precision=prec)
    x = np.ones((4, 4), np.float32)
    rj = jt.solve(x, w.T, w, cfg)
    rp = pt.solve(x, w.T, w, config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    assert rp.w.dtype == rp.h.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(rp.w), np.asarray(rj.w).astype(np.float32))
    np.testing.assert_array_equal(_np(rp.h), np.asarray(rj.h).astype(np.float32))


def test_pallas_backend_refuses_rowblock_scales(small):
    """backend='pallas' with x_quant_rows raises (solver.py:137-143); auto
    takes the plain ops on dequantized X and launches nothing."""
    x, w, h = small
    prec = pt.Precision(x_dtype="int8", x_quant_rows=16)
    with pytest.raises(NotImplementedError, match="per-row-block"):
        pt.solve(x, w, h, pt.SolveConfig(max_iter=2, precision=prec, backend="pallas"),
                 device="cpu")
    res = pt.solve(x, w, h, pt.SolveConfig(max_iter=2, precision=prec), device="cpu")
    assert np.isfinite(float(res.cost))
    assert not any(tfm.LAUNCHES.values()) and not any(tfm.PLAIN_CALLS.values())


def test_auto_sends_int8_columns_to_the_kernel_wrappers(small, monkeypatch):
    """The JAX rule 'auto sends int8 X to jnp' is a TPU rule and is not
    carried over: the solver calls the fused wrappers with the pair."""
    x, w, h = small
    seen = []
    real = tfm.update_h_fused

    def spy(w, h, x, *a, **k):
        seen.append(type(x))
        return real(w, h, x, *a, **k)

    monkeypatch.setattr(tfm, "update_h_fused", spy)
    pt.solve(x, w, h, pt.SolveConfig(max_iter=2, precision=pt.Precision(x_dtype="int8")),
             device="cpu")
    assert seen == [tuple, tuple]


# --- the CLI flags ---------------------------------------------------------------


def _write_small(tmp_path, small):
    x, w, h = small
    for name, a in (("X", x), ("W", w), ("H", h)):
        binio.write_matrix(a, tmp_path / f"{name}.bin")


@pytest.mark.parametrize("tier", list(TIERS))
def test_cli_tier_equals_in_process_solve(tmp_path, small, tier):
    """Each new flag: the CLI's output files are byte-equal to the
    in-process solve of the same policy, and close to the JAX solve."""
    flags, jprec = TIERS[tier]
    _write_small(tmp_path, small)
    rc = cli.main(["run", str(tmp_path / "X.bin"), str(tmp_path / "W.bin"),
                   str(tmp_path / "H.bin"), "-o", str(tmp_path / "Wo.bin"),
                   str(tmp_path / "Ho.bin"), "--device", "cpu", "--max-iter", "30",
                   "--check-every", "10", "-q", *flags])
    assert rc == 0
    x, w, h = small
    pcfg = config_from_dict(dataclasses.asdict(
        jt.SolveConfig(max_iter=30, check_every=10, precision=jprec)))
    rp = pt.solve(x, w, h, pcfg, device="cpu")
    assert binio.read_matrix(tmp_path / "Wo.bin").tobytes() == _np(rp.w).tobytes()
    assert binio.read_matrix(tmp_path / "Ho.bin").tobytes() == _np(rp.h).tobytes()


def test_cli_precision_flags_match_the_jax_cli():
    """Same choices and defaults as nmf_tpu's run (cli.py:62-88)."""
    from nmf_tpu.cli import build_parser as jax_parser

    def actions(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {a.dest: a for a in sub.choices["run"]._actions}

    ours, theirs = actions(cli.build_parser()), actions(jax_parser())
    for dest in ("dtype", "x_dtype", "x_quant_rows"):
        assert ours[dest].choices == theirs[dest].choices, dest
        assert ours[dest].default == theirs[dest].default, dest
        assert ours[dest].type == theirs[dest].type, dest


# --- state across the packages -----------------------------------------------------


def test_state_from_numpy_carries_jax_bf16_state_exactly(small):
    x, w, h = small
    wj, hj = jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(h).astype(jnp.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt, wt, ht = state_from_numpy(np.asarray(xj), np.asarray(wj), np.asarray(hj), device="cpu")
    for ours, ref in ((xt, xj), (wt, wj), (ht, hj)):
        assert ours.dtype == torch.bfloat16 and ours.is_contiguous()
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                      np.asarray(ref).view(np.int16))


def test_state_from_numpy_carries_jax_int8_pair_exactly(small):
    x, w, h = small
    q, s = jq.quantize_columns(jnp.asarray(x), EPS)
    (qt, st), wt, ht = state_from_numpy((np.asarray(q), np.asarray(s)), w, h, device="cpu")
    assert qt.dtype == torch.uint8 and st.dtype == torch.float32 and wt.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(q))
    np.testing.assert_array_equal(st.numpy(), np.asarray(s))


def test_bf16_result_round_trips_to_numpy_exactly(small):
    """A bf16 solve's factors come back as f32 copies holding the same
    values; fed back in, they give the same bf16 bits."""
    x, w, h = small
    prec = pt.Precision("bfloat16", "bfloat16")
    res = pt.solve(x, w, h, pt.SolveConfig(max_iter=5, precision=prec), device="cpu")
    out = result_to_numpy(res)
    assert out["w"].dtype == np.float32
    np.testing.assert_array_equal(out["w"], res.w.float().numpy())
    _, wt, _ = state_from_numpy(x, out["w"].astype(ml_dtypes.bfloat16), h, device="cpu")
    assert torch.equal(wt.view(torch.int16), res.w.view(torch.int16))
