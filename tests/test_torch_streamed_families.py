"""The port's streamed families against ``nmf_tpu`` on the CPU: the beta,
penalized-KL, HALS and masked families and ``n_frozen`` of
``solve_out_of_core``, and ``transform_out_of_core(mask=...)``.

The same inputs, made from a seed with NumPy, go through both packages
(``torch.set_num_threads(1)``): 48 x 300, K=5, in blocks of 64 (the last
one 44 columns), from an array or a ``.bin`` file, as f32, bf16 or int8 X;
masks with 20% of the entries missing, NaN in X there.  Tolerances, as
tests/test_torch_streaming.py holds the streamed solve: factors rtol 1e-5 /
atol 1e-6 (the two packages sum the blocks' f32 GEMMs in other orders), the
cost history rel 1e-5; HALS factors by relative Frobenius norm 1e-4 (its
clipped coordinate steps, tests/test_torch_transform.py); the accelerated
solves factors rtol 1e-3 (tests/test_torch_streaming.py's).  Against the
port's own in-memory solve of the same family, the streamed cost within
1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu.models import streaming as js  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import streaming as ts  # noqa: E402
from nmf_tpu_torch.ops import divergence as tdiv  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict  # noqa: E402

RTOL, ATOL, COST_RTOL, FRO, ACCEL_RTOL = 1e-5, 1e-6, 1e-5, 1e-4, 1e-3
M, K, N, BLOCK = 48, 5, 300, 64
EPS = float(np.float32(2.2204e-16))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(23)
    x = rng.rand(M, N).astype(np.float32) + 1e-3
    w = rng.rand(M, K).astype(np.float32) + 1e-3
    h = rng.rand(K, N).astype(np.float32) + 1e-3
    mask = (rng.rand(M, N) >= 0.2).astype(np.float32)
    return x, w, h, mask


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _assert_match(rp, rj, hals=False, rtol=RTOL):
    for f in ("iterations", "num_checks", "converged"):
        assert int(getattr(rp, f)) == int(getattr(rj, f)), f
    for f in ("w", "h"):
        ours, ref = _np(getattr(rp, f)), _np(getattr(rj, f))
        assert ours.shape == ref.shape, f
        if hals:
            assert np.linalg.norm(ours - ref) <= FRO * np.linalg.norm(ref), f
        else:
            np.testing.assert_allclose(ours, ref, rtol=rtol, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(_np(rp.cost_history), np.asarray(rj.cost_history),
                               rtol=COST_RTOL)


FAMILIES = {
    "beta2": dict(beta=2.0),
    "beta0": dict(beta=0.0),
    "beta0.5": dict(beta=0.5),
    "beta3": dict(beta=3.0),
    "hals": dict(beta=2.0, algorithm="hals"),
    "kl_reg": dict(l1_w=0.1, l1_h=0.2, l2_w=0.3, l2_h=0.05),
}


def _run_both(x, w, h, jcfg, **kw):
    rj = jt.solve_out_of_core(x, w, h, jcfg, block_n=BLOCK, **kw)
    rp = pt.solve_out_of_core(x, w, h, _pcfg(jcfg), block_n=BLOCK, device="cpu", **kw)
    return rp, rj


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_streamed_family_matches_jax(problem, family, x_dtype):
    x, w, h, _ = problem
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, precision=jt.Precision(x_dtype=x_dtype),
                          **FAMILIES[family])
    _assert_match(*_run_both(x, w, h, jcfg), hals=family == "hals")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_streamed_family_from_bin_matches_jax(problem, tmp_path, family):
    x, w, h, _ = problem
    path = str(tmp_path / "X.bin")
    jbin.write_matrix(x, path)
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, **FAMILIES[family])
    _assert_match(*_run_both(path, w, h, jcfg), hals=family == "hals")


@pytest.mark.parametrize("family", ["beta2", "hals", "kl_reg"])
def test_streamed_family_accelerated_matches_jax(problem, family):
    x, w, h, _ = problem
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, accelerate=True, **FAMILIES[family])
    rp, rj = _run_both(x, w, h, jcfg)
    _assert_match(rp, rj, hals=family == "hals", rtol=ACCEL_RTOL)
    assert float(rp.momentum) == float(rj.momentum)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_streamed_family_cost_is_the_in_memory_cost(problem, family):
    """The streamed solve takes the in-memory steps with the blocks' sums in
    another order: the port's two costs agree to 1e-5."""
    x, w, h, _ = problem
    cfg = pt.SolveConfig(max_iter=10, check_every=5, **FAMILIES[family])
    mem = pt.solve(x, w, h, cfg, device="cpu")
    ooc = pt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK, device="cpu")
    assert float(ooc.cost) == pytest.approx(float(mem.cost), rel=COST_RTOL)


def test_streamed_family_converges_on_the_jax_iteration(problem):
    x, w, h, _ = problem
    jcfg = jt.SolveConfig(max_iter=300, check_every=5, thresh=1e-3, beta=2.0)
    rp, rj = _run_both(x, w, h, jcfg)
    assert bool(rp.converged) and int(rp.iterations) < 300
    _assert_match(rp, rj)


@pytest.mark.parametrize(
    "family", ["beta2", "beta0.5", "hals", "kl_reg", "masked", "kl_plain", "int8_rows"])
def test_column_chunks_match_jax(problem, monkeypatch, family):
    """The plain families take a block's columns in chunks (16 columns here:
    four a block, three in the last; HALS its cost alone, the unpenalized
    KL none): the same solve as JAX's unsplit blocks, to this file's
    tolerances."""
    monkeypatch.setattr(ts, "_PLAIN_CHUNK_BYTES", 4 * M * 16)
    x, w, h, mask = problem
    fields = {**FAMILIES, "masked": {}, "kl_plain": dict(backend="jnp"),
              "int8_rows": dict(precision=jt.Precision(x_dtype="int8", x_quant_rows=16))}[family]
    kw = dict(mask=mask) if family == "masked" else {}
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, **fields)
    _assert_match(*_run_both(x, w, h, jcfg, **kw), hals=family == "hals")


@pytest.mark.parametrize("family,fn,whole", [
    ("hals", "cd_sweep_h", True), ("kl_plain", "update_h", True), ("beta2", "_beta_ratios", False)])
def test_which_steps_take_whole_blocks(problem, monkeypatch, family, fn, whole):
    """HALS's step makes no (M, width) temporary and the unpenalized KL step
    is the kernels' reference: both take whole blocks however small the
    chunks.  The beta step builds W H, and runs a chunk at a time."""
    monkeypatch.setattr(ts, "_PLAIN_CHUNK_BYTES", 4 * M * 16)
    widths = []
    orig = getattr(ts, fn)
    h_arg = 0 if fn == "cd_sweep_h" else 1

    def counted(*a, **k):
        widths.append(int(a[h_arg].shape[1]))
        return orig(*a, **k)

    monkeypatch.setattr(ts, fn, counted)
    x, w, h, _ = problem
    fields = {**FAMILIES, "kl_plain": dict(backend="jnp")}[family]
    pt.solve_out_of_core(x, w, h, pt.SolveConfig(max_iter=2, check_every=2, **fields),
                         block_n=BLOCK, device="cpu")
    blocks = [BLOCK] * (N // BLOCK) + [N % BLOCK]
    if whole:
        assert widths == blocks * 2
    else:
        assert widths and max(widths) <= 16


@pytest.mark.parametrize("beta", [2.0, 0.0, 0.5, 3.0, 1.0])
def test_beta_partial_matches_jax(problem, beta):
    from nmf_tpu.parallel.sharded import beta_partial as jbp

    x, w, h, _ = problem
    ref = float(jbp(x, w, h, beta, EPS))
    ours = float(tdiv.beta_partial(*(torch.from_numpy(a) for a in (x, w, h)), beta, EPS))
    assert ours == pytest.approx(ref, rel=COST_RTOL)


def test_the_families_launch_no_kernel(problem):
    """The families take plain ops, as in JAX: no K1-K3 wrapper is called."""
    calls = []
    originals = {n: getattr(tfm, n) for n in ("update_h_fused", "update_w_fused", "kl_cost_fused")}
    try:
        for n in originals:
            setattr(tfm, n, lambda *a, _n=n, **k: calls.append(_n) or originals[_n](*a, **k))
        x, w, h, mask = problem
        for fam in FAMILIES.values():
            pt.solve_out_of_core(x, w, h, pt.SolveConfig(max_iter=2, check_every=1, **fam),
                                 block_n=BLOCK, device="cpu")
        pt.solve_out_of_core(x, w, h, pt.SolveConfig(max_iter=2, check_every=1), block_n=BLOCK,
                             mask=mask, device="cpu")
    finally:
        for n, f in originals.items():
            setattr(tfm, n, f)
    assert calls == []


# ---- mask= ------------------------------------------------------------------


MASKED = {
    "kl": dict(),
    "penalized": dict(l1_w=0.1, l1_h=0.2, l2_w=0.05, l2_h=0.1),
    "bf16_x": dict(precision=jt.Precision(x_dtype="bfloat16")),
    "int8_x": dict(precision=jt.Precision(x_dtype="int8")),
    "int8_rows": dict(precision=jt.Precision(x_dtype="int8", x_quant_rows=16)),
    "bfloat16": dict(precision=jt.Precision("bfloat16")),
}


@pytest.mark.parametrize("variant", list(MASKED))
def test_streamed_masked_matches_jax(problem, variant):
    """The mask streams beside X (NaN in X's unobserved entries)."""
    x, w, h, mask = problem
    xn = x.copy()
    xn[mask == 0] = np.nan
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, **MASKED[variant])
    rp, rj = _run_both(xn, w, h, jcfg, mask=mask)
    _assert_match(rp, rj)
    assert np.isfinite(_np(rp.w)).all() and np.isfinite(_np(rp.h)).all()


def test_streamed_masked_accelerated_matches_jax(problem):
    x, w, h, mask = problem
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, accelerate=True)
    rp, rj = _run_both(x, w, h, jcfg, mask=mask)
    _assert_match(rp, rj, rtol=ACCEL_RTOL)


def test_streamed_masked_from_bin_files_matches_jax(problem, tmp_path):
    x, w, h, mask = problem
    paths = {}
    for name, a in (("X", x), ("M", mask)):
        paths[name] = str(tmp_path / f"{name}.bin")
        jbin.write_matrix(a, paths[name])
    jcfg = jt.SolveConfig(max_iter=10, check_every=5)
    _assert_match(*_run_both(paths["X"], w, h, jcfg, mask=paths["M"]))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16", "int8"])
def test_streamed_masked_cost_is_the_in_memory_masked_cost(problem, x_dtype):
    x, w, h, mask = problem
    cfg = pt.SolveConfig(max_iter=10, check_every=5, precision=pt.Precision(x_dtype=x_dtype),
                         l1_h=0.1, l2_w=0.1)
    mem = pt.solve_masked(x, w, h, mask, cfg, device="cpu")
    ooc = pt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK, mask=mask, device="cpu")
    assert float(ooc.cost) == pytest.approx(float(mem.cost), rel=COST_RTOL)
    np.testing.assert_allclose(_np(ooc.w), _np(mem.w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("garbage", [np.nan, np.inf, 1e30])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16", "int8"])
def test_streamed_mask_zeroes_unobserved_entries_first(problem, x_dtype, garbage):
    """Garbage where the mask is 0 gives the bits of X with zeros there, in
    every storage dtype (int8: the scales never see it)."""
    x, w, h, mask = problem
    dirty = x.copy()
    dirty[mask == 0] = garbage
    clean = np.where(mask > 0, x, 0.0).astype(np.float32)
    cfg = pt.SolveConfig(max_iter=4, check_every=2, precision=pt.Precision(x_dtype=x_dtype))
    a, b = (pt.solve_out_of_core(src, w, h, cfg, block_n=BLOCK, mask=mask, device="cpu")
            for src in (dirty, clean))
    for f in ("w", "h", "cost_history"):
        assert _np(getattr(a, f)).tobytes() == _np(getattr(b, f)).tobytes(), f


@pytest.mark.parametrize("x_dtype,wire", [("float32", torch.float32), ("bfloat16", torch.bfloat16),
                                          ("int8", torch.float32)])
def test_mask_wire_dtype_is_jax_cast_mask(problem, x_dtype, wire):
    """bf16 beside bf16 X, f32 beside f32 and int8 X (JAX's ``_cast_mask``),
    and the blocks come out as ``(x_j, mask_j)`` with the mask's values."""
    x, _, _, mask = problem
    assert ts.mask_wire_dtype(x_dtype) is wire
    assert str(js._cast_mask(mask[:, :3], x_dtype).dtype) == str(wire).replace("torch.", "")
    blocks = [(0, BLOCK), (BLOCK, 2 * BLOCK)]
    stream = ts._BlockStream(ts._as_source(x), blocks, torch.device("cpu"), x_dtype, EPS, 0,
                             0, ts._as_source(mask))
    for idx, (x_j, m_j) in stream.sweep():
        j0, j1 = blocks[idx]
        assert m_j.dtype is wire and m_j.float().numpy().tobytes() == \
            np.ascontiguousarray(mask[:, j0:j1]).tobytes()


@pytest.mark.parametrize("x_dtype,qrows", [("bfloat16", 0), ("int8", 0), ("int8", 16)])
def test_host_prep_with_mask_equals_jax(problem, x_dtype, qrows):
    x, _, _, mask = problem
    blk = np.ascontiguousarray(x[:, :BLOCK])
    blk[mask[:, :BLOCK] == 0] = np.nan
    m_blk = np.ascontiguousarray(mask[:, :BLOCK])
    ref = js._host_prep(blk.copy(), EPS, x_dtype, qrows, mask=m_blk)
    if x_dtype == "int8":
        ours = ts._host_prep(blk.copy(), EPS, "int8", qrows, mask=m_blk)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    else:
        out = torch.empty(blk.shape, dtype=torch.bfloat16)
        ts._host_prep(blk.copy(), EPS, "bfloat16", out=out, mask=m_blk)
        assert out.view(torch.int16).numpy().tobytes() == np.asarray(ref).view(np.int16).tobytes()


def test_int8_masked_code_cache_is_the_requantized_blocks(problem, monkeypatch):
    """The int8 code cache holds codes made from masked blocks: a run whose
    budget caches nothing (every block re-quantized every sweep) gives the
    same bits."""
    x, w, h, mask = problem
    cfg = pt.SolveConfig(max_iter=6, check_every=3, precision=pt.Precision(x_dtype="int8"))
    cached = pt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK, mask=mask, device="cpu")
    monkeypatch.setenv("NMF_TPU_QCACHE_BYTES", "0")
    fresh = pt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK, mask=mask, device="cpu")
    for f in ("w", "h", "cost_history"):
        assert _np(getattr(cached, f)).tobytes() == _np(getattr(fresh, f)).tobytes(), f


# ---- n_frozen ---------------------------------------------------------------


@pytest.mark.parametrize(
    "fields",
    [dict(), dict(beta=2.0), dict(l1_h=0.1, l2_w=0.1), dict(precision=jt.Precision(x_dtype="int8")),
     dict(precision=jt.Precision(x_dtype="bfloat16"))],
    ids=["kl", "beta2", "kl_reg", "int8_x", "bf16_x"],
)
def test_streamed_n_frozen_matches_jax(problem, fields):
    x, w, h, _ = problem
    w = w.copy()
    w[:4, 0] = 0.0                 # clamped at load, then frozen there
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, **fields)
    rp, rj = _run_both(x, w, h, jcfg, n_frozen=2)
    _assert_match(rp, rj)
    want = np.ascontiguousarray(np.maximum(w, np.float32(EPS))[:, :2])
    assert np.ascontiguousarray(_np(rp.w)[:, :2]).tobytes() == want.tobytes()


def test_streamed_n_frozen_accelerated_keeps_the_columns(problem):
    x, w, h, _ = problem
    jcfg = jt.SolveConfig(max_iter=10, check_every=5, accelerate=True)
    rp, rj = _run_both(x, w, h, jcfg, n_frozen=3)
    _assert_match(rp, rj, rtol=ACCEL_RTOL)
    assert np.ascontiguousarray(_np(rp.w)[:, :3]).tobytes() == \
        np.ascontiguousarray(np.maximum(w, np.float32(EPS))[:, :3]).tobytes()


def test_streamed_n_frozen_is_the_in_memory_semi_solve(problem):
    x, w, h, _ = problem
    cfg = pt.SolveConfig(max_iter=10, check_every=5)
    mem = pt.solve_semi(x, w, h, cfg, n_frozen=2, device="cpu")
    ooc = pt.solve_out_of_core(x, w, h, cfg, block_n=BLOCK, n_frozen=2, device="cpu")
    assert float(ooc.cost) == pytest.approx(float(mem.cost), rel=COST_RTOL)
    np.testing.assert_allclose(_np(ooc.w), _np(mem.w), rtol=RTOL, atol=ATOL)


def test_streamed_n_frozen_stays_on_the_kl_kernels(problem, monkeypatch):
    """``n_frozen`` keeps the KL family on K1, K2 ``numerator_only`` and K3
    (their plain versions on the CPU): blocks x iterations of each update,
    blocks x passes of the cost."""
    calls = {"update_h": 0, "update_w_numerator": 0, "kl_cost": 0}

    def count_update(name):
        orig = getattr(tfm, name)

        def call(*a, **k):
            key = name[:-6] + ("_numerator" if k.get("numerator_only") else "")
            calls[key] = calls.get(key, 0) + 1
            return orig(*a, **k)
        return call

    orig_cost = tfm.kl_cost_fused

    def cost(*a, **k):
        calls["kl_cost"] += 1
        return orig_cost(*a, **k)

    monkeypatch.setattr(tfm, "update_h_fused", count_update("update_h_fused"))
    monkeypatch.setattr(tfm, "update_w_fused", count_update("update_w_fused"))
    monkeypatch.setattr(tfm, "kl_cost_fused", cost)
    x, w, h, _ = problem
    pt.solve_out_of_core(x, w, h, pt.SolveConfig(max_iter=10, check_every=5), block_n=BLOCK,
                         n_frozen=2, device="cpu")
    blocks = -(-N // BLOCK)
    assert calls == {"update_h": 10 * blocks, "update_w_numerator": 10 * blocks,
                     "kl_cost": 2 * blocks}


def _messages(ours, ref, exc):
    with pytest.raises(exc) as e_ours:
        ours()
    with pytest.raises(exc) as e_ref:
        ref()
    return str(e_ours.value), str(e_ref.value)


@pytest.mark.parametrize(
    "cfg,kw,exc",
    [(dict(beta=2.0), dict(mask="ones"), NotImplementedError),
     (dict(beta=2.0, algorithm="hals"), dict(n_frozen=1), NotImplementedError),
     ({}, dict(n_frozen=K + 1), ValueError),
     ({}, dict(mask="short"), ValueError)],
    ids=["masked_beta", "frozen_hals", "frozen_range", "mask_shape"],
)
def test_refusals_match_jax(problem, cfg, kw, exc):
    x, w, h, mask = problem
    kw = dict(kw)
    if kw.get("mask") == "ones":
        kw["mask"] = np.ones_like(x)
    elif kw.get("mask") == "short":
        kw["mask"] = mask[:, :-1]
    jcfg = jt.SolveConfig(max_iter=1, **cfg)
    ours, ref = _messages(
        lambda: pt.solve_out_of_core(x, w, h, _pcfg(jcfg), block_n=BLOCK, device="cpu", **kw),
        lambda: jt.solve_out_of_core(x, w, h, jcfg, block_n=BLOCK, **kw), exc)
    assert ours == ref


# ---- transform_out_of_core(mask=...) ---------------------------------------


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "seeded"])
@pytest.mark.parametrize(
    "fields",
    [dict(), dict(l1_h=0.2, l2_h=0.1), dict(precision=jt.Precision(x_dtype="bfloat16")),
     dict(thresh=1e-4, max_iter=400, check_every=5)],
    ids=["kl", "penalized", "bf16_x", "thresh"],
)
def test_masked_transform_matches_jax(problem, fields, with_h0):
    x, w, h, mask = problem
    xn = x.copy()
    xn[mask == 0] = np.nan
    jcfg = jt.SolveConfig(**{"max_iter": 30, "check_every": 10, **fields})
    h0 = h if with_h0 else None
    tj = jt.transform_out_of_core(xn, w, h0=h0, config=jcfg, block_n=BLOCK, seed=2, mask=mask)
    tp = pt.transform_out_of_core(xn, w, h0=h0, config=_pcfg(jcfg), block_n=BLOCK, seed=2,
                                  mask=mask, device="cpu")
    assert tp.blocks == [tuple(b) for b in tj.blocks]
    np.testing.assert_array_equal(tp.iterations, tj.iterations)
    np.testing.assert_array_equal(tp.converged, tj.converged)
    np.testing.assert_allclose(tp.h, tj.h, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.block_costs, tj.block_costs, rtol=COST_RTOL)
    assert tp.cost == pytest.approx(tj.cost, rel=COST_RTOL)


def test_masked_transform_from_bin_is_the_in_memory_masked_h_only(problem, tmp_path):
    """Each block solves the same columns with the same masked step: H and
    the summed cost agree with ``solve_masked_h_only`` on all of X."""
    x, w, h, mask = problem
    paths = {}
    for name, a in (("X", x), ("M", mask)):
        paths[name] = str(tmp_path / f"{name}.bin")
        jbin.write_matrix(a, paths[name])
    cfg = pt.SolveConfig(max_iter=30, check_every=10)
    tp = pt.transform_out_of_core(paths["X"], w, h0=h, config=cfg, block_n=BLOCK,
                                  mask=paths["M"], device="cpu")
    mem = pt.solve_masked_h_only(x, w, h, mask, cfg, device="cpu")
    np.testing.assert_allclose(tp.h, _np(mem.h), rtol=RTOL, atol=ATOL)
    assert tp.cost == pytest.approx(float(mem.cost), rel=COST_RTOL)


@pytest.mark.parametrize("case", ["int8", "hals", "shape"])
def test_masked_transform_refusals_match_jax(problem, case):
    x, w, _, mask = problem
    cfg, exc = {}, NotImplementedError
    if case == "int8":
        cfg = dict(precision=jt.Precision(x_dtype="int8"))
    elif case == "hals":
        cfg = dict(beta=2.0, algorithm="hals")
    else:
        mask, exc = mask[:-1], ValueError
    jcfg = jt.SolveConfig(max_iter=2, **cfg)
    ours, ref = _messages(
        lambda: pt.transform_out_of_core(x, w, config=_pcfg(jcfg), mask=mask, device="cpu"),
        lambda: jt.transform_out_of_core(x, w, config=jcfg, mask=mask), exc)
    assert ours == ref
