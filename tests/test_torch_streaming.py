"""The port's out-of-core solve (``nmf_tpu_torch.models.streaming``) against
``nmf_tpu.models.streaming`` on the CPU.

The problem is tests/test_streaming.py's (96 x 1000, K=12, ragged blocks),
made with NumPy from a seed and handed to both packages.  Tolerances, as
tests/test_streaming.py states them for the streamed solve against the
in-memory one: factors rtol 1e-5 / atol 1e-8, cost history rtol 1e-6.  The
two packages take the same steps in the same order; what differs is the f32
summation order inside XLA:CPU's and torch's reductions and GEMMs.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu.models import streaming as js  # noqa: E402
from nmf_tpu.utils import config as jcfg  # noqa: E402
import nmf_tpu_torch as nt  # noqa: E402
from nmf_tpu_torch.models import streaming as ts  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu  # noqa: E402

FACTOR_RTOL, FACTOR_ATOL, HIST_RTOL = 1e-5, 1e-8, 1e-6
EPS = float(np.float32(2.2204e-16))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(17)
    m, k, n = 96, 12, 1000
    x = rng.rand(m, n).astype(np.float32)
    w = rng.rand(m, k).astype(np.float32)
    h = rng.rand(k, n).astype(np.float32)
    return x, w, h


def _configs(**kw):
    """The same SolveConfig in both packages."""
    prec = kw.pop("precision", ())
    return (jcfg.SolveConfig(precision=jcfg.Precision(*prec), **kw),
            nt.SolveConfig(precision=nt.Precision(*prec), **kw))


def _port(x, w, h, cfg, **kw):
    return ts.solve_out_of_core(x, w, h, cfg, device="cpu", **kw)


def _assert_match(ours, ref, hist_rtol=HIST_RTOL, factor_rtol=FACTOR_RTOL):
    assert int(ours.iterations) == int(ref.iterations)
    assert int(ours.num_checks) == int(ref.num_checks)
    assert bool(ours.converged) == bool(ref.converged)
    for f in ("w", "h"):
        np.testing.assert_allclose(getattr(ours, f).float().numpy(),
                                   np.asarray(getattr(ref, f), np.float32),
                                   rtol=factor_rtol, atol=FACTOR_ATOL)
    np.testing.assert_allclose(ours.cost_history.numpy(), np.asarray(ref.cost_history),
                               rtol=hist_rtol)
    assert ours.cost_history.shape == tuple(np.shape(ref.cost_history))


@pytest.mark.parametrize("block_n", [128, 256, 384, 1000])
def test_streamed_matches_jax(problem, block_n):
    x, w, h = problem
    jc, tc = _configs(max_iter=30, check_every=10)
    ref = js.solve_out_of_core(x, w, h, jc, block_n=block_n)
    ours = _port(x, w, h, tc, block_n=block_n)
    assert int(ours.iterations) == 30
    _assert_match(ours, ref)


def test_streamed_from_bin_file_matches_jax(problem, tmp_path):
    x, w, h = problem
    path = str(tmp_path / "X.bin")
    jbin.write_matrix(x, path)
    jc, tc = _configs(max_iter=20, check_every=10)
    _assert_match(_port(path, w, h, tc, block_n=256),
                  js.solve_out_of_core(path, w, h, jc, block_n=256))


def test_streamed_from_bin_equals_from_array(problem, tmp_path):
    """The .bin source and the array source give the same bits."""
    x, w, h = problem
    path = tmp_path / "X.bin"
    jbin.write_matrix(x, path)
    _, tc = _configs(max_iter=5, check_every=5)
    a = _port(x, w, h, tc, block_n=300)
    b = _port(ts.BinColumnSource(path), w, h, tc, block_n=300)
    assert torch.equal(a.w, b.w) and torch.equal(a.h, b.h)


@pytest.mark.parametrize("j0,j1", [(0, 128), (937, 1000), (0, 1000), (500, 501)])
def test_bin_column_source_slices_equal_jax(problem, tmp_path, j0, j1):
    x, _, _ = problem
    path = str(tmp_path / "X.bin")
    jbin.write_matrix(x, path)
    ours, ref = ts.BinColumnSource(path), js.BinColumnSource(path)
    assert ours.shape == ref.shape == x.shape
    got = ours.columns(j0, j1)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    assert got.tobytes() == np.ascontiguousarray(x[:, j0:j1]).tobytes()
    assert got.tobytes() == ref.columns(j0, j1).tobytes()
    into = np.empty((x.shape[0], j1 - j0), np.float32)
    ours.columns_into(j0, j1, into)
    assert into.tobytes() == got.tobytes()


def test_bin_column_source_tiled_transpose(tmp_path):
    """Blocks wider and taller than a transpose tile, ragged both ways."""
    x = np.random.RandomState(3).rand(300, 700).astype(np.float32)
    path = tmp_path / "X.bin"
    jbin.write_matrix(x, path)
    out = np.empty((300, 645), np.float32)
    ts.BinColumnSource(path).columns_into(5, 650, out)
    assert out.tobytes() == np.ascontiguousarray(x[:, 5:650]).tobytes()


def test_array_column_source_columns_into(problem):
    x, _, _ = problem
    src = ts.ArrayColumnSource(x.astype(np.float64))
    out = np.empty((96, 77), np.float32)
    src.columns_into(100, 177, out)
    assert out.tobytes() == js.ArrayColumnSource(x.astype(np.float64)).columns(100, 177).tobytes()
    with pytest.raises(ValueError, match="must be 2-D"):
        ts.ArrayColumnSource(np.ones(5, np.float32))


def test_bin_column_source_truncated_payload(tmp_path):
    path = str(tmp_path / "X.bin")
    jbin.write_matrix(np.ones((8, 8), np.float32), path)
    with open(path, "r+b") as f:
        f.truncate(8 + 8 * 8 * 4 - 16)
    with pytest.raises(ValueError, match="truncated") as ours:
        ts.BinColumnSource(path)
    with pytest.raises(ValueError, match="truncated") as ref:
        js.BinColumnSource(path)
    assert str(ours.value) == str(ref.value)


def test_bin_column_source_short_read(tmp_path):
    """A file cut after the source was opened: the JAX package's error."""
    path = str(tmp_path / "X.bin")
    jbin.write_matrix(np.ones((8, 8), np.float32), path)
    src = ts.BinColumnSource(path)
    with open(path, "r+b") as f:
        f.truncate(8 + 8 * 6 * 4)
    with pytest.raises(ValueError, match=re.escape("short read in")):
        src.columns(4, 8)


def test_threshold_convergence_stops_on_jax_iteration(problem):
    """The same stopping iteration (190) and history; over 190 iterations the
    last-ulp differences of the two packages' sums grow to 1.3e-5 in a few
    factor entries (measured), so the factors are held at rtol 1e-4."""
    x, w, h = problem
    jc, tc = _configs(max_iter=100_000, thresh=1e-3, check_every=10)
    ref = js.solve_out_of_core(x, w, h, jc, block_n=256)
    ours = _port(x, w, h, tc, block_n=256)
    assert bool(ours.converged) and bool(ref.converged)
    _assert_match(ours, ref, factor_rtol=1e-4)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "int8"])
def test_storage_dtypes_match_jax(problem, x_dtype):
    """bf16 and int8 X on the wire: the same storage bytes in both packages
    (checked in test_host_prep_equals_jax), the same iterates."""
    x, w, h = problem
    jc, tc = _configs(max_iter=30, check_every=10, precision=("float32", "float32", x_dtype))
    _assert_match(_port(x, w, h, tc, block_n=256),
                  js.solve_out_of_core(x, w, h, jc, block_n=256))


def test_int8_row_blocks_match_jax(problem):
    """Per-row-block scales under ``auto``: the plain ops on dequantized X."""
    x, w, h = problem
    jc, tc = _configs(max_iter=20, check_every=10,
                      precision=("float32", "float32", "int8", 32))
    _assert_match(_port(x, w, h, tc, block_n=256),
                  js.solve_out_of_core(x, w, h, jc, block_n=256))


@pytest.mark.parametrize("x_dtype,qrows", [("float32", 0), ("bfloat16", 0), ("int8", 0), ("int8", 40)])
def test_host_prep_equals_jax(problem, x_dtype, qrows):
    """A block as the stream hands it to the solve (f32 clamped after its
    copy, bf16 clamped and cast on the host, int8 quantized on the host)
    holds the bytes of the JAX package's ``_host_prep`` (int8 codes and
    scales byte for byte, bf16 bit for bit)."""
    x, _, _ = problem
    blk = np.ascontiguousarray(x[:, 100:356])
    blk[0, :5] = 0.0   # exercise the clamp
    ref = js._host_prep(blk.copy(), EPS, x_dtype, qrows)
    [(_, ours)] = list(_stream(blk, 256, x_dtype, qrows=qrows).sweep())
    if x_dtype == "int8":
        assert ours[0].dtype == torch.uint8 and ours[0].numpy().tobytes() == ref[0].tobytes()
        assert ours[1].numpy().tobytes() == ref[1].tobytes()
    elif x_dtype == "bfloat16":
        assert ours.dtype == torch.bfloat16
        assert ours.view(torch.int16).numpy().tobytes() == np.asarray(ref).view(np.int16).tobytes()
    else:
        assert ours.numpy().tobytes() == ref.tobytes()


def test_device_clamp_gives_the_host_clamp_bits():
    """f32 X is clamped after its copy with ``clamp_min_``: the same bits as
    the host's ``np.maximum`` on every kind of value."""
    rng = np.random.RandomState(5)
    a = rng.rand(64, 96).astype(np.float32)
    a.flat[:8] = [0.0, -0.0, -1.0, 1e-45, 1e-39, np.inf, -np.inf, np.float32(EPS)]
    a.flat[8] = np.nan
    host = np.maximum(a, np.float32(EPS))
    dev = torch.from_numpy(a.copy()).clamp_min_(EPS).numpy()
    assert dev.tobytes() == host.tobytes()


def _stream(x, bn, x_dtype="int8", budget=8 * 1024**3, qrows=0):
    src = ts.ArrayColumnSource(x)
    blocks = [(j, min(j + bn, x.shape[1])) for j in range(0, x.shape[1], bn)]
    return ts._BlockStream(src, blocks, torch.device("cpu"), x_dtype, EPS, qrows, budget)


def _sweep_copies(stream):
    return [tuple(t.clone() for t in xj) if isinstance(xj, tuple) else xj.clone()
            for _, xj in stream.sweep()]


def test_int8_cache_and_requantized_blocks_identical(problem):
    """Under a budget of two blocks, the cached blocks and the re-quantized
    ones give the same codes on every sweep, and the JAX package's."""
    x, _, _ = problem
    budget = 2 * 96 * 256
    stream = _stream(x, 256, budget=budget)
    first = _sweep_copies(stream)
    assert sorted(stream.qcache) == [0, 1] and stream.qcache_bytes == budget
    second = _sweep_copies(stream)
    unbounded = _sweep_copies(_stream(x, 256))
    for (q1, s1), (q2, s2), (q3, s3), j0 in zip(first, second, unbounded, range(0, 1000, 256)):
        assert torch.equal(q1, q2) and torch.equal(q1, q3)
        assert torch.equal(s1, s2) and torch.equal(s1, s3)
        qj, sj = js._host_prep(np.ascontiguousarray(x[:, j0:j0 + 256]), EPS, "int8")
        assert q1.numpy().tobytes() == qj.tobytes() and s1.numpy().tobytes() == sj.tobytes()


def test_int8_small_cache_solve_is_bitwise_the_cached_one(problem, monkeypatch):
    x, w, h = problem
    _, tc = _configs(max_iter=6, check_every=3, precision=("float32", "float32", "int8"))
    ref = _port(x, w, h, tc, block_n=256)
    monkeypatch.setenv("NMF_TPU_QCACHE_BYTES", "3e4")   # one block of 24576 bytes
    ours = _port(x, w, h, tc, block_n=256)
    assert torch.equal(ours.w, ref.w) and torch.equal(ours.h, ref.h)
    assert torch.equal(ours.cost_history, ref.cost_history)


def test_bad_qcache_budget_raises_the_jax_message(problem, monkeypatch):
    x, w, h = problem
    monkeypatch.setenv("NMF_TPU_QCACHE_BYTES", "lots")
    _, tc = _configs(max_iter=1)
    with pytest.raises(ValueError, match="NMF_TPU_QCACHE_BYTES must be a number of bytes, got 'lots'"):
        _port(x, w, h, tc, block_n=256)


def test_blocks_land_on_alternating_buffers(problem):
    """Two staging buffers: block i+1 is gathered while block i is in use,
    so consecutive blocks never share memory."""
    x, _, _ = problem
    stream = _stream(x, 300, "float32")
    ptrs = [xj.data_ptr() for _, xj in stream.sweep()]
    assert all(a != b for a, b in zip(ptrs, ptrs[1:]))
    got = [xj.clone() for _, xj in _stream(x, 300, "float32").sweep()]
    assert torch.equal(torch.cat(got, 1), torch.from_numpy(np.maximum(x, np.float32(EPS))))


@pytest.mark.parametrize("precision", [(), ("float32", "float32", "bfloat16"),
                                       ("float32", "float32", "int8"), ("bfloat16",)])
def test_streamed_matches_the_ports_in_memory_solve(problem, precision):
    """The port's streamed solve against its own ``solve``: only W's
    numerator is summed in another order (block by block).  ``bfloat16``
    GEMMs over 3 iterations: over 20 a flipped bf16 rounding of one Z entry
    moves later iterates by 2.3e-3 (measured).  Over 3 the factors are held
    at rtol 5e-5 under ``bfloat16``: the f32 order gap (8e-7 at iteration 2)
    flips a bf16 rounding in iteration 3, and one flipped rounding (2^-8 =
    3.9e-3 of one operand entry) moves a sum of at least 96 comparable
    terms (W^T Z over M = 96; Z H^T over N = 1000) by at most 2^-8 / 96 =
    4.1e-5; measured 1.5e-5 on 5 of 1152 entries of W (208 above 1e-6)."""
    x, w, h = problem
    bf16 = precision[:1] == ("bfloat16",)
    iters = 3 if bf16 else 20
    _, tc = _configs(max_iter=iters, check_every=iters, precision=precision)
    ours = _port(x, w, h, tc, block_n=256)
    mem = nt.solve(x, w, h, tc, device="cpu")
    rtol = 5e-5 if bf16 else FACTOR_RTOL
    for f in ("w", "h"):
        np.testing.assert_allclose(getattr(ours, f).numpy(), getattr(mem, f).numpy(),
                                   rtol=rtol, atol=FACTOR_ATOL)
    np.testing.assert_allclose(ours.cost_history.numpy(), mem.cost_history.numpy(),
                               rtol=HIST_RTOL)


def test_jnp_backend_matches_auto(problem):
    """On CPU tensors the kernels' wrappers take their plain versions: the
    ``jnp`` route computes the same thing."""
    x, w, h = problem
    _, tc = _configs(max_iter=10, check_every=5)
    a = _port(x, w, h, tc, block_n=256)
    b = _port(x, w, h, dataclasses.replace(tc, backend="jnp"), block_n=256)
    np.testing.assert_allclose(a.w.numpy(), b.w.numpy(), rtol=FACTOR_RTOL, atol=FACTOR_ATOL)
    np.testing.assert_allclose(a.cost_history.numpy(), b.cost_history.numpy(), rtol=HIST_RTOL)


def test_bf16_state_matches_jax(problem):
    """bf16 W and H: the epilogue rounds to bf16 in both packages."""
    x, w, h = problem
    jc, tc = _configs(max_iter=3, check_every=3, precision=("float32", "bfloat16"))
    ours = _port(x, w, h, tc, block_n=256)
    ref = js.solve_out_of_core(x, w, h, jc, block_n=256)
    assert ours.w.dtype == torch.bfloat16 and ours.h.dtype == torch.bfloat16
    for f in ("w", "h"):
        np.testing.assert_allclose(getattr(ours, f).float().numpy(),
                                   np.asarray(getattr(ref, f), np.float32), rtol=2.0 ** -7)
    np.testing.assert_allclose(ours.cost_history.numpy(), np.asarray(ref.cost_history), rtol=1e-5)


def test_untracked_cost_matches_jax(problem):
    x, w, h = problem
    jc, tc = _configs(max_iter=7, check_every=3, track_cost=False)
    ours = _port(x, w, h, tc, block_n=400)
    ref = js.solve_out_of_core(x, w, h, jc, block_n=400)
    assert int(ours.num_checks) == 0 and np.isnan(float(ours.cost))
    assert ours.cost_history.shape == (1,) and np.isnan(ours.cost_history.numpy()).all()
    _assert_match(ours, ref)


def test_max_iter_not_a_multiple_of_check_every(problem):
    """A last check at max_iter, as JAX labels it."""
    x, w, h = problem
    jc, tc = _configs(max_iter=7, check_every=3)
    ours = _port(x, w, h, tc, block_n=256)
    ref = js.solve_out_of_core(x, w, h, jc, block_n=256)
    assert int(ours.num_checks) == 3
    _assert_match(ours, ref)


def test_zero_iterations_return_the_clamped_init(problem):
    x, w, h = problem
    w = w.copy()
    w[0, 0] = 0.0
    _, tc = _configs(max_iter=0)
    res = _port(x, w, h, tc, block_n=256)
    assert int(res.iterations) == 0 and int(res.num_checks) == 0
    assert float(res.w[0, 0]) == EPS
    np.testing.assert_array_equal(res.h.numpy(), np.maximum(h, np.float32(EPS)))


def test_cpu_solve_launches_nothing(problem):
    x, w, h = problem
    fused_mu.reset_counts()
    _port(x, w, h, _configs(max_iter=2, check_every=1)[1], block_n=256)
    assert not any(fused_mu.LAUNCHES.values()) and not any(fused_mu.PLAIN_CALLS.values())


@pytest.mark.parametrize(
    "m,n",
    [(96, 1000), (1025, 619_264), (2048, 8192), (4096, 350), (1, 1), (1, 10**9),
     (300_000, 5000), (70_000_000, 10), (10**9, 3), (513, 128)],
)
def test_pick_block_n_equals_jax(m, n):
    assert ts.pick_block_n(m, n) == js.pick_block_n(m, n)
    assert ts.pick_block_n(m, n, 1 << 20) == js.pick_block_n(m, n, 1 << 20)


def test_pick_block_n_at_the_hour_of_audio():
    """256 MiB of f32 at M=1025: 65,408 columns, 10 blocks, the last 30,592."""
    bn = ts.pick_block_n(1025, 619_264)
    assert bn == 65_408 and -(-619_264 // bn) == 10 and 619_264 - 9 * bn == 30_592


@pytest.mark.parametrize("m,n", [(0, 5), (5, 0)])
def test_pick_block_n_empty_raises(m, n):
    with pytest.raises(ValueError, match="non-empty"):
        ts.pick_block_n(m, n)
    with pytest.raises(ValueError, match="non-empty"):
        js.pick_block_n(m, n)


def _messages(fn_ours, fn_ref, exc):
    with pytest.raises(exc) as ours:
        fn_ours()
    with pytest.raises(exc) as ref:
        fn_ref()
    return str(ours.value), str(ref.value)


@pytest.mark.parametrize(
    "kw,exc",
    [
        ({"block_n": 0}, ValueError),
        ({"checkpoint_every": 0}, ValueError),
        ({"h_cols": 999}, ValueError),
        ({"w_rank": 11}, ValueError),
        ({"config": {"precision": ("float32", "float32", "int8", 32), "backend": "pallas"}},
         NotImplementedError),
        ({"config": {"check_every": 0}}, ValueError),
    ],
)
def test_validation_errors_match_jax(problem, kw, exc):
    x, w, h = problem
    kw = dict(kw)
    if "h_cols" in kw:
        h = h[:, : kw.pop("h_cols")]
    if "w_rank" in kw:
        w = w[:, : kw.pop("w_rank")]
    jc, tc = _configs(max_iter=1, **kw.pop("config", {}))
    ours, ref = _messages(lambda: _port(x, w, h, tc, **kw),
                          lambda: js.solve_out_of_core(x, w, h, jc, **kw), exc)
    assert ours == ref


@pytest.mark.parametrize(
    "kw,item",
    [
        ({"mesh": object()}, "step 12b"),
        ({"mask": np.ones((96, 1000), np.float32)}, "ported"),
        ({"n_frozen": 2}, "ported"),
        ({"checkpoint_dir": "ck"}, "item 13"),
        ({"config": {"accelerate": True}}, "accel loop"),
        ({"config": {"live_metrics": True}}, "item 13"),
        ({"config": {"beta": 2.0}}, "ported"),
        ({"config": {"beta": 2.0, "algorithm": "hals"}}, "ported"),
        ({"config": {"l1_w": 0.1}}, "ported"),
        ({"config": {"backend": "autotune"}}, "item 7"),
    ],
)
def test_unported_options_are_refused_naming_their_item(problem, tmp_path, kw, item):
    """Options still to port are refused naming their ROADMAP.md item;
    ``accelerate``, refused when this test was named, runs and matches
    ``nmf_tpu``'s streamed solve over 10 iterations, a check every 5: the
    history to this file's 1e-6, the factors to rtol 1e-3 (each
    extrapolation scales a difference by up to 1 + momentum: the 1e-6
    drift of the plain streamed solve grows to a measured 3.1e-4 on 26
    entries of 12000).  ``mask``, ``n_frozen``, the beta and HALS families
    and the W penalties, refused when this test was named, run too and
    match ``nmf_tpu``'s streamed solve over 10 iterations to this file's
    tolerances (HALS: the factors by relative Frobenius norm 1e-4, as
    tests/test_torch_transform.py holds its clipped coordinate steps).
    ``checkpoint_dir`` and ``live_metrics``, refused when this test was
    named, run too: the checkpointed run matches ``nmf_tpu``'s
    (this file's tolerances) and writes the same steps with the same
    ``meta.json`` keys, its last ``W.bin`` the bytes of its result; the
    live emissions are JAX's (tests/test_torch_live.py's bars).
    ``backend="autotune"`` (ROADMAP.md item 7), refused when this test was
    named, runs too: the bits of ``auto`` on the CPU."""
    x, w, h = problem
    kw = dict(kw)
    if "checkpoint_dir" in kw:
        import json
        import os

        jc, tc = _configs(max_iter=10, check_every=5)
        ref = js.solve_out_of_core(x, w, h, jc, block_n=256, checkpoint_dir=str(tmp_path / "j"),
                                   checkpoint_every=4)
        ours = _port(x, w, h, tc, block_n=256, checkpoint_dir=str(tmp_path / "p"),
                     checkpoint_every=4)
        _assert_match(ours, ref)
        steps = sorted(os.listdir(tmp_path / "p"))
        assert steps == sorted(os.listdir(tmp_path / "j")) == [
            "step_00000004", "step_00000008", "step_00000010"]
        meta = [json.loads((tmp_path / d / steps[-1] / "meta.json").read_text()) for d in "pj"]
        assert meta[0].keys() == meta[1].keys() and meta[0]["config"] == meta[1]["config"]
        assert meta[0]["check_iterations"] == meta[1]["check_iterations"] == [5, 10]
        assert (jbin.read_matrix(tmp_path / "p" / steps[-1] / "W.bin").tobytes()
                == ours.w.numpy().tobytes())
        return
    if kw.get("config") == {"live_metrics": True}:
        from test_torch_live import assert_emissions_match, jax_emissions, port_emissions

        jc, tc = _configs(max_iter=10, check_every=5, live_metrics=True)
        ref, ev_j = jax_emissions(lambda: js.solve_out_of_core(x, w, h, jc, block_n=256))
        ours, ev_p = port_emissions(lambda: _port(x, w, h, tc, block_n=256))
        _assert_match(ours, ref)
        assert_emissions_match(ev_p, ev_j)
        return
    if item == "item 7":
        # backend="autotune", refused when this test was named under its
        # ROADMAP.md item, runs: on the CPU it measures nothing and gives
        # the bits of auto, within this file's tolerances of nmf_tpu's
        jc, tc = _configs(max_iter=10, check_every=5, **kw.pop("config"))
        ref = js.solve_out_of_core(x, w, h, jc, block_n=256)
        ours = _port(x, w, h, tc, block_n=256)
        auto = _port(x, w, h, dataclasses.replace(tc, backend="auto"), block_n=256)
        _assert_match(ours, ref)
        for f in ("w", "h", "cost_history"):
            assert getattr(ours, f).numpy().tobytes() == getattr(auto, f).numpy().tobytes(), f
        return
    if item in ("accel loop", "ported"):
        jc, tc = _configs(max_iter=10, check_every=5, **kw.pop("config", {}))
        ref = js.solve_out_of_core(x, w, h, jc, block_n=256, **kw)
        ours = _port(x, w, h, tc, block_n=256, **kw)
        if item == "accel loop":
            _assert_match(ours, ref, factor_rtol=1e-3)
            assert int(ours.num_checks) == 2 and float(ours.momentum) == float(ref.momentum)
        elif tc.algorithm == "hals":
            for f in ("w", "h"):
                a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
                assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), f
            np.testing.assert_allclose(ours.cost_history.numpy(), np.asarray(ref.cost_history),
                                       rtol=HIST_RTOL)
        else:
            _assert_match(ours, ref)
        return
    _, tc = _configs(max_iter=1, **kw.pop("config", {}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        _port(x, w, h, tc, block_n=256, **kw)
    assert item in str(err.value)


def test_cuda_request_without_a_card_raises(problem):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    x, w, h = problem
    with pytest.raises(RuntimeError, match="is_available"):
        ts.solve_out_of_core(x, w, h, nt.SolveConfig(max_iter=1), block_n=256)


def test_public_names():
    for name in ("solve_out_of_core", "ArrayColumnSource", "BinColumnSource", "pick_block_n"):
        assert getattr(nt, name) is getattr(ts, name)
        assert name in nt.__all__
