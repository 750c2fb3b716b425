"""The port's source separation (``nmf_tpu_torch.models.separation``) against
``nmf_tpu.models.separation`` on the CPU: the torch ``stft``/``istft``, the
host helpers, and ``separate`` with and without frozen templates.

The same audio, made from a seed with NumPy, goes through both packages
(``torch.set_num_threads(1)``); the cases mirror tests/test_separation.py
that need no restarts.  Tolerances: ``stft``/``istft`` against the jnp ones
within 1e-5 of the peak; the host helpers (the JAX package's NumPy code,
copied) byte for byte; ``separate``'s sources within 1e-4 of the peak, W
and H rtol 1e-4 / atol 1e-6 (the solve's of tests/test_torch_solver.py),
the cost rel 1e-4 (measured 1.9e-5 after the default 200 iterations: the
KL terms cancel near convergence, to a cost of 1.4 on a clip whose
spectrogram reaches 1e2).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from nmf_tpu.models import separation as js  # noqa: E402
from nmf_tpu.utils.config import SolveConfig as JConfig  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.models import separation as ts  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict, result_to_numpy  # noqa: E402

EPS = np.float32(2.2204e-16)
SR = 8000


@pytest.fixture(scope="module")
def two_tones():
    """Two tones in alternating half seconds, 2 s at 8 kHz (tests/test_separation.py)."""
    t = np.arange(SR * 2) / SR
    env = (np.sin(2 * np.pi * t) > 0).astype(np.float32)
    return (np.sin(2 * np.pi * 440.0 * t) * env
            + np.sin(2 * np.pi * 1313.0 * t) * (1 - env)).astype(np.float32)


def _noise(n=6000, seed=0):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _over_peak(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


FFT_CASES = [(1024, 256), (512, 128), (256, 64), (200, 50), (100, 30)]


@pytest.mark.parametrize("n_fft,hop", FFT_CASES)
def test_stft_matches_jnp(n_fft, hop):
    audio = _noise()
    ours = ts.stft(torch.from_numpy(audio), n_fft, hop, device="cpu")
    ref = np.asarray(js.stft(jnp.asarray(audio), n_fft, hop))
    assert ours.dtype == torch.complex64 and tuple(ours.shape) == ref.shape
    assert _over_peak(ours.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("n_fft,hop", FFT_CASES)
def test_istft_matches_jnp(n_fft, hop):
    spec = js._stft_np(_noise(), n_fft, hop)
    ours = ts.istft(torch.from_numpy(spec), n_fft, hop, length=6000, device="cpu")
    ref = np.asarray(js.istft(jnp.asarray(spec), n_fft, hop, length=6000))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    assert _over_peak(ours.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("n_fft,hop", FFT_CASES)
def test_overlap_add_is_the_host_loop_bit_for_bit(n_fft, hop):
    """The fixed-order overlap-add sums each sample's frames in the host
    loop's order: the same bits as ``_istft_np``'s loop on the same frames."""
    frames = np.random.RandomState(1).randn(37, n_fft).astype(np.float32)
    total = n_fft + hop * (frames.shape[0] - 1)
    ref = np.zeros((total,), np.float32)
    for f in range(frames.shape[0]):
        ref[f * hop: f * hop + n_fft] += frames[f]
    assert ts._overlap_add(torch.from_numpy(frames), hop).numpy().tobytes() == ref.tobytes()


def test_stft_shape_is_the_paper_convention():
    """513 bins for a 1024-point FFT; 3446 frames for 20 s at 44.1 kHz, hop 256."""
    spec = ts.stft(torch.zeros(882_000), 1024, 256, device="cpu")
    assert tuple(spec.shape) == (513, 3446)


def test_stft_istft_roundtrip():
    audio = np.random.RandomState(0).randn(16384).astype(np.float32)
    spec = ts.stft(torch.from_numpy(audio), 512, 128, device="cpu")
    back = ts.istft(spec, 512, 128, length=16384, device="cpu").numpy()
    a, b = back[512:-512], audio[512:-512]
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3


@pytest.mark.parametrize("name", ["_stft_np", "_istft_np"])
def test_host_helpers_equal_jax_byte_for_byte(name):
    audio = _noise()
    arg = audio if name == "_stft_np" else js._stft_np(audio, 256, 64)
    ours = getattr(ts, name)(arg, 256, 64)
    ref = getattr(js, name)(arg, 256, 64)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


def test_masked_sources_equal_jax_byte_for_byte():
    rng = np.random.RandomState(3)
    spec = js._stft_np(_noise(), 256, 64)
    w = rng.rand(129, 4).astype(np.float32)
    h = rng.rand(4, spec.shape[1]).astype(np.float32)
    ours = ts._masked_sources(w, h, spec, 256, 64, 6000)
    assert ours.tobytes() == js._masked_sources(w, h, spec, 256, 64, 6000).tobytes()


def _assert_separations_match(sp, sj):
    assert sp.sources.shape == sj.sources.shape and sp.sources.dtype == np.float32
    assert _over_peak(sp.sources, sj.sources) <= 1e-4
    np.testing.assert_allclose(sp.w, sj.w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sp.h, sj.h, rtol=1e-4, atol=1e-6)
    rp, rj = result_to_numpy(sp), result_to_numpy(sj)
    for f in ("iterations", "num_checks", "converged"):
        assert int(rp["solve_result"][f]) == int(rj["solve_result"][f]), f
    assert float(rp["solve_result"]["cost"]) == pytest.approx(float(rj["solve_result"]["cost"]),
                                                              rel=1e-4)


@pytest.mark.parametrize(
    "kw",
    [dict(n_components=2, n_fft=512, hop=128, seed=3),
     dict(n_components=4, n_fft=256, hop=64, seed=0),
     dict(n_components=3, n_fft=200, hop=50, seed=1)],
    ids=["two_tones", "k4", "hop_not_a_power_of_two"],
)
def test_separate_matches_jax(two_tones, kw):
    cfg = JConfig(max_iter=60, thresh=1e-5, check_every=10)
    sj = js.separate(two_tones, config=cfg, **kw)
    sp = ts.separate(two_tones, config=config_from_dict(dataclasses.asdict(cfg)),
                     device="cpu", **kw)
    _assert_separations_match(sp, sj)


def test_separate_default_config_matches_jax(two_tones):
    """No config: 200 iterations, thresh 1e-5, a check every 25, in both."""
    sj = js.separate(two_tones[:4000], n_components=3, n_fft=256, hop=64)
    sp = ts.separate(two_tones[:4000], n_components=3, n_fft=256, hop=64, device="cpu")
    _assert_separations_match(sp, sj)


def test_separate_finds_the_two_tones(two_tones):
    """Each basis vector peaks at one tone's bin, and the sources sum back
    to the mixture away from the edges (tests/test_separation.py)."""
    res = ts.separate(two_tones, n_components=2, n_fft=512, hop=128,
                      config=pt.SolveConfig(max_iter=100, thresh=1e-5, check_every=10),
                      seed=3, device="cpu")
    freqs = sorted(np.argmax(res.w, axis=0) * SR / 512)
    assert abs(freqs[0] - 440.0) < 40 and abs(freqs[1] - 1313.0) < 40
    mix = res.sources.sum(axis=0)
    a, b = mix[512:-512], two_tones[512:-512]
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3


@pytest.mark.parametrize("adapt", [False, True], ids=["frozen", "adapt_template"])
def test_separate_with_templates_matches_jax(two_tones, adapt):
    """The drum-template workflow: templates learned from one separation,
    frozen (or trained with ``adapt_template``) in the next; in the frozen
    case the template columns are the clamped templates bit for bit."""
    cfg = JConfig(max_iter=40, check_every=10)
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    templates = np.array(js.separate(two_tones, n_components=2, n_fft=512, hop=128,
                                     config=cfg).w)
    templates[:3, 0] = 0.0                         # clamped at load, then frozen there
    kw = dict(n_components=4, n_fft=512, hop=128, w_template=templates, adapt_template=adapt)
    sj = js.separate(two_tones, config=cfg, **kw)
    sp = ts.separate(two_tones, config=pcfg, device="cpu", **kw)
    _assert_separations_match(sp, sj)
    clamped = np.ascontiguousarray(np.maximum(templates, EPS))
    assert (np.ascontiguousarray(sp.w[:, :2]).tobytes() == clamped.tobytes()) != adapt


def test_separate_refusals_match_jax(two_tones):
    templates = np.ones((257, 2), np.float32)
    cases = [
        (dict(n_restarts=0), ValueError),
        (dict(n_components=1, n_fft=512, hop=128, w_template=templates), ValueError),
        (dict(n_fft=512, hop=128, w_template=np.ones((100, 2), np.float32)), ValueError),
    ]
    cfg = JConfig(max_iter=2)
    for kw, exc in cases:
        with pytest.raises(exc) as ours:
            ts.separate(two_tones[:2000], config=config_from_dict(dataclasses.asdict(cfg)),
                        device="cpu", **kw)
        with pytest.raises(exc) as ref:
            js.separate(two_tones[:2000], config=cfg, **kw)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="mono"):
        ts.separate(np.zeros((100, 2), np.float32), device="cpu")


def test_separate_restarts_refused_naming_their_step(two_tones):
    """``n_restarts > 1``, refused when this test was named, is ported: the
    lowest-cost of the seeded solves, run as one batched solve, as
    ``nmf_tpu.separate`` keeps it (``separation.py:218-226``)."""
    cfg = JConfig(max_iter=30, check_every=10)
    kw = dict(n_components=3, n_fft=512, hop=128, n_restarts=2, seed=1)
    sj = js.separate(two_tones, config=cfg, **kw)
    sp = ts.separate(two_tones, config=config_from_dict(dataclasses.asdict(cfg)), device="cpu",
                     **kw)
    _assert_separations_match(sp, sj)


@pytest.mark.parametrize("adapt", [False, True], ids=["frozen", "adapt_template"])
def test_separate_restarts_with_templates_match_jax(two_tones, adapt):
    """Restarts re-seed only the free columns; frozen templates stay the
    clamped templates bit for bit in the kept member (``n_frozen``)."""
    cfg = JConfig(max_iter=30, check_every=10)
    templates = np.array(js.separate(two_tones, n_components=2, n_fft=512, hop=128,
                                     config=cfg).w)
    kw = dict(n_components=4, n_fft=512, hop=128, w_template=templates, adapt_template=adapt,
              n_restarts=3)
    sj = js.separate(two_tones, config=cfg, **kw)
    sp = ts.separate(two_tones, config=config_from_dict(dataclasses.asdict(cfg)), device="cpu",
                     **kw)
    _assert_separations_match(sp, sj)
    clamped = np.ascontiguousarray(np.maximum(templates, EPS))
    assert (np.ascontiguousarray(sp.w[:, :2]).tobytes() == clamped.tobytes()) != adapt


def test_separate_runs_the_kl_solve_through_the_kernel_wrappers(two_tones, monkeypatch):
    """The NMF of ``separate`` is the KL solve: K1-K3's wrappers (their
    plain versions on the CPU), 30 steps and 3 costs at thresh 0."""
    from nmf_tpu_torch.ops.kernels import fused_mu as tfm

    calls = {"update_h_fused": 0, "update_w_fused": 0, "kl_cost_fused": 0}
    for name in calls:
        def counting(*a, _n=name, _f=getattr(tfm, name), **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tfm, name, counting)
    for template in (None, np.ones((257, 1), np.float32)):
        for name in calls:
            calls[name] = 0
        ts.separate(two_tones[:4000], n_components=3, n_fft=512, hop=128,
                    config=pt.SolveConfig(max_iter=30, check_every=10), w_template=template,
                    device="cpu")
        assert calls == {"update_h_fused": 30, "update_w_fused": 30, "kl_cost_fused": 3}


@pytest.mark.parametrize("entry", ["separate", "stft", "istft"])
def test_cuda_request_without_a_card_raises(two_tones, entry):
    """Each entry point runs on the card unless the caller asks for the CPU,
    arrays included: with no card the default request raises."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    call = {
        "separate": lambda: ts.separate(two_tones, config=pt.SolveConfig(max_iter=1)),
        "stft": lambda: ts.stft(two_tones, 256, 64),
        "istft": lambda: ts.istft(ts._stft_np(two_tones, 256, 64), 256, 64),
    }[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()


def test_public_names():
    assert pt.separate is ts.separate and "separate" in pt.__all__
    from nmf_tpu_torch import models

    for name in ("stft", "istft", "SeparationResult"):
        assert getattr(models, name) is getattr(ts, name)
