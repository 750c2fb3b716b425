"""``nmf_tpu_torch.utils.profiling`` against ``nmf_tpu.utils.profiling``.

The stage timings carry JAX's keys; on the CPU they are host-clock seconds
of the plain torch ops (the card's are CUDA-event times, taken by
chip_smoke.py).  ``trace`` writes a Chrome trace that names what ran.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nmf_tpu.utils import profiling as jprof  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.utils import profiling as pprof  # noqa: E402


def _problem(m=64, k=8, n=48, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(m, n).astype(np.float32), rng.rand(m, k).astype(np.float32),
            rng.rand(k, n).astype(np.float32))


def test_stage_timings_keys_are_jaxs():
    x, w, h = _problem()
    ours = pprof.stage_timings(x, w, h, repeats=1, device="cpu")
    ref = jprof.stage_timings(x, w, h, repeats=1)
    assert set(ours) == set(ref)
    assert all(v > 0 for v in ours.values())
    assert ours["fused_step"] == ours["full_step"]


@pytest.mark.parametrize("repeats", [1, 3])
def test_stage_timings_are_floats_in_seconds(repeats):
    x, w, h = _problem(32, 4, 24)
    t = pprof.stage_timings(x, w, h, eps=1e-12, repeats=repeats, device="cpu")
    assert all(isinstance(v, float) and 0 < v < 60 for v in t.values())


def test_stage_timings_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, w, h = _problem(8, 2, 8)
    with pytest.raises(RuntimeError, match="is_available"):
        pprof.stage_timings(x, w, h, repeats=1)


def test_full_step_is_the_solves_step():
    """full_step times the step solve() takes: one iteration of it gives
    the solve's bits."""
    from nmf_tpu_torch.models.solver import resolve_step_fn

    x, w, h = (torch.from_numpy(a) for a in _problem())
    step = resolve_step_fn(pt.SolveConfig())
    w1, h1 = step(torch.clamp_min(w, pt.EPS), torch.clamp_min(h, pt.EPS), torch.clamp_min(x, pt.EPS))
    res = pt.solve(x, w, h, pt.SolveConfig(max_iter=1), device="cpu")
    assert torch.equal(res.w, w1) and torch.equal(res.h, h1)


def test_trace_writes_a_chrome_trace(tmp_path):
    x, w, h = _problem()
    with pprof.trace(str(tmp_path / "tr")) as prof:
        res = pt.solve(x, w, h, pt.SolveConfig(max_iter=3), device="cpu")
        pprof.force_completion(res.w, res.h)
    assert prof is not None
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:20]
    assert os.path.getsize(path) > 0


def test_trace_leaves_no_file_when_the_body_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with pprof.trace(str(tmp_path / "tr")):
            1 / 0
    assert not (tmp_path / "tr" / "trace.json").exists()


def test_force_completion_takes_any_mix():
    pprof.force_completion(torch.zeros(3), np.zeros(2), 1.0)
    pprof.force_completion()


def test_public_names():
    assert set(pprof.__all__) == set(jprof.__all__) == {"trace", "stage_timings",
                                                         "force_completion"}
