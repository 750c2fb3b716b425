"""``nmf_tpu_torch.utils.doctor`` (``python -m nmf_tpu_torch doctor``).

The up path runs the real bounded subprocess against the CPU; the down
paths inject a runner, as tests/test_doctor.py does for ``nmf_tpu``'s
doctor: a timeout, a crash, no sentinel, and a sentinel that is not JSON
(which ``nmf_tpu``'s doctor turns into a traceback: the port reports it
down).
"""

import json
import subprocess

import pytest

torch = pytest.importorskip("torch")

from nmf_tpu.utils import doctor as jdoctor  # noqa: E402
from nmf_tpu_torch.utils import doctor  # noqa: E402


class _Proc:
    def __init__(self, rc=0, out="", err=""):
        self.returncode, self.stdout, self.stderr = rc, out, err


def test_up_on_cpu():
    report = doctor.diagnose(platform="cpu", timeout=300.0)
    assert report["up"] is True
    b = report["backend"]
    assert b["platform"] == "cpu" and b["n_devices"] == 1 and b["matmul_ok"] is True
    assert b["h2d_gbps"] > 0 and b["d2h_gbps"] > 0
    assert report["versions"]["torch"] == torch.__version__
    assert {"dir", "libraries", "bytes", "current_built"} <= set(report["kernel_build"])
    text = doctor.format_report(report)
    assert "UP" in text and "cpu" in text and "kernel build" in text


def test_the_child_checks_the_exact_matmul():
    """The child's check is JAX's: 3 * 3 * 128 = 1152, exact in f32."""
    assert "v == 3.0 * 3.0 * 128" in doctor._CHILD and "v == 3.0 * 3.0 * 128" in jdoctor._CHILD
    assert "import jax" not in doctor._CHILD


def test_cuda_without_a_card_is_down():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    report = doctor.diagnose(timeout=300.0)
    assert report["up"] is False and "is_available" in report["error"]


def test_timeout_is_structured_down():
    def hang(*a, **kw):
        raise subprocess.TimeoutExpired(cmd="x", timeout=kw.get("timeout", 1))

    report = doctor.diagnose(platform="cpu", timeout=0.01, _run=hang)
    assert report["up"] is False and "hung" in report["error"]
    assert "listed device is not a usable one" in report["error"]
    assert "DOWN" in doctor.format_report(report)


@pytest.mark.parametrize("proc,words", [
    (_Proc(1, err="boom"), "crashed: boom"),
    (_Proc(0, out="chatter only\n"), "no sentinel"),
    (_Proc(0, out="NMFDOC={not json\n"), "not JSON"),
    (_Proc(0, out="NMFDOC=[1, 2]\n"), "not a JSON object"),
    (_Proc(0, out='NMFDOC={"matmul_ok": false, "platform": "cuda"}\n'), None),
], ids=["crash", "no_sentinel", "bad_json", "not_object", "wrong_value"])
def test_down_paths(proc, words):
    report = doctor.diagnose(platform="cpu", _run=lambda *a, **k: proc)
    assert report["up"] is False
    if words is not None:
        assert words in report["error"]
    assert "DOWN" in doctor.format_report(report)


def test_jaxs_doctor_raises_on_a_bad_sentinel_and_the_ports_does_not():
    """The fault the port does not inherit (ROADMAP.md Queue 3)."""
    bad = lambda *a, **k: _Proc(0, out="NMFDOC={oops\n")  # noqa: E731
    with pytest.raises(json.JSONDecodeError):
        jdoctor.diagnose(platform="cpu", _run=bad)
    assert doctor.diagnose(platform="cpu", _run=bad)["up"] is False


def test_the_child_gets_the_platform_and_the_timeout():
    seen = {}

    def run(cmd, **kw):
        seen.update(cmd=cmd, **kw)
        return _Proc(0, out='NMFDOC={"matmul_ok": true, "platform": "cpu", "n_devices": 1, '
                           '"device_kind": "cpu", "enumerate_s": 0, "dispatch_s": 0, '
                           '"h2d_gbps": 1, "d2h_gbps": 1}\n')

    report = doctor.diagnose(platform="cpu", timeout=12.5, _run=run)
    assert report["up"] is True and seen["timeout"] == 12.5
    assert seen["cmd"][2].startswith("PLAT = 'cpu'\n")
    assert "UP" in doctor.format_report(report)


def test_kernel_build_stats(tmp_path, monkeypatch):
    from nmf_tpu_torch.ops.kernels import _build

    lib = tmp_path / "build" / "nmf_tpu_torch" / "abc" / "libnmf_kernels.so"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"x" * 100)
    (lib.parent / "build.log").write_text("log")
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    stats = doctor._build_stats()
    assert stats == {"dir": str(lib.parent.parent), "current_built": True, "libraries": 1,
                     "bytes": 103}
