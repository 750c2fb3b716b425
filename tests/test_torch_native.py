"""The port's native ``.bin`` reader (``nmf_tpu_torch.io.native``) on the CPU.

The module builds its own copy of the library from ``native/binio.cpp``
with ``g++`` into a temporary directory and points ``NMF_TPU_NATIVE_LIB``
at it (it never runs ``make -C native``, which writes
``native/libnmfio.so`` and would race tests/test_native.py under several
workers).  Every read and write is held byte for byte to ``nmf_tpu``'s
NumPy ``binio`` and to the port's own NumPy path (``NMF_TPU_NO_NATIVE=1``);
the streamed solve gives the same bits with native reads and without.
"""

import os
import pathlib
import shutil
import struct
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu.io import native as jnative  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.io import binio as pbin  # noqa: E402
from nmf_tpu_torch.io import native  # noqa: E402
from nmf_tpu_torch.models import streaming as pstream  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _gxx(src, out):
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(out), str(src)],
                   check=True, capture_output=True, timeout=240)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build native/binio.cpp")
    out = tmp_path_factory.mktemp("native") / "libnmfio.so"
    _gxx(REPO / "native" / "binio.cpp", out)
    return out


@pytest.fixture
def lib(built, monkeypatch):
    """The built library as the explicit NMF_TPU_NATIVE_LIB, loaded afresh,
    and the read counts at 0."""
    monkeypatch.setenv("NMF_TPU_NATIVE_LIB", str(built))
    monkeypatch.delenv("NMF_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    native.reset_counts()
    assert native.available()
    return built


def _numpy_path(monkeypatch, fn):
    """fn() with both packages on their NumPy paths."""
    monkeypatch.setenv("NMF_TPU_NO_NATIVE", "1")
    try:
        return fn()
    finally:
        monkeypatch.delenv("NMF_TPU_NO_NATIVE")


def _py_write(a, path):
    rows, cols = a.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<II", rows, cols))
        f.write(np.asarray(a, "<f4").tobytes(order="F"))


SHAPES = [(1, 7), (7, 1), (1, 1), (65, 129), (64, 64), (123, 77)]


@pytest.mark.parametrize("shape", SHAPES)
def test_read_matches_numpy_paths(lib, tmp_path, monkeypatch, shape):
    a = np.random.RandomState(shape[0] * 31 + shape[1]).rand(*shape).astype(np.float32)
    p = tmp_path / "a.bin"
    _py_write(a, p)
    out = native.read_matrix_native(p)
    assert out.flags.c_contiguous and out.dtype == np.float32
    ref_j = _numpy_path(monkeypatch, lambda: jbin.read_matrix(p))
    ref_p = _numpy_path(monkeypatch, lambda: pbin.read_matrix(p))
    assert out.tobytes() == ref_j.tobytes() == ref_p.tobytes() == a.tobytes()
    assert native.READS["matrix"] == 1


@pytest.mark.parametrize("shape", SHAPES)
def test_write_matches_numpy_paths(lib, tmp_path, monkeypatch, shape):
    a = np.random.RandomState(shape[0] + 7 * shape[1]).rand(*shape).astype(np.float32)
    native.write_matrix_native(a, tmp_path / "n.bin")
    _numpy_path(monkeypatch, lambda: jbin.write_matrix(a, tmp_path / "j.bin"))
    _numpy_path(monkeypatch, lambda: pbin.write_matrix(a, tmp_path / "p.bin"))
    assert (tmp_path / "n.bin").read_bytes() == (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "p.bin").read_bytes()


def test_binio_delegates_and_the_kill_switch(lib, tmp_path, monkeypatch):
    """binio reads through the library when it is there; NMF_TPU_NO_NATIVE=1
    takes NumPy; the bytes are the same."""
    a = np.random.RandomState(3).rand(33, 44).astype(np.float32)
    pbin.write_matrix(a, tmp_path / "d.bin")
    assert pbin.read_matrix(tmp_path / "d.bin").tobytes() == a.tobytes()
    assert native.READS["matrix"] == 1
    b = _numpy_path(monkeypatch, lambda: pbin.read_matrix(tmp_path / "d.bin"))
    assert native.READS["matrix"] == 1 and b.tobytes() == a.tobytes()


def test_missing_file_is_file_not_found(lib, tmp_path):
    """A missing path is FileNotFoundError before any native call, as JAX's."""
    with pytest.raises(FileNotFoundError) as ep:
        pbin.read_matrix(tmp_path / "gone.bin")
    with pytest.raises(FileNotFoundError) as ej:
        jbin.read_matrix(tmp_path / "gone.bin")
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("span", [(0, 128), (437, 500), (7, 8), (0, 500), (250, 250)])
def test_read_columns(lib, tmp_path, span):
    a = np.random.RandomState(9).rand(123, 500).astype(np.float32)
    p = tmp_path / "cols.bin"
    _py_write(a, p)
    j0, j1 = span
    got = native.read_columns_native(p, 123, 500, j0, j1)
    assert got.flags.c_contiguous and got.tobytes() == np.ascontiguousarray(a[:, j0:j1]).tobytes()
    out = np.full((123, j1 - j0), -1.0, np.float32)
    assert native.read_columns_native(p, 123, 500, j0, j1, out=out) is out
    assert out.tobytes() == got.tobytes()
    assert native.READS["columns"] == 2


def test_read_columns_refusals(lib, tmp_path):
    a = np.ones((12, 50), np.float32)
    p = tmp_path / "c.bin"
    _py_write(a, p)
    with pytest.raises(ValueError, match="file smaller than header claims"):
        native.read_columns_native(p, 12, 50, 40, 51)
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.read_columns_native(p, 12, 50, 0, 5, out=np.zeros((5, 12), np.float32).T)
    with pytest.raises(ValueError, match="cannot open file"):
        native.read_columns_native(tmp_path / "nope.bin", 12, 50, 0, 5)


def test_error_texts_are_jaxs():
    assert native._ERRORS == jnative._ERRORS
    assert set(native.__all__) >= set(jnative.__all__)


@pytest.mark.parametrize("span", [(0, 300), (100, 260), (299, 300)])
def test_bin_column_source_native_and_numpy_agree(lib, tmp_path, monkeypatch, span):
    """BinColumnSource takes the native reader (counted) and gives NumPy's
    bytes, through ``columns`` and ``columns_into``."""
    a = np.random.RandomState(4).rand(96, 300).astype(np.float32)
    p = tmp_path / "src.bin"
    _py_write(a, p)
    src = pstream.BinColumnSource(p)
    j0, j1 = span
    nat = src.columns(j0, j1)
    into = np.empty((96, j1 - j0), np.float32)
    src.columns_into(j0, j1, into)
    assert native.READS["columns"] == 2
    ref = _numpy_path(monkeypatch, lambda: src.columns(j0, j1))
    ref_into = np.empty_like(into)
    _numpy_path(monkeypatch, lambda: src.columns_into(j0, j1, ref_into))
    assert native.READS["columns"] == 2
    assert nat.tobytes() == into.tobytes() == ref.tobytes() == ref_into.tobytes() == \
        np.ascontiguousarray(a[:, j0:j1]).tobytes()


def test_short_file_raises_the_numpy_paths_error(lib, tmp_path, monkeypatch):
    """A file cut after the source was opened: the same message on both paths."""
    p = tmp_path / "X.bin"
    _py_write(np.ones((8, 8), np.float32), p)
    src = pstream.BinColumnSource(p)
    with open(p, "r+b") as f:
        f.truncate(8 + 8 * 6 * 4)
    with pytest.raises(ValueError) as e_nat:
        src.columns(4, 8)
    with pytest.raises(ValueError) as e_np:
        _numpy_path(monkeypatch, lambda: src.columns(4, 8))
    assert str(e_nat.value) == str(e_np.value) and "short read in" in str(e_nat.value)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16", "int8"])
def test_streamed_solve_same_bits_native_or_not(lib, tmp_path, monkeypatch, x_dtype):
    """The streamed solve from a .bin file: the factors of the native reads
    are those of the NumPy reads, bit for bit, and within the streamed
    parity bar of tests/test_torch_streaming.py (rtol 1e-5, history 1e-6;
    int8 X and bf16 X as that file holds them) of ``nmf_tpu``'s."""
    from nmf_tpu.models import streaming as jstream
    from nmf_tpu.utils import config as jcfg

    rng = np.random.RandomState(17)
    x, w, h = rng.rand(96, 1000), rng.rand(96, 12), rng.rand(12, 1000)
    x, w, h = (a.astype(np.float32) for a in (x, w, h))
    p = tmp_path / "X.bin"
    _py_write(x, p)
    cfg = pt.SolveConfig(max_iter=10, check_every=5, precision=pt.Precision(x_dtype=x_dtype))
    nat = pt.solve_out_of_core(str(p), w, h, cfg, block_n=256, device="cpu")
    assert native.READS["columns"] > 0
    ref = _numpy_path(monkeypatch, lambda: pt.solve_out_of_core(str(p), w, h, cfg, block_n=256,
                                                                device="cpu"))
    assert torch.equal(nat.w, ref.w) and torch.equal(nat.h, ref.h)
    assert torch.equal(nat.cost_history, ref.cost_history)
    jc = jcfg.SolveConfig(max_iter=10, check_every=5, precision=jcfg.Precision(x_dtype=x_dtype))
    jres = _numpy_path(monkeypatch, lambda: jstream.solve_out_of_core(str(p), w, h, jc, block_n=256))
    np.testing.assert_allclose(nat.w.float().numpy(), np.asarray(jres.w, np.float32),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(nat.cost_history.numpy(), np.asarray(jres.cost_history), rtol=1e-6)


def test_dataset_reads_natively(lib, tmp_path, monkeypatch):
    """BinDataset's thread pool reads through the library: one native read
    a file, the NumPy path's bytes."""
    rng = np.random.RandomState(1)
    for i in range(5):
        _py_write(rng.rand(20, 30).astype(np.float32), tmp_path / f"f{i}.bin")
    ds = pt.BinDataset(tmp_path, max_workers=3)
    nat = ds.load_batch()
    assert native.READS["matrix"] == 5
    ref = _numpy_path(monkeypatch, ds.load_batch)
    assert nat.tobytes() == ref.tobytes() and native.READS["matrix"] == 5


def test_a_miss_does_not_latch(built, tmp_path, monkeypatch):
    """A load that finds no library returns None and tries again on the next
    call: a library that appears later is loaded (JAX latches the miss)."""
    monkeypatch.delenv("NMF_TPU_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    target = tmp_path / "later" / "libnmfio.so"
    monkeypatch.setattr(native, "_candidate_paths", lambda: iter([str(target)]))
    assert native.load() is None and not native.available()
    target.parent.mkdir()
    shutil.copy(built, target)
    assert native.load() is not None and native.available()


def test_a_success_stays_cached(lib, monkeypatch):
    first = native.load()
    monkeypatch.setenv("NMF_TPU_NATIVE_LIB", "/nonexistent/libnmfio.so")
    assert native.load() is first


@pytest.mark.parametrize("case", ["missing", "not_a_library", "abi"])
def test_a_bad_explicit_path_raises_on_every_call(tmp_path, monkeypatch, case):
    """NMF_TPU_NATIVE_LIB that is missing, not a library, or of another ABI
    raises, every call: a caller that named a library never gets another."""
    path = tmp_path / "lib.so"
    if case == "not_a_library":
        path.write_bytes(b"not a library")
    elif case == "abi":
        if shutil.which("g++") is None:
            pytest.skip("no g++")
        src = tmp_path / "abi.cpp"
        src.write_text('extern "C" int nmf_native_abi_version() { return 2; }\n')
        _gxx(src, path)
    monkeypatch.setenv("NMF_TPU_NATIVE_LIB", str(path))
    monkeypatch.setattr(native, "_lib", None)
    err, match = {"missing": (FileNotFoundError, "does not exist"),
                  "not_a_library": (RuntimeError, "failed to load"),
                  "abi": (RuntimeError, "ABI version 2")}[case]
    for _ in range(3):
        with pytest.raises(err, match=match):
            native.load()
    with pytest.raises(err):
        pbin.read_matrix(REPO / "README.md")   # binio asks the loader too


def test_unavailable_entry_points_raise(monkeypatch):
    monkeypatch.delenv("NMF_TPU_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_candidate_paths", lambda: iter([]))
    for fn, args in ((native.read_matrix_native, ("x.bin",)),
                     (native.read_columns_native, ("x.bin", 1, 1, 0, 1)),
                     (native.write_matrix_native, (np.zeros((1, 1)), "x.bin"))):
        with pytest.raises(RuntimeError, match="not available"):
            fn(*args)
    assert not native.has_read_columns()


def test_default_candidate_is_the_make_target(monkeypatch):
    monkeypatch.delenv("NMF_TPU_NATIVE_LIB", raising=False)
    assert list(native._candidate_paths()) == [str(REPO / "native" / "libnmfio.so")]
    monkeypatch.setenv("NMF_TPU_NATIVE_LIB", "/x/y.so")
    assert list(native._candidate_paths())[0] == "/x/y.so"
    assert os.path.basename(list(jnative._candidate_paths())[-1]) == "libnmfio.so"
