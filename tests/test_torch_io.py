"""The port's ``.bin`` I/O and fixtures against ``nmf_tpu.io``: same bytes.

The JAX package's reader is pinned to its NumPy path (``NMF_TPU_NO_NATIVE``)
so the error messages compared are those of the code the port mirrors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu.io import fixtures as jfix  # noqa: E402
from nmf_tpu_torch.io import binio as tbin  # noqa: E402
from nmf_tpu_torch.io import fixtures as tfix  # noqa: E402

SHAPES = [(1, 1), (3, 5), (7, 2), (64, 33)]


@pytest.fixture(autouse=True)
def _numpy_reader(monkeypatch):
    monkeypatch.setenv("NMF_TPU_NO_NATIVE", "1")


def _arr(shape, seed=0):
    return np.random.RandomState(seed + shape[0] * 100 + shape[1]).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_write_matrix_bytes_identical(tmp_path, shape):
    a = _arr(shape)
    jbin.write_matrix(a, tmp_path / "j.bin")
    tbin.write_matrix(a, tmp_path / "t.bin")
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    assert (tmp_path / "t.bin").stat().st_size == 8 + 4 * a.size


@pytest.mark.parametrize("shape", SHAPES)
def test_read_matrix_both_directions(tmp_path, shape):
    a = _arr(shape, seed=1)
    jbin.write_matrix(a, tmp_path / "j.bin")
    tbin.write_matrix(a, tmp_path / "t.bin")
    for reader_out in (tbin.read_matrix(tmp_path / "j.bin"), jbin.read_matrix(tmp_path / "t.bin")):
        assert reader_out.dtype == np.float32 and reader_out.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(reader_out, a)


def test_write_matrix_accepts_cpu_tensor(tmp_path):
    a = _arr((5, 4))
    tbin.write_matrix(torch.from_numpy(a), tmp_path / "t.bin")
    jbin.write_matrix(a, tmp_path / "j.bin")
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()


def test_header_helpers_match():
    assert tbin.pack_header(4096, 350) == jbin.pack_header(4096, 350)
    assert tbin.MAGICLESS_HEADER_BYTES == jbin.MAGICLESS_HEADER_BYTES == 8


def test_reference_fixtures_bytes_identical(tmp_path):
    pj = jfix.write_reference_fixtures(tmp_path / "j")
    pt = tfix.write_reference_fixtures(tmp_path / "t")
    assert sorted(pj) == sorted(pt) == ["H", "W", "X"]
    for name in pj:
        with open(pj[name], "rb") as fj, open(pt[name], "rb") as ft:
            assert fj.read() == ft.read(), name


def test_reference_arrays_and_as_seen_by_solver_match():
    aj, at = jfix.reference_fixture_arrays(), tfix.reference_fixture_arrays()
    assert tfix.REFERENCE_SHAPES == jfix.REFERENCE_SHAPES
    for name in aj:
        np.testing.assert_array_equal(aj[name], at[name])
        np.testing.assert_array_equal(
            jfix.as_seen_by_solver(aj[name]), tfix.as_seen_by_solver(at[name])
        )


def test_fixture_files_read_as_seen_by_solver(tmp_path):
    """The generator's C-order bytes read back column-major, in the port."""
    paths = tfix.write_reference_fixtures(tmp_path)
    arrays = tfix.reference_fixture_arrays()
    for name, path in paths.items():
        np.testing.assert_array_equal(
            tbin.read_matrix(path), tfix.as_seen_by_solver(arrays[name])
        )


def test_random_nonneg_matches():
    np.testing.assert_array_equal(
        jfix.random_nonneg((6, 9), seed=3, low=0.5, high=2.0),
        tfix.random_nonneg((6, 9), seed=3, low=0.5, high=2.0),
    )


def _errors(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test compares what was raised
        return type(e), str(e)
    return None


@pytest.mark.parametrize("keep", [3, 8, 8 + 4 * 5])
def test_truncated_file_raises_same(tmp_path, keep):
    path = tmp_path / "x.bin"
    jbin.write_matrix(_arr((4, 6)), path)
    path.write_bytes(path.read_bytes()[:keep])
    ej, et = _errors(lambda: jbin.read_matrix(path)), _errors(lambda: tbin.read_matrix(path))
    assert ej is not None and ej[0] is ValueError
    assert et == ej


def test_missing_file_raises_same(tmp_path):
    path = tmp_path / "absent.bin"
    ej, et = _errors(lambda: jbin.read_matrix(path)), _errors(lambda: tbin.read_matrix(path))
    assert ej is not None and ej[0] is FileNotFoundError
    assert et == ej


def test_non_2d_write_raises_same(tmp_path):
    a = np.zeros((2, 3, 4), np.float32)
    ej = _errors(lambda: jbin.write_matrix(a, tmp_path / "j.bin"))
    et = _errors(lambda: tbin.write_matrix(a, tmp_path / "t.bin"))
    assert ej is not None and et == ej
