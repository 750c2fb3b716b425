"""``nmf_tpu_torch.BinDataset`` against ``nmf_tpu.io.dataset.BinDataset``.

A directory of seeded ``.bin`` files goes through both classes: the
arrays are bitwise the same, in the same order, and every refusal raises
the same error with the same message.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu.io.dataset import BinDataset as JDataset  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.io.dataset import BinDataset as PDataset  # noqa: E402


def _dir(tmp_path, n=7, shape=(12, 9), seed=0):
    d = tmp_path / "d"
    d.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        jbin.write_matrix(rng.rand(*shape).astype(np.float32), d / f"s{i:02d}.bin")
    (d / "notes.txt").write_text("not a matrix")
    (d / "sub.bin").mkdir()    # a directory named like a matrix is skipped
    return d


def _error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_public_name():
    assert pt.BinDataset is PDataset and "BinDataset" in pt.__all__


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_load_batch_is_jaxs(tmp_path, workers):
    d = _dir(tmp_path)
    ours, ref = PDataset(d, max_workers=workers), JDataset(d, max_workers=workers)
    assert ours.paths == ref.paths and len(ours) == len(ref) == 7
    assert ours.shape == ref.shape == (12, 9)
    a, b = ours.load_batch(), ref.load_batch()
    assert isinstance(a, np.ndarray) and a.dtype == np.float32 and a.shape == (7, 12, 9)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("indices", [[0], [6, 2, 4], [3, 3]])
def test_load_batch_indices(tmp_path, indices):
    d = _dir(tmp_path)
    assert PDataset(d).load_batch(indices).tobytes() == JDataset(d).load_batch(indices).tobytes()


@pytest.mark.parametrize("batch_size,drop", [(1, False), (3, False), (3, True), (7, True),
                                              (10, False), (10, True)])
def test_iter_batches_is_jaxs(tmp_path, batch_size, drop):
    d = _dir(tmp_path)
    ours = list(PDataset(d).iter_batches(batch_size, drop))
    ref = list(JDataset(d).iter_batches(batch_size, drop))
    assert [a.shape for a in ours] == [b.shape for b in ref]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(ours, ref))


def test_explicit_list_and_pattern(tmp_path):
    d = _dir(tmp_path)
    paths = [d / "s03.bin", d / "s01.bin"]
    assert PDataset(paths).paths == JDataset(paths).paths == [str(p) for p in paths]
    assert PDataset(paths).load_batch().tobytes() == JDataset(paths).load_batch().tobytes()
    assert PDataset(d, pattern="1.bin").paths == JDataset(d, pattern="1.bin").paths


def _mixed(tmp_path):
    d = _dir(tmp_path, n=3)
    jbin.write_matrix(np.ones((12, 10), np.float32), d / "s01.bin")
    return d


@pytest.mark.parametrize("case", ["no_files", "pattern", "shape", "shape_iter", "empty", "batch0",
                                  "batch_neg", "missing_dir"])
def test_errors_are_jaxs(tmp_path, case):
    """No files, a mismatched shape, an empty selection, a batch size below
    1 and a missing directory: the same error type and message."""
    calls = {
        "no_files": lambda cls: cls(tmp_path),
        "pattern": lambda cls: cls(_dir(tmp_path), pattern=".npy"),
        "shape": lambda cls: cls(d).load_batch(),
        "shape_iter": lambda cls: list(cls(d).iter_batches(2)),
        "empty": lambda cls: cls(d).load_batch([]),
        "batch0": lambda cls: list(cls(d).iter_batches(0)),
        "batch_neg": lambda cls: list(cls(d).iter_batches(-2)),
        "missing_dir": lambda cls: cls(tmp_path / "nowhere"),
    }
    d = _mixed(tmp_path) if case in ("shape", "shape_iter", "empty", "batch0", "batch_neg") else None
    if case == "pattern":
        ours = _error(lambda: calls[case](PDataset))
        (tmp_path / "d").rename(tmp_path / "d_p")
        ref = _error(lambda: calls[case](JDataset))
        assert ours[0] is ref[0] and ours[1].split(" in ")[0] == ref[1].split(" in ")[0]
        return
    assert _error(lambda: calls[case](PDataset)) == _error(lambda: calls[case](JDataset))


def test_solve_batched_on_the_dataset(tmp_path):
    """A dataset feeds the batched solve directly: member i is its file."""
    d = _dir(tmp_path, n=3)
    xs = PDataset(d).load_batch()
    rng = np.random.RandomState(2)
    ws, hs = rng.rand(3, 12, 2).astype(np.float32), rng.rand(3, 2, 9).astype(np.float32)
    res = pt.solve_batched(xs, ws, hs, pt.SolveConfig(max_iter=4), device="cpu")
    one = pt.solve(jbin.read_matrix(d / "s01.bin"), ws[1], hs[1], pt.SolveConfig(max_iter=4),
                   device="cpu")
    assert torch.equal(res.cost[1], one.cost)
