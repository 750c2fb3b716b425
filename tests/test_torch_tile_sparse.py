"""The tile-sparse solve of the port against ``nmf_tpu`` on the CPU.

The same inputs, made from a seed with NumPy, go through both packages:

* the host-side pieces -- ``sweep_plan``, ``tiles_from_coo`` /
  ``tiles_from_dense``, ``_pad_tiles_np``, ``_quantize_tiles_np`` -- are
  byte-equal to ``nmf_tpu``'s;
* ``h_numerator`` / ``w_numerator`` (the plain route, CPU tensors) against
  the Pallas kernel K5 in interpret mode, as ``tests/test_pallas.py`` runs
  it, in every mode of the kernel;
* ``solve_sparse_tiled`` against ``nmf_tpu``'s (its scan path on the CPU),
  per precision tier, on a ragged problem, and against the port's own dense
  ``solve(clamp_inputs=False)``.

Tolerances, between two packages whose sums run in other orders:

* f32-GEMM modes (f32 or bf16 tiles, ``float32_fast``): numerators rtol
  1e-4 / atol 1e-6; solves' factors rtol 1e-4 / atol 2e-6 and costs rtol
  1e-5 (``tests/test_sparse.py``'s own).
* Solves diverge chaotically from ``nmf_tpu`` over many iterations: a
  last-ulp difference is amplified some 500-fold by 30 iterations of this
  problem (f32 against f32: 4.3e-5 from ~1e-7 per op), and under
  ``bfloat16`` a flipped Z rounding (from iteration 5 on here) moves every
  later iterate.  So each tier is held twice.  Over 3 iterations, before
  any flip: factors rtol 1e-5 (``float32_fast``, against XLA:CPU's true f32
  in the JAX scan, 1e-4: measured 3.3e-5), costs 1e-6.  Over 30 iterations,
  at what was measured there with room: f32, int8 tiles and bf16 state
  (bitwise equal to ``nmf_tpu`` here) at ``tests/test_sparse.py``'s own
  rtol 1e-4 / atol 2e-6, costs 1e-5; ``float32_fast`` rtol 2e-3 (measured
  1.1e-3; the port's dense ``float32_fast`` solve reads 6.0e-4 for W on
  the same problem); ``bfloat16`` rtol 5e-2 (measured 3.7e-2 on one entry
  of 1280, RMS 5e-3; ``nmf_tpu``'s own dense and tiled ``bfloat16`` solves
  differ by 2.1e-2 here), costs 1e-4.
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
from nmf_tpu.models import sparse_tiled as jst  # noqa: E402
from nmf_tpu.ops.pallas import tile_sparse as jts  # noqa: E402
from nmf_tpu_torch.models import sparse_tiled as pst  # noqa: E402
from nmf_tpu_torch.ops.kernels import tile_sparse as pts  # noqa: E402
from nmf_tpu_torch.utils.convert import (  # noqa: E402
    config_from_dict,
    result_to_numpy,
    tile_sparse_from,
)

from oracle import clamp  # noqa: E402

EPS = float(np.float32(2.2204e-16))
F32_TOL = (1e-4, 1e-6)          # numerators: rtol, atol
BF16_RTOL = 2e-3
SOLVE_TOL = (1e-4, 2e-6, 1e-5)  # solves: factors rtol, atol; cost rtol
SOLVE_SPLIT3_TOL = (2e-3, 2e-6, 1e-5)
SOLVE_BF16_TOL = (5e-2, 2e-6, 1e-4)
EARLY_TOL = (1e-5, 1e-7, 1e-6)      # 3 iterations
EARLY_SPLIT3_TOL = (1e-4, 1e-7, 1e-6)

# kernel modes: name -> (Precision fields, W/H bf16, tiles bf16, rtol)
MODES = {
    "float32": (("float32", "float32", "float32"), False, False, F32_TOL[0]),
    "float32_fast": (("float32_fast", "float32", "float32"), False, False, F32_TOL[0]),
    "bfloat16": (("bfloat16", "float32", "float32"), False, False, BF16_RTOL),
    "bf16_tiles": (("float32", "float32", "bfloat16"), False, True, F32_TOL[0]),
    "bf16_state": (("bfloat16", "bfloat16", "bfloat16"), True, True, BF16_RTOL),
}
# solve tiers: name -> Precision fields
TIERS = {
    "float32": ("float32", "float32", "float32"),
    "float32_fast": ("float32_fast", "float32", "float32"),
    "int8": ("float32", "float32", "int8"),
    "bf16_state": ("bfloat16", "bfloat16", "bfloat16"),
    "bfloat16": ("bfloat16", "float32", "float32"),
}


def _pallas_problem():
    """``tests/test_pallas.py``'s tile problem: 512 x 640, K=16, 128^2 tiles,
    column blocks 1 and 3 empty."""
    rng = np.random.RandomState(3)
    bm = bn = 128
    m, k, n = 512, 16, 640
    x = np.zeros((m, n), np.float32)
    for (i, j) in [(0, 0), (1, 2), (3, 4), (2, 2), (0, 4)]:
        blk = rng.rand(bm, bn).astype(np.float32)
        blk[rng.rand(bm, bn) < 0.6] = 0
        x[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] = blk
    w = clamp(rng.rand(m, k).astype(np.float32))
    h = clamp(rng.rand(k, n).astype(np.float32))
    return x, w, h


def _tiled_problem():
    """``tests/test_sparse.py``'s clustered problem: 160 x 200, K=8, a 5 x 7
    grid of 32^2 tiles (the last column ragged)."""
    rng = np.random.RandomState(41)
    m, k, n = 160, 8, 200
    x = np.zeros((m, n), np.float32)
    for (bi, bj) in [(0, 0), (1, 3), (2, 5), (4, 6), (3, 1), (0, 4)]:
        blk = rng.rand(32, 32).astype(np.float32)
        blk[rng.rand(32, 32) < 0.5] = 0.0
        x[bi * 32:(bi + 1) * 32, bj * 32:min((bj + 1) * 32, n)] = blk[:, : min(32, n - bj * 32)]
    w = rng.rand(m, k).astype(np.float32)
    h = rng.rand(k, n).astype(np.float32)
    return x, w, h


def _ragged_problem():
    """``tests/test_sparse.py``'s ragged case: 45 x 70, K=4, duplicates."""
    rng = np.random.RandomState(7)
    m, k, n = 45, 4, 70
    x = np.zeros((m, n), np.float32)
    x[rng.rand(m, n) > 0.9] = 1.0
    x[np.arange(m), rng.randint(0, n, m)] += 0.5
    x[rng.randint(0, m, n), np.arange(n)] += 0.5
    w = rng.rand(m, k).astype(np.float32)
    h = rng.rand(k, n).astype(np.float32)
    return x, w, h


PROBLEMS = {
    "pallas": (_pallas_problem, (128, 128)),
    "tiled": (_tiled_problem, (32, 32)),
    "ragged": (_ragged_problem, (32, 32)),
}


@pytest.fixture(scope="module")
def problems():
    return {name: fn() for name, (fn, _) in PROBLEMS.items()}


@pytest.fixture(autouse=True)
def _zero_counts():
    pts.reset_counts()
    yield
    pts.reset_counts()


def _jprec(fields):
    return jt.Precision(*fields)


def _pconfig(jcfg, **kw):
    return dataclasses.replace(config_from_dict(dataclasses.asdict(jcfg)), **kw)


# --- host-side pieces, byte for byte --------------------------------------------


@pytest.mark.parametrize("by", ["col", "row"])
@pytest.mark.parametrize("name", ["pallas", "tiled"])
def test_sweep_plan_matches_jax(problems, name, by):
    x = problems[name][0]
    tile = PROBLEMS[name][1]
    tx = jst.tiles_from_dense(x, tile)
    grid = (-(-x.shape[0] // tile[0]), -(-x.shape[1] // tile[1]))
    n_out = grid[1] if by == "col" else grid[0]
    ref = jts.sweep_plan(np.asarray(tx.rows), np.asarray(tx.cols), n_out, by)
    ours = pts.sweep_plan(np.asarray(tx.rows), np.asarray(tx.cols), n_out, by)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)
    # sentinels mark exactly the empty output blocks
    key = ours[2] if by == "col" else ours[1]
    assert np.all(np.diff(key) >= 0) and set(key.tolist()) == set(range(n_out))


def _assert_tiles_equal(ours, ref):
    assert np.asarray(ours.tiles).tobytes() == np.asarray(ref.tiles).tobytes()
    assert np.asarray(ours.tiles).dtype == np.float32
    assert np.array_equal(np.asarray(ours.rows), np.asarray(ref.rows))
    assert np.array_equal(np.asarray(ours.cols), np.asarray(ref.cols))
    assert np.asarray(ours.rows).dtype == np.asarray(ref.rows).dtype == np.int32
    assert ours.shape == ref.shape and ours.tile_shape == ref.tile_shape
    assert ours.occupancy() == ref.occupancy()


@pytest.mark.parametrize("name", ["pallas", "tiled", "ragged", "all_zero"])
def test_tiles_from_dense_matches_jax(problems, name):
    if name == "all_zero":
        x, tile = np.zeros((64, 48), np.float32), (32, 32)
    else:
        x, tile = problems[name][0], PROBLEMS[name][1]
    ours, ref = pst.tiles_from_dense(x, tile), jst.tiles_from_dense(x, tile)
    _assert_tiles_equal(ours, ref)
    if name == "all_zero":   # one zero tile is kept
        assert np.asarray(ours.tiles).shape == (1, 32, 32)


def test_tiles_from_coo_duplicates_match_jax():
    rng = np.random.RandomState(11)
    rows = rng.randint(0, 45, 300)
    cols = rng.randint(0, 70, 300)
    data = rng.rand(300).astype(np.float32)
    rows[:50], cols[:50] = rows[50:100], cols[50:100]      # duplicates sum
    ours = pst.tiles_from_coo(data, rows, cols, (45, 70), (16, 32))
    _assert_tiles_equal(ours, jst.tiles_from_coo(data, rows, cols, (45, 70), (16, 32)))
    tx = pst.tiles_from_coo([1.0, 2.0, 4.0], [3, 3, 0], [5, 5, 0], (45, 70), (32, 32))
    assert tx.tiles[0, 3, 5] == 3.0 and tx.tiles[0, 0, 0] == 4.0


def test_negative_data_raises_in_both():
    for mod in (pst, jst):
        with pytest.raises(ValueError, match="nonnegative"):
            mod.tiles_from_coo([1.0, -2.0], [0, 1], [0, 1], (4, 4), tile=(2, 2))


@pytest.mark.parametrize("multiple", [4, 16, 64])
def test_pad_tiles_np_matches_jax(problems, multiple):
    tx = jst.tiles_from_dense(problems["tiled"][0], (32, 32))
    args = (np.asarray(tx.tiles), np.asarray(tx.rows), np.asarray(tx.cols), multiple)
    for a, b in zip(pst._pad_tiles_np(*args), jst._pad_tiles_np(*args)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["pallas", "tiled"])
def test_quantize_tiles_np_matches_jax(problems, name):
    tx = jst.tiles_from_dense(problems[name][0], PROBLEMS[name][1])
    # a padding (all-zero) tile too: scale eps / 255, codes 0
    tiles = np.concatenate([np.asarray(tx.tiles), np.zeros((1, *tx.tile_shape), np.float32)])
    codes, scales = pst._quantize_tiles_np(tiles, EPS)
    rc, rs = jst._quantize_tiles_np(tiles, EPS)
    assert codes.dtype == np.uint8 and codes.tobytes() == rc.tobytes()
    assert scales.dtype == np.float32 and scales.tobytes() == rs.tobytes()
    assert not codes[-1].any()


def test_tile_sparse_from_carries_bf16_tiles_bit_for_bit(problems):
    tx = jst.tiles_from_dense(problems["pallas"][0], (128, 128))
    tx = dataclasses.replace(tx, tiles=jnp.asarray(tx.tiles, jnp.bfloat16))
    ours = tile_sparse_from(tx)
    assert ours.tiles.dtype == torch.bfloat16 and ours.shape == tx.shape
    bits = np.asarray(tx.tiles).view(np.int16)
    assert np.array_equal(ours.tiles.view(torch.int16).numpy(), bits)
    assert np.array_equal(ours.rows, np.asarray(tx.rows))


# --- the numerators against the Pallas kernel in interpret mode -------------------


def _bf16_t(a):
    bits = np.asarray(a).astype(ml_dtypes.bfloat16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


@pytest.fixture(scope="module")
def sweep_case(problems):
    """The pallas problem's tiles, plans and operands, and nmf_tpu's
    numerators per mode and target (computed once)."""
    x, w, h = problems["pallas"]
    tx = jst.tiles_from_dense(x, (128, 128))
    rows, cols = np.asarray(tx.rows), np.asarray(tx.cols)
    plans = {"h": jts.sweep_plan(rows, cols, 5, "col"), "w": jts.sweep_plan(rows, cols, 4, "row")}
    ref = {}
    for mode, (fields, state_bf16, tiles_bf16, _) in MODES.items():
        wj, hj, tj = jnp.asarray(w), jnp.asarray(h), jnp.asarray(tx.tiles)
        if state_bf16:
            wj, hj = wj.astype(jnp.bfloat16), hj.astype(jnp.bfloat16)
        if tiles_bf16:
            tj = tj.astype(jnp.bfloat16)
        for target, fn in (("h", jts.h_numerator), ("w", jts.w_numerator)):
            plan = [jnp.asarray(a) for a in plans[target]]
            out = fn(wj, hj, tj, *plan, EPS, _jprec(fields), interpret=True)
            ref[mode, target] = np.asarray(out)
    return tx, plans, ref


def _port_operands(tx, mode):
    x, w, h = _pallas_problem()
    _, state_bf16, tiles_bf16, _ = MODES[mode]
    conv = _bf16_t if state_bf16 else torch.from_numpy
    tiles = np.asarray(tx.tiles)
    return conv(w), conv(h), (_bf16_t(tiles) if tiles_bf16 else torch.from_numpy(tiles))


@pytest.mark.parametrize("target", ["h", "w"])
@pytest.mark.parametrize("mode", list(MODES))
def test_numerator_matches_pallas_interpret(sweep_case, mode, target):
    tx, plans, ref = sweep_case
    fields, _, _, rtol = MODES[mode]
    w, h, tiles = _port_operands(tx, mode)
    fn = pts.h_numerator if target == "h" else pts.w_numerator
    plan = [torch.from_numpy(a) for a in plans[target]]
    out = fn(w, h, tiles, *plan, EPS, pt.Precision(*fields))
    assert out.dtype == torch.float32
    assert tuple(out.shape) == ref[mode, target].shape
    np.testing.assert_allclose(out.numpy(), ref[mode, target], rtol=rtol, atol=F32_TOL[1])
    # CPU tensors take the plain version: no launch, no plain call counted
    assert not any(pts.LAUNCHES.values()) and not any(pts.PLAIN_CALLS.values())


def test_sentinel_blocks_are_exact_zeros(sweep_case):
    """Column blocks 1 and 3 have no tile: their sentinel entries leave the
    H numerator exactly zero there."""
    tx, plans, _ = sweep_case
    x, w, h = _pallas_problem()
    plan = [torch.from_numpy(a) for a in plans["h"]]
    out = pts.h_numerator(torch.from_numpy(w), torch.from_numpy(h),
                          torch.from_numpy(np.asarray(tx.tiles)), *plan, EPS).numpy()
    assert np.all(out[:, 128:256] == 0.0) and np.all(out[:, 384:512] == 0.0)
    assert np.all(out[:, :128] > 0.0)
    # and the plain sweep equals the dense numerator with exact zeros
    z = x / np.maximum(w @ h, np.float32(EPS))
    np.testing.assert_allclose(out, w.T @ z, rtol=1e-5, atol=1e-6)


def _long_problem():
    """12 tiles down column block 0 of a 1536 x 256 X (and one in column
    block 1), K=8, 128^2 tiles: the H target's run of block 0 crosses many
    of K5's pieces."""
    rng = np.random.RandomState(23)
    m, k, n = 1536, 8, 256
    x = np.zeros((m, n), np.float32)
    for (i, j) in [(i, 0) for i in range(12)] + [(3, 1)]:
        blk = rng.rand(128, 128).astype(np.float32)
        blk[rng.rand(128, 128) < 0.5] = 0
        x[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = blk
    return x, clamp(rng.rand(m, k).astype(np.float32)), clamp(rng.rand(k, n).astype(np.float32))


# plans whose runs are longer than K5's pieces: name -> (problem, pad)
LONG_PLANS = {
    "padded": (_pallas_problem, 16),   # 11 duplicate zero tiles at block (0, 0)
    "long": (_long_problem, 1),
}


@pytest.fixture(scope="module")
def long_cases():
    """Per plan: the operands, the plans and nmf_tpu's numerators (Pallas K5
    in interpret mode) per mode and target."""
    cases = {}
    for name, (make, pad) in LONG_PLANS.items():
        x, w, h = make()
        tx = jst.tiles_from_dense(x, (128, 128))
        tiles, rows, cols = pst._pad_tiles_np(np.asarray(tx.tiles), np.asarray(tx.rows),
                                              np.asarray(tx.cols), pad)
        mb, nb = x.shape[0] // 128, x.shape[1] // 128
        plans = {"h": jts.sweep_plan(rows, cols, nb, "col"), "w": jts.sweep_plan(rows, cols, mb, "row")}
        ref = {}
        for mode, (fields, state_bf16, tiles_bf16, _) in MODES.items():
            wj, hj, tj = jnp.asarray(w), jnp.asarray(h), jnp.asarray(tiles)
            if state_bf16:
                wj, hj = wj.astype(jnp.bfloat16), hj.astype(jnp.bfloat16)
            if tiles_bf16:
                tj = tj.astype(jnp.bfloat16)
            for target, fn in (("h", jts.h_numerator), ("w", jts.w_numerator)):
                out = fn(wj, hj, tj, *(jnp.asarray(a) for a in plans[target]), EPS,
                         _jprec(fields), interpret=True)
                ref[mode, target] = np.asarray(out)
        cases[name] = (w, h, tiles, plans, ref)
    return cases


@pytest.mark.parametrize("target", ["h", "w"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(LONG_PLANS))
def test_numerator_on_long_runs_matches_pallas_interpret(long_cases, case, mode, target):
    """A plan whose output block's run is longer than K5's pieces (chunk
    padding's duplicate zero tiles at block (0, 0), or one tall column
    block), in every mode, against the Pallas kernel in interpret mode."""
    w, h, tiles, plans, ref = long_cases[case]
    fields, state_bf16, tiles_bf16, rtol = MODES[mode]
    key = plans[target][2] if target == "h" else plans[target][1]
    n_out = int(key.max()) + 1
    per, _ = pts.sweep_split(len(key), n_out, 2, 1)
    assert np.bincount(key).max() > per   # the run is cut into pieces
    conv = _bf16_t if state_bf16 else torch.from_numpy
    fn = pts.h_numerator if target == "h" else pts.w_numerator
    out = fn(conv(w), conv(h), _bf16_t(tiles) if tiles_bf16 else torch.from_numpy(tiles),
             *(torch.from_numpy(a) for a in plans[target]), EPS, pt.Precision(*fields))
    assert tuple(out.shape) == ref[mode, target].shape
    np.testing.assert_allclose(out.numpy(), ref[mode, target], rtol=rtol, atol=F32_TOL[1])


def _pieces_np(key, per):
    """K5's pass-1 pieces of a sorted plan, in NumPy: chunks of ``per``
    entries, each cut where the output block changes; (start, end, slot),
    slot the chunk's for a piece that starts it, else n_chunks + block."""
    steps = len(key)
    n_chunks = -(-steps // per)
    starts = np.flatnonzero((np.arange(steps) % per == 0) | np.r_[True, key[1:] != key[:-1]])
    ends = np.r_[starts[1:], steps]
    slots = np.where(starts % per == 0, starts // per, n_chunks + key[starts])
    return list(zip(starts.tolist(), ends.tolist(), slots.tolist()))


def _piece_of(key, per, n_out, slot):
    """csrc/tile_sparse.cu piece_of, line for line: the piece a pass-1
    block of ``slot`` walks, or None."""
    steps = len(key)
    n_chunks = -(-steps // per)
    if slot < n_chunks:
        start = slot * per
    else:
        start = int(np.searchsorted(key, slot - n_chunks))
        if start >= steps or key[start] != slot - n_chunks or start % per == 0:
            return None
    b = int(key[start])
    if not 0 <= b < n_out:
        return None
    chunk_end = min((start // per + 1) * per, steps)
    return start, max(start + 1, min(int(np.searchsorted(key, b + 1)), chunk_end)), b


def _sum_order(key, per, b):
    """csrc/tile_sparse.cu sweep_sum: the slots output block b sums, in order."""
    n_chunks = -(-len(key) // per)
    t0, t1 = np.searchsorted(key, b), np.searchsorted(key, b + 1)
    if t1 <= t0:
        return []
    first = t0 // per if t0 % per == 0 else n_chunks + b
    return [first] + list(range(t0 // per + 1, (t1 - 1) // per + 1))


# random plans: (block grid, occupancy, duplicate zero tiles at (0, 0), slices, K chunks)
SPLIT_CASES = [
    ((8, 8), 0.3, 0, 2, 1),
    ((64, 64), 0.08, 0, 2, 1),      # the main shape's plan
    ((64, 64), 0.08, 64, 2, 1),
    ((3, 5), 0.0, 0, 1, 1),         # one tile, sentinels everywhere else
    ((300, 1), 1.0, 0, 2, 1),       # one run of 300
    ((1, 300), 1.0, 0, 2, 2),
    ((40, 40), 0.5, 0, 3, 8),
    ((100, 7), 0.2, 17, 1, 1),
    ((16, 200), 0.9, 0, 2, 1),
    ((5, 5), 0.6, 100, 2, 4),
    ((128, 128), 0.02, 0, 1, 1),
    ((20, 30), 0.0, 33, 2, 1),      # padding only
]


@pytest.mark.parametrize("by", ["col", "row"])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_sweep_split_matches_the_pieces(case, by):
    """The wrapper's per rule and slot count against a NumPy count of the
    pieces of random plans; every slot a pass-1 block finds (piece_of) is a
    piece, every entry in exactly one, and pass 2 sums each output block's
    pieces in plan order."""
    (mb, nb), occ, pad, slices, k_chunks = SPLIT_CASES[case]
    rng = np.random.RandomState(case)
    occupied = np.argwhere(rng.rand(mb, nb) < occ)
    if len(occupied) == 0:
        occupied = np.array([[mb - 1, nb - 1]])
    tiles = np.zeros((len(occupied), 1, 1), np.float32)
    _, rows, cols = pst._pad_tiles_np(tiles, occupied[:, 0].astype(np.int32),
                                      occupied[:, 1].astype(np.int32), len(occupied) + pad)
    n_out = nb if by == "col" else mb
    perm, rr, cc = pts.sweep_plan(rows, cols, n_out, by)
    key = cc if by == "col" else rr
    steps = len(key)
    per, slots = pts.sweep_split(steps, n_out, slices, k_chunks)
    # the largest per, up to the mean run, whose expected pieces give
    # SWEEP_BLOCKS blocks
    sk, mean_run = slices * k_chunks, -(-steps // n_out)
    expected_blocks = lambda p: (steps + n_out * (p - 1)) * sk / p  # noqa: E731
    assert 1 <= per <= mean_run
    assert per == 1 or expected_blocks(per) >= pts.SWEEP_BLOCKS
    assert per == mean_run or expected_blocks(per + 1) < pts.SWEEP_BLOCKS
    pieces = _pieces_np(key, per)
    assert -(-steps // per) <= len(pieces) <= slots == -(-steps // per) + n_out
    assert len({s for _, _, s in pieces}) == len(pieces) and max(s for _, _, s in pieces) < slots
    assert max(b - a for a, b, _ in pieces) <= per
    found = {slot: _piece_of(key, per, n_out, slot) for slot in range(slots)}
    assert {(p[0], p[1], s) for s, p in found.items() if p} == set(pieces)
    covered = np.concatenate([np.arange(a, b) for a, b, _ in pieces])
    assert np.array_equal(np.sort(covered), np.arange(steps))
    for b in range(n_out):
        mine = sorted((a, s) for a, _, s in pieces if key[a] == b)
        assert _sum_order(key, per, b) == [s for _, s in mine]


@pytest.mark.parametrize("fn", [pts.h_numerator, pts.w_numerator])
def test_empty_tiles_raise(fn):
    w, h = torch.ones((4, 2)), torch.ones((2, 4))
    plan = [torch.zeros(1, dtype=torch.int32)] * 3
    with pytest.raises(ValueError, match="at least one tile"):
        fn(w, h, torch.zeros((0, 2, 2)), *plan, EPS)


# --- the solve ---------------------------------------------------------------------


def _solve_both(data, fields, *, tile=(32, 32), chunk=8, max_iter=30, check_every=10,
                backend="auto"):
    x, w, h = data
    cfg = jt.SolveConfig(max_iter=max_iter, check_every=check_every, precision=_jprec(fields))
    rj = jst.solve_sparse_tiled(x, w, h, cfg, chunk=chunk, tile=tile)
    rp = pt.solve_sparse_tiled(x, w, h, _pconfig(cfg, backend=backend), chunk=chunk, tile=tile,
                               device="cpu")
    return rj, rp


def _assert_solves_agree(rj, rp, tol, state=torch.float32):
    out = result_to_numpy(rp)
    for f in ("iterations", "num_checks", "converged"):
        assert out[f] == np.asarray(getattr(rj, f)), f
    rtol, atol, cost_rtol = tol
    assert rp.w.dtype == state and rp.h.dtype == state
    np.testing.assert_allclose(out["cost_history"], np.asarray(rj.cost_history), rtol=cost_rtol)
    for f in ("w", "h"):
        ref = np.asarray(getattr(rj, f)).astype(np.float32)
        assert out[f].shape == ref.shape
        np.testing.assert_allclose(out[f], ref, rtol=rtol, atol=atol)
    hist = out["cost_history"][: int(out["num_checks"])]
    assert np.all(np.isfinite(hist)) and np.all(np.diff(hist) < 0)


@pytest.fixture(scope="module")
def tier_solves(problems):
    """nmf_tpu's and the port's 30-iteration solves per tier (computed once)."""
    return {tier: _solve_both(problems["tiled"], fields) for tier, fields in TIERS.items()}


@pytest.mark.parametrize("tier", list(TIERS))
def test_solve_tier_matches_jax(tier_solves, tier):
    rj, rp = tier_solves[tier]
    fields = TIERS[tier]
    tol = {"bfloat16": SOLVE_BF16_TOL, "float32_fast": SOLVE_SPLIT3_TOL}.get(fields[0], SOLVE_TOL)
    state = torch.bfloat16 if fields[1] == "bfloat16" else torch.float32
    _assert_solves_agree(rj, rp, tol, state)
    assert int(rp.iterations) == 30 and tuple(rp.w.shape) == (160, 8)


@pytest.mark.parametrize("tier", list(TIERS))
def test_first_iterations_track_jax(problems, tier):
    fields = TIERS[tier]
    rj, rp = _solve_both(problems["tiled"], fields, max_iter=3, check_every=1)
    tol = EARLY_SPLIT3_TOL if fields[0] == "float32_fast" else EARLY_TOL
    state = torch.bfloat16 if fields[1] == "bfloat16" else torch.float32
    _assert_solves_agree(rj, rp, tol, state)


def test_solve_ragged_matches_jax(problems):
    rj, rp = _solve_both(problems["ragged"], TIERS["float32"], chunk=4, max_iter=10,
                         check_every=5)
    assert tuple(rp.w.shape) == (45, 4) and tuple(rp.h.shape) == (4, 70)
    assert rp.h.is_contiguous()
    _assert_solves_agree(rj, rp, SOLVE_TOL)


def test_chunk_does_not_change_the_solve(problems):
    """Padding tiles (zero tiles at block (0, 0)) are inert: the chunk only
    pads the tile list and orders the cost's partial sums."""
    x, w, h = problems["tiled"]
    tx = pt.tiles_from_dense(x, (32, 32))
    cfg = pt.SolveConfig(max_iter=10, check_every=10)
    a = pt.solve_sparse_tiled(tx, w, h, cfg, chunk=4, device="cpu")
    b = pt.solve_sparse_tiled(tx, w, h, cfg, chunk=16, device="cpu")
    np.testing.assert_allclose(a.w.numpy(), b.w.numpy(), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(a.cost_history.numpy(), b.cost_history.numpy(), rtol=1e-5)


def test_tiled_matches_port_dense_unclamped(problems):
    """The exact-zero contract: the tiled solve == the port's dense solve
    with ``clamp_inputs=False`` on clamped factors."""
    x, w, h = problems["tiled"]
    cfg = pt.SolveConfig(max_iter=30, check_every=10)
    eps = np.float32(cfg.eps)
    ref = pt.solve(x, np.maximum(w, eps), np.maximum(h, eps), cfg, clamp_inputs=False,
                   device="cpu")
    res = pt.solve_sparse_tiled(x, w, h, cfg, chunk=8, tile=(32, 32), device="cpu")
    for f in ("w", "h"):
        np.testing.assert_allclose(getattr(res, f).numpy(), getattr(ref, f).numpy(),
                                   rtol=SOLVE_TOL[0], atol=SOLVE_TOL[1])
    np.testing.assert_allclose(res.cost_history.numpy(), ref.cost_history.numpy(),
                               rtol=SOLVE_TOL[2])


def test_k5_route_and_plain_route_agree_on_cpu(problems):
    """On CPU tensors the K5 route's wrappers take the plain sweep: both
    routes give the same bits."""
    x, w, h = problems["tiled"]
    cfg = pt.SolveConfig(max_iter=10, check_every=5)
    a = pt.solve_sparse_tiled(x, w, h, cfg, chunk=8, tile=(32, 32), device="cpu")
    b = pt.solve_sparse_tiled(x, w, h, dataclasses.replace(cfg, backend="jnp"), chunk=8,
                              tile=(32, 32), device="cpu")
    assert torch.equal(a.w, b.w) and torch.equal(a.h, b.h)
    assert torch.equal(a.cost_history, b.cost_history)


def test_hand_built_tile_sparse_x_solves(problems):
    """A TileSparseX carried over from nmf_tpu solves as the dense input."""
    x, w, h = problems["tiled"]
    cfg = pt.SolveConfig(max_iter=10, check_every=10)
    a = pt.solve_sparse_tiled(tile_sparse_from(jst.tiles_from_dense(x, (32, 32))), w, h, cfg,
                              chunk=8, device="cpu")
    b = pt.solve_sparse_tiled(x, w, h, cfg, chunk=8, tile=(32, 32), device="cpu")
    assert torch.equal(a.w, b.w) and torch.equal(a.cost, b.cost)


# --- refusals and the route ----------------------------------------------------------


def _refusal_cases():
    x, w, h = _tiled_problem()
    tx = pt.tiles_from_dense(x, (32, 32))
    cfg = pt.SolveConfig(max_iter=2)
    bad_ids = dataclasses.replace(tx, rows=np.asarray(tx.rows) * 32)   # element indices
    neg = dataclasses.replace(tx, tiles=-np.asarray(tx.tiles))
    return {
        "mesh": (dict(x=tx, mesh=object()), TypeError, "make_mesh"),
        "accelerate": (dict(x=tx, config=dataclasses.replace(cfg, accelerate=True)),
                       NotImplementedError, "accelerate"),
        "live_metrics": (dict(x=tx, config=dataclasses.replace(cfg, live_metrics=True)),
                         NotImplementedError, "live_metrics"),
        "beta": (dict(x=tx, config=dataclasses.replace(cfg, beta=2.0)),
                 NotImplementedError, "KL"),
        "penalties": (dict(x=tx, config=dataclasses.replace(cfg, l1_w=0.1)),
                      NotImplementedError, "KL"),
        "hals": (dict(x=tx, config=dataclasses.replace(cfg, algorithm="hals", beta=2.0)),
                 NotImplementedError, "KL"),
        "shape": (dict(x=tx, w0=w[:-1]), ValueError, "shape mismatch"),
        "block_ids": (dict(x=bad_ids), ValueError, "out of range"),
        "negative": (dict(x=neg), ValueError, "negative"),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_refusals(problems, case):
    """Each case raises its error; ``accelerate``, refused when this test
    was named, runs on the same hand-built tiles and matches
    ``nmf_tpu.solve_sparse_tiled`` (SOLVE_TOL, the momentum bit for bit);
    so does ``live_metrics``, its emissions JAX's.  ``mesh``, refused when
    this test was named, is ported (tests/test_torch_mesh_paths.py): what
    is not a ``make_mesh`` DeviceMesh is refused."""
    kw, err, match = _refusal_cases()[case]
    _, w, h = problems["tiled"]
    if case == "accelerate":
        cfg = jt.SolveConfig(max_iter=2, accelerate=True)
        tx = jst.tiles_from_dense(problems["tiled"][0], (32, 32))
        rj = jst.solve_sparse_tiled(tx, w, h, cfg, chunk=4)
        rp = pt.solve_sparse_tiled(kw["x"], w, h, _pconfig(cfg), chunk=4, device="cpu")
        _assert_solves_agree(rj, rp, SOLVE_TOL)
        assert np.asarray(rj.momentum).tobytes() == rp.momentum.numpy().tobytes()
        return
    if case == "live_metrics":
        # ported: the emissions are JAX's (tests/test_torch_live.py's bars)
        from test_torch_live import assert_emissions_match, jax_emissions, port_emissions

        cfg = jt.SolveConfig(max_iter=4, check_every=2, live_metrics=True)
        tx = jst.tiles_from_dense(problems["tiled"][0], (32, 32))
        _, ref = jax_emissions(lambda: jst.solve_sparse_tiled(tx, w, h, cfg, chunk=4))
        rp, ours = port_emissions(lambda: pt.solve_sparse_tiled(
            kw["x"], w, h, _pconfig(cfg), chunk=4, device="cpu"))
        assert len(ours) == int(rp.num_checks) == 2
        assert_emissions_match(ours, ref)
        return
    args = dict(w0=w, h0=h, config=pt.SolveConfig(max_iter=2), chunk=4, device="cpu")
    args.update(kw)
    with pytest.raises(err, match=match):
        pt.solve_sparse_tiled(**args)


@pytest.mark.parametrize(
    "backend,x_dtype,route",
    [
        ("auto", "float32", "k5"),
        ("pallas", "float32", "k5"),
        ("auto", "bfloat16", "k5"),
        ("jnp", "float32", "plain"),
        ("auto", "int8", "plain"),
        ("pallas", "int8", "plain"),
    ],
)
def test_sweep_route(backend, x_dtype, route):
    cfg = pt.SolveConfig(backend=backend, precision=pt.Precision(x_dtype=x_dtype))
    assert pst.sweep_route(cfg) == route


def test_cuda_request_without_a_card_raises(problems):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    x, w, h = problems["tiled"]
    with pytest.raises(RuntimeError, match="is_available"):
        pt.solve_sparse_tiled(x, w, h, pt.SolveConfig(max_iter=2), tile=(32, 32))
