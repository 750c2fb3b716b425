"""The streamed transform's and the online learner's graphs on the CPU.

JAX runs each block of ``transform_out_of_core`` as one cached program
(``_h_only_jit``) and each block of ``solve_online`` as one jitted update
(``_online_jit``).  On the card the port replays CUDA graphs kept for the
call (``solver.StreamGraphs``): a graph per stream slot and block width,
reading X where the block lands in the stream's two fixed device buffers
(the mask's and int8's scales' too), the transform's check blocks through
``run_checked_loop`` and the online learner's whole block update
(``online._OnlineGraph``).  The CPU has no graphs, so these tests run the
route with tests/test_torch_graph.py's stand-in for the graph API (a
capture runs the part's Python and undoes its work, a replay reruns it on
the capture's buffers), extended here: each captured part must read
nothing back to the host, and at each replay X must lie at the addresses
it had at the capture, as a CUDA graph bakes them in.  At M=64, N=600,
K=8, blocks of 128 and a ragged last block of 88:

(a) the transform graphed gives ``solver.eager_loop()``'s bits (H, costs,
    iterations, flags) and the same K1/K3 launches (the wrappers counted
    as the card counts them), in f32, bf16 X, int8 X (per column and per
    row block), masked (f32 and bf16 X), ``thresh > 0`` and accelerated,
    and ``nmf_tpu.transform_out_of_core``'s values within
    tests/test_torch_transform.py's tolerances;
(b) the online learner graphed gives the eager bits (W and every block
    cost) over one and two passes, ``rho < 1``, bf16 and int8 X and
    ``track_cost=False``, and ``nmf_tpu.solve_online``'s values within
    tests/test_torch_online.py's tolerances;
(c) the counts per width: each slot's graph warms once, is captured at
    its second block and replays after; a width with no more than
    ``MIN_REPLAYS`` full blocks, a step at ``GRAPH_MAX_WORK``, a 1x1 mesh
    and ``eager_loop()`` capture nothing; the CLI's ``transform
    --out-of-core``, ``run --online`` and ``NMF.transform(out_of_core=True)``
    replay;
(d) lifetimes and buffers: no returned tensor aliases a graph's buffer,
    a block's cost read after the next block was enqueued is its own, the
    graphs are freed with the call, and int8 scales lie at one fixed
    address a slot.
"""

import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu.models import streaming as js  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch import cli  # noqa: E402
from nmf_tpu_torch.models import online as pon  # noqa: E402
from nmf_tpu_torch.models import solver as ps  # noqa: E402
from nmf_tpu_torch.models import streaming as pst  # noqa: E402
from nmf_tpu_torch.ops.divergence import kl_divergence  # noqa: E402
from nmf_tpu_torch.ops.kernels import fused_mu as tfm  # noqa: E402
from nmf_tpu_torch.ops.mu import _recon_ratio, matmul, update_h  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict  # noqa: E402

from test_torch_graph import _CpuGraphs, _NoHostRead, _Replayed  # noqa: E402
from test_torch_online import _assert_match as _online_match  # noqa: E402
from test_torch_transform import _assert_match as _transform_match  # noqa: E402

M, K, N, BLOCK = 64, 8, 600, 128        # four blocks of 128 and one of 88
EPS = float(np.float32(2.2204e-16))


class _Pinned(_Replayed):
    """``_Replayed``, with a captured part held to what a CUDA graph needs:
    no host read at its capture or replay, and X, read where the caller
    holds it, at the capture's addresses at every replay."""

    def __init__(self, fn):
        with _NoHostRead():
            super().__init__(fn)
        self.x_ptrs = ps._addresses(fn.__self__.x)

    def replay(self):
        assert ps._addresses(self.runner().x) == self.x_ptrs, "X moved under a graph"
        with _NoHostRead():
            super().replay()


class _StreamCpuGraphs(_CpuGraphs):
    def capture(self, stream, fn, pool=None, pred=None):
        graph = _Pinned(fn)
        return graph if pred is None else self.when(pred, graph)


@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(ps, "_GRAPHS", _StreamCpuGraphs())
    _Replayed.MADE = []
    ps.reset_graph_counts()


@pytest.fixture
def counted(monkeypatch):
    """K1 and K3 counted as the card counts them, one launch a wrapper
    call, in the counts a capture takes back and a replay adds."""
    for name, key in (("update_h_fused", "update_h"), ("kl_cost_fused", "kl_cost")):
        original = getattr(tfm, name)

        def call(*args, _key=key, _original=original, **kw):
            tfm.LAUNCHES[_key] += 1
            return _original(*args, **kw)
        monkeypatch.setattr(tfm, name, call)
    tfm.reset_counts()
    yield
    tfm.reset_counts()        # no count outlives the test


def _counts():
    return {k: ps.GRAPH_COUNTS[k] for k in ("warm_ups", "captures", "replays")}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(26)
    wt, ht = rng.rand(M, K).astype(np.float32), rng.rand(K, N).astype(np.float32)
    x = (wt @ ht + 0.02 * rng.rand(M, N)).astype(np.float32)
    w = rng.rand(M, K).astype(np.float32)
    mask = (rng.rand(M, N) >= 0.2).astype(np.float32)
    return x, w, mask


def _same_transform(a, b):
    assert a.blocks == b.blocks
    for f in ("h", "block_costs", "iterations", "converged"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert np.asarray(a.cost).tobytes() == np.asarray(b.cost).tobytes()


def _same_online(a, b):
    assert a.blocks == b.blocks and a.passes == b.passes
    assert a.w.tobytes() == b.w.tobytes()
    assert np.asarray(a.block_costs, np.float64).tobytes() == \
        np.asarray(b.block_costs, np.float64).tobytes()


# ---------------------------------------------------------------- (a)

TRANSFORMS = {
    "float32": (dict(), {}),
    "x_bfloat16": (dict(precision=jt.Precision(x_dtype="bfloat16")), {}),
    "x_int8": (dict(precision=jt.Precision(x_dtype="int8")), {}),
    "x_int8_rows": (dict(precision=jt.Precision(x_dtype="int8", x_quant_rows=16)), {}),
    "masked": (dict(), {"mask": True}),
    "masked_x_bfloat16": (dict(precision=jt.Precision(x_dtype="bfloat16")), {"mask": True}),
    "thresh": (dict(max_iter=200, check_every=5, thresh=1e-4), {}),
    "accelerated": (dict(accelerate=True), {}),
}


def _transform_case(problem, name):
    x, w, mask = problem
    fields, extra = TRANSFORMS[name]
    jcfg = jt.SolveConfig(**{"max_iter": 30, "check_every": 10, **fields})
    kw = {"block_n": BLOCK, "seed": 3}
    if extra.get("mask"):
        kw["mask"] = mask
    return x, w, jcfg, kw


def _transform(x, w, jcfg, kw):
    return pt.transform_out_of_core(x, w, config=config_from_dict(dataclasses.asdict(jcfg)),
                                    device="cpu", **kw)


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_a_graphed_transform_gives_the_eager_bits(problem, name, captured, counted):
    """Every full-width block's check blocks replay a slot's graph; H, the
    block costs, iterations and flags are the eager loop's bits, with the
    same K1 and K3 launches."""
    x, w, jcfg, kw = _transform_case(problem, name)
    got = _transform(x, w, jcfg, kw)
    launches = tfm.count_snapshot()
    graphs = _counts()
    tfm.reset_counts()
    with ps.eager_loop():
        eager = _transform(x, w, jcfg, kw)
    assert tfm.count_snapshot() == launches
    _same_transform(got, eager)
    if name == "thresh":
        # the blocks stop at their own checks; up to 40 checks a block
        # graph the ragged width too, in its slot
        assert graphs["captures"] == 3 and graphs["replays"] > 0
    else:
        # 4 full blocks x 3 checks in two slots: each slot's first check
        # block warm, the other five replayed; the ragged block eager (an
        # accelerated run also captures a redo at a replayed reject)
        assert (graphs["warm_ups"], graphs["replays"]) == (2, 10)
        assert graphs["captures"] == 2 or name == "accelerated"
    if name in ("float32", "x_bfloat16", "x_int8", "thresh"):
        # the kernels' route: K1 an iteration, K3 a check, of every block
        checks = int(np.sum((got.iterations + jcfg.check_every - 1) // jcfg.check_every))
        assert (tfm.LAUNCHES["update_h"], tfm.LAUNCHES["kl_cost"]) == \
            (int(got.iterations.sum()), checks)


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_a_graphed_transform_matches_jax(problem, name, captured):
    x, w, jcfg, kw = _transform_case(problem, name)
    got = _transform(x, w, jcfg, kw)
    assert _counts()["replays"] > 0
    assert got.blocks == [(j, min(j + BLOCK, N)) for j in range(0, N, BLOCK)]
    _transform_match(jt.transform_out_of_core(x, w, config=jcfg, **kw), got)


# ---------------------------------------------------------------- (b)

ONLINES = {
    "one_pass": (dict(), dict()),
    "two_passes": (dict(), dict(passes=2)),
    "rho": (dict(), dict(rho=0.7, passes=2)),
    "x_bfloat16": (dict(precision=jt.Precision(x_dtype="bfloat16")), dict(passes=2)),
    "x_int8": (dict(precision=jt.Precision(x_dtype="int8")), dict(passes=2)),
    "untracked": (dict(track_cost=False), dict(passes=2)),
}


def _online_case(name):
    fields, kw = ONLINES[name]
    return jt.SolveConfig(**fields), {"block_n": BLOCK, "inner_iters": 10, "seed": 5, **kw}


def _online(x, w, jcfg, kw):
    return pt.solve_online(x, w, config_from_dict(dataclasses.asdict(jcfg)), device="cpu", **kw)


@pytest.mark.parametrize("name", list(ONLINES))
def test_b_graphed_online_gives_the_eager_bits(problem, name, captured):
    """Each full-width block's whole update replays a slot's graph: W and
    every block cost are the eager bits, and no kernel is launched."""
    x, w, _ = problem
    jcfg, kw = _online_case(name)
    tfm.reset_counts()
    got = _online(x, w, jcfg, kw)
    graphs = _counts()
    with ps.eager_loop():
        eager = _online(x, w, jcfg, kw)
    _same_online(got, eager)
    assert not any(tfm.count_snapshot().values())
    passes = kw.get("passes", 1)
    # 4 full-width blocks a pass in two slots, each slot's first warm
    assert graphs == {"warm_ups": 2, "captures": 2, "replays": 4 * passes - 2}
    if jcfg.track_cost:
        assert [len(p) for p in got.block_costs] == [5] * passes
    else:
        assert got.block_costs == [[]] * passes


@pytest.mark.parametrize("name", list(ONLINES))
def test_b_graphed_online_matches_jax(problem, name, captured):
    x, w, _ = problem
    jcfg, kw = _online_case(name)
    got = _online(x, w, jcfg, kw)
    assert _counts()["replays"] > 0
    _online_match(got, jt.solve_online(x, w, jcfg, **kw),
                  bf16=jcfg.precision.matmul_dtype == "bfloat16")


# ---------------------------------------------------------------- (c)

def test_c_short_and_ragged_widths_stay_eager(problem, captured, monkeypatch):
    """A width graphs only where its full blocks over the call pass
    ``MIN_REPLAYS``: one check a block makes 4 at width 128 (graphed) and
    1 at the ragged 88 (eager); two blocks of 128 make 2 (eager).  The
    online learner counts blocks over its passes the same way."""
    x, w, _ = problem
    one_check = pt.SolveConfig(max_iter=10, check_every=10)
    pt.transform_out_of_core(x, w, config=one_check, block_n=BLOCK, device="cpu")
    assert _counts() == {"warm_ups": 2, "captures": 2, "replays": 2}
    ps.reset_graph_counts()
    short = x[:, :2 * BLOCK + 44]
    pt.transform_out_of_core(short, w, config=one_check, block_n=BLOCK, device="cpu")
    pt.solve_online(short, w, pt.SolveConfig(), block_n=BLOCK, inner_iters=2, device="cpu")
    assert _counts() == {"warm_ups": 0, "captures": 0, "replays": 0}
    # the same blocks over two passes: 4 full-width blocks, graphed
    pt.solve_online(short, w, pt.SolveConfig(), block_n=BLOCK, inner_iters=2, passes=2,
                    device="cpu")
    assert _counts()["replays"] == 2


def test_c_work_rule_and_eager_loop_capture_nothing(problem, captured, monkeypatch):
    """At ``GRAPH_MAX_WORK`` = M x 128 x K the full-width blocks run
    eagerly; one unit more and they replay; inside ``eager_loop()``
    nothing is captured."""
    x, w, _ = problem
    cfg = pt.SolveConfig(max_iter=30, check_every=10)
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", M * BLOCK * K)
    pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK, device="cpu")
    pt.solve_online(x, w, cfg, block_n=BLOCK, inner_iters=2, device="cpu")
    assert _counts() == {"warm_ups": 0, "captures": 0, "replays": 0}
    monkeypatch.setattr(ps, "GRAPH_MAX_WORK", M * BLOCK * K + 1)
    with ps.eager_loop():
        pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK, device="cpu")
        pt.solve_online(x, w, cfg, block_n=BLOCK, inner_iters=2, device="cpu")
    assert _counts() == {"warm_ups": 0, "captures": 0, "replays": 0}
    pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK, device="cpu")
    assert _counts() == {"warm_ups": 2, "captures": 2, "replays": 10}
    pt.solve_online(x, w, cfg, block_n=BLOCK, inner_iters=2, device="cpu")
    assert _counts() == {"warm_ups": 4, "captures": 4, "replays": 12}


@pytest.mark.parametrize("path", ["transform", "online"])
def test_c_mesh_captures_nothing(problem, captured, path):
    """On a mesh the blocks' sums cross ranks inside the update: every
    block runs eagerly; the 1x1 mesh gives the single-device values."""
    from nmf_tpu_torch.parallel.mesh import shutdown

    x, w, _ = problem
    cfg = pt.SolveConfig(max_iter=30, check_every=10)
    mesh = pt.make_mesh((1, 1), device="cpu")
    try:
        if path == "transform":
            got = pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK, mesh=mesh).h
        else:
            got = pt.solve_online(x, w, cfg, block_n=BLOCK, inner_iters=10, mesh=mesh).w
    finally:
        shutdown()
    assert _counts() == {"warm_ups": 0, "captures": 0, "replays": 0}
    if path == "transform":
        one = pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK, device="cpu").h
    else:
        one = pt.solve_online(x, w, cfg, block_n=BLOCK, inner_iters=10, device="cpu").w
    assert _counts()["replays"] > 0
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-6)


def test_c_cli_and_nmf_paths_replay(problem, captured, tmp_path):
    """``transform --out-of-core``, ``run --online`` and
    ``NMF.transform(out_of_core=True)`` take the graphed route with no new
    flag, and write the eager route's bytes."""
    x, w, _ = problem
    jbin.write_matrix(x, tmp_path / "X.bin")
    jbin.write_matrix(w, tmp_path / "W.bin")

    def run(tag):
        for args in (["transform", "X.bin", "W.bin", "-o", f"H_{tag}.bin", "--out-of-core",
                      "--block-n", str(BLOCK), "--max-iter", "30"],
                     ["run", "X.bin", "--rank", str(K), "--init", "random", "--online",
                      "--block-n", str(BLOCK), "--max-iter", "30", "-o", f"Wo_{tag}.bin",
                      f"Ho_{tag}.bin"]):
            assert cli.main([*(str(tmp_path / a) if a.endswith(".bin") else a for a in args),
                             "--device", "cpu", "-q"]) == 0

    run("g")
    # at 30 iterations a check every 25: one full check block a block, 4
    # at width 128 (the transform's, and the learner's transform's); the
    # learner's 4 blocks of 128: two slots' graphs of each
    assert _counts() == {"warm_ups": 6, "captures": 6, "replays": 6}
    with ps.eager_loop():
        run("e")
    for g, e in (("H_g", "H_e"), ("Wo_g", "Wo_e"), ("Ho_g", "Ho_e")):
        assert (tmp_path / f"{g}.bin").read_bytes() == (tmp_path / f"{e}.bin").read_bytes()
    est = pt.NMF(n_components=K, max_iter=30, device="cpu").fit(x)
    ps.reset_graph_counts()
    # one block of 600 columns, 8 full check blocks: warm, then replayed
    got = est.transform(str(tmp_path / "X.bin"), max_iter=200, out_of_core=True)
    assert _counts() == {"warm_ups": 1, "captures": 1, "replays": 7}
    with ps.eager_loop():
        assert got.tobytes() == est.transform(str(tmp_path / "X.bin"), max_iter=200,
                                              out_of_core=True).tobytes()


# ---------------------------------------------------------------- (d)

def _held():
    """Storage addresses of every live graph's buffers."""
    return {t.untyped_storage().data_ptr() for r in _Replayed.alive() for t in r.state()}


def test_d_nothing_returned_aliases_a_graph_buffer(problem, captured, monkeypatch):
    """Each block's solve result (the transform) and cost (online) is a
    tensor of its own while the graphs live, and the graphs are freed
    with the call."""
    x, w, _ = problem
    seen = []
    fetch = pst._Fetch.__init__

    def checked(self, res):
        held = _held()
        seen.append(len(held))
        for f in ("w", "h", "cost", "cost_history"):
            assert getattr(res, f).untyped_storage().data_ptr() not in held, f
        fetch(self, res)

    monkeypatch.setattr(pst._Fetch, "__init__", checked)
    cfg = pt.SolveConfig(max_iter=30, check_every=10)
    pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK, device="cpu")
    assert len(seen) == 5 and max(seen) > 0
    assert not _Replayed.alive()
    block = pon._OnlineGraph.block
    costs = []

    def returned(self, xb, h):
        cost = block(self, xb, h)
        assert cost.untyped_storage().data_ptr() not in _held()
        costs.append(cost)
        return cost

    monkeypatch.setattr(pon._OnlineGraph, "block", returned)
    gc.disable()
    try:
        pt.solve_online(x, w, cfg, block_n=BLOCK, inner_iters=4, device="cpu")
        assert len(costs) == 4 and not _Replayed.alive()
    finally:
        gc.enable()


def test_d_a_late_read_cost_is_its_own_blocks(problem, captured):
    """The learner reads block idx-1's cost after block idx is enqueued:
    a graph's cost buffer is written again by its next replay, so the
    cost a block returns is cloned out.  One graph runs two blocks here,
    the first cost read after the second ran, against the eager costs."""
    x, w, _ = problem
    cfg = pt.SolveConfig()
    xb = [torch.from_numpy(np.ascontiguousarray(x[:, j:j + BLOCK])) for j in (0, BLOCK)]
    buf = torch.empty(M, BLOCK)             # one slot: the blocks land at one address
    hs = [torch.from_numpy(pst.seeded_block_h(i, K, BLOCK, cfg.eps)) for i in range(3)]

    def learner():
        state = (torch.from_numpy(w.copy()), torch.zeros(M, K), torch.zeros(K))
        rho = torch.tensor(0.9)

        def fold(x_b, h):
            wt, a, c = state
            for _ in range(3):
                h = update_h(wt, h, x_b, cfg.eps, cfg.precision)
            cost = kl_divergence(x_b, wt, h, cfg.eps)
            z = _recon_ratio(wt, h, x_b, cfg.eps, cfg.precision)
            a_n = rho * a + matmul(z, h, cfg.precision, transpose_b=True)
            c_n = rho * c + torch.sum(h, dim=1, dtype=torch.float32)
            w_n = wt * (a_n / torch.clamp_min(c_n, cfg.eps)[None, :])
            for t, n in ((wt, w_n), (a, a_n), (c, c_n)):
                t.copy_(n)
            return cost
        return state, fold

    state, fold = learner()
    graph = pon._OnlineGraph(hs[0], state, fold, True)
    costs = []
    for i in range(3):                      # warm, captured and replayed, replayed
        buf.copy_(xb[i % 2])
        costs.append(graph.block(buf, hs[i]))
    assert _counts() == {"warm_ups": 1, "captures": 1, "replays": 2}
    state, fold = learner()
    eager = []
    for i in range(3):
        buf.copy_(xb[i % 2])
        eager.append(fold(buf, hs[i]))
    assert [float(c) for c in costs] == [float(c) for c in eager]
    assert len({float(c) for c in costs}) == 3


@pytest.mark.parametrize("qrows", [0, 16])
def test_d_int8_scales_lie_at_a_fixed_address_a_slot(problem, qrows):
    """Each block's scales are copied into its slot's scales buffer:
    two addresses over a sweep, alternating, and every block's scales the
    JAX host quantizer's bytes, its codes too, on every pass."""
    x, _, _ = problem
    blocks = [(j, min(j + BLOCK, N)) for j in range(0, N, BLOCK)]
    stream = pst._BlockStream(pst._as_source(x), blocks, torch.device("cpu"), "int8", EPS, qrows,
                              8 * 1024**3)
    for _ in range(2):
        ptrs = []
        for idx, (codes, scales) in stream.sweep():
            ptrs.append((codes.data_ptr(), scales.data_ptr()))
            j0, j1 = blocks[idx]
            qj, sj = js._host_prep(np.ascontiguousarray(x[:, j0:j1]), EPS, "int8", qrows)
            assert codes.numpy().tobytes() == qj.tobytes()
            assert scales.is_contiguous() and scales.numpy().tobytes() == sj.tobytes()
        assert len(set(ptrs)) == 2
        assert all(a != b for a, b in zip(ptrs, ptrs[1:]))


def test_d_graphed_int8_transform_reads_the_slot_scales(problem, captured):
    """The int8 transform's graphs read X as (codes, scales) at the
    capture's addresses at every replay (``_Pinned``), and its blocks'
    scales change from block to block under them."""
    x, w, _ = problem
    cfg = pt.SolveConfig(max_iter=30, check_every=10, precision=pt.Precision(x_dtype="int8"))
    got = pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK, device="cpu")
    assert _counts() == {"warm_ups": 2, "captures": 2, "replays": 10}
    with ps.eager_loop():
        _same_transform(got, pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK,
                                                      device="cpu"))


def test_d_a_calls_graphs_share_one_memory_pool(problem, monkeypatch):
    """Every graph of one streamed call captures into the pool the call's
    first capture made (its temporaries are dead when a capture ends), so
    the second slot's capture allocates nothing new; a new call starts its
    own pool."""
    x, w, _ = problem
    pools = []

    class _Pooled(_Pinned):
        def pool(self):
            return self

    class _Api(_StreamCpuGraphs):
        def capture(self, stream, fn, pool=None, pred=None):
            graph = _Pooled(fn)
            pools.append((pool, graph))
            return graph if pred is None else self.when(pred, graph)

    monkeypatch.setattr(ps, "_GRAPHS", _Api())
    _Replayed.MADE = []
    cfg = pt.SolveConfig(max_iter=30, check_every=10)
    for call, captures in ((lambda: pt.transform_out_of_core(x, w, config=cfg, block_n=BLOCK,
                                                             device="cpu"), 4),
                           (lambda: pt.solve_online(x, w, cfg, block_n=BLOCK, inner_iters=2,
                                                    device="cpu"), 2)):
        pools.clear()
        call()
        assert len(pools) == captures        # a step and a close a slot; a block update a slot
        first = pools[0][1]
        assert pools[0][0] is None and all(pool is first for pool, _ in pools[1:])
