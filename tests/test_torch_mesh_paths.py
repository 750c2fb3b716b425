"""The port's streamed, transform, online, batched, selection, tiled and
checkpointed solves on a mesh, on the CPU, against nmf_tpu on one device.

Each mesh shape runs once as a group of gloo processes
(``tests/torch_mesh_paths_ranks.py``, rendezvous through a file in the
session's temporary directory, every rank under a wall-clock limit and all
killed on the first failure); the cases then hold each gathered result to
the JAX package's single-device result on the same inputs, at the block
width the mesh forces: cost (and cost history) relative 1e-5, W and H
relative Frobenius 1e-4, and bit for bit where the port promises bits
(a resumed mesh run against the uninterrupted one).  JAX's mesh runs only
where it raises before compiling anything (its refusals' words); where JAX
compiles before it raises, the message is held to its source's text.  The
CLI's mesh combinations run under ``torch.distributed.run`` with gloo
ranks; a four-rank group runs the CLI several times, every rank exiting 0
through the interpreter's own teardown.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu.parallel import mesh as jmesh  # noqa: E402
from nmf_tpu.utils import checkpoint as jckpt  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_mesh as tm  # noqa: E402
import torch_mesh_paths_ranks as ranks  # noqa: E402

HELPER = pathlib.Path(ranks.__file__)
CRTOL, FRO = 1e-5, 1e-4


def _group(tmp_path_factory, shape):
    """The output directory of the rank group of ``shape``, run once per
    session whichever worker asks first (``test_torch_mesh``'s runner)."""
    import fcntl
    import shutil

    root = tm._shared_root(tmp_path_factory).parent / "torch_mesh_paths"
    root.mkdir(parents=True, exist_ok=True)
    out = root / f"{shape[0]}x{shape[1]}"
    with open(root / f"{shape[0]}x{shape[1]}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (out / "done").exists():
            return out
        if (out / "failed").exists():
            pytest.fail((out / "failed").read_text())
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir()
        world = shape[0] * shape[1]
        cmds = [[sys.executable, str(HELPER), str(i), str(world), str(out / "store"),
                 str(shape[0]), str(shape[1]), str(out)] for i in range(world)]
        try:
            tm._run_ranks(cmds, [out / f"rank{i}.log" for i in range(world)])
        except BaseException as e:
            (out / "failed").write_text(str(e))
            raise
        (out / "done").write_text("ok")
    return out


def _ours(out, case, world):
    infos = [json.loads((out / f"{case}.r{i}.json").read_text()) for i in range(world)]
    arrays = dict(np.load(out / f"{case}.npz")) if (out / f"{case}.npz").exists() else None
    return arrays, infos


def _jconfig(case):
    kw = ranks.config_kwargs(case)
    kw["precision"] = jt.Precision(**kw.get("precision", {}))
    if kw.get("backend") == "pallas" and not case.startswith("tiled"):
        # K1-K3's plain reference: Pallas runs on the CPU in interpret
        # mode only, and the port's wrappers take their plain version on
        # CPU tensors
        kw["backend"] = "jnp"
    return jt.SolveConfig(**kw)


def _jmesh(shape):
    return jmesh.make_mesh(shape=shape, devices=jax.devices()[: shape[0] * shape[1]])


def _solve_arrays(res):
    return {"w": np.asarray(res.w, np.float32), "h": np.asarray(res.h, np.float32),
            "cost_history": np.asarray(res.cost_history), "iterations": int(res.iterations),
            "num_checks": int(res.num_checks), "converged": bool(res.converged)}


def _refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return {"error": type(e).__name__, "message": str(e)}
    raise AssertionError("nmf_tpu did not refuse")


# where JAX compiles a program before it raises, its source's words
_JAX_WORDS = {
    # nmf_tpu/parallel/batched.py:212-219 (after its prep program)
    "batched_indivisible": lambda shape: {
        "error": "ValueError",
        "message": f"batch 6 must divide the mesh's {shape[0] * shape[1]} devices "
                   "(the batch axis shards over ALL mesh axes)"},
    # nmf_tpu/models/selection.py:252-260 (after its prep program)
    "restarts_indivisible": lambda shape: {
        "error": "ValueError",
        "message": f"members 3 must be a multiple of mesh axis mr={shape[0]}"},
}


@functools.lru_cache(maxsize=None)
def _jax_single(case):
    """nmf_tpu's single-device result of ``case`` (no mesh: the reference)."""
    x, w, h, mask = ranks.problem()
    cfg = _jconfig(case)
    entry, a = ranks.CASES[case]["entry"], ranks.args_of(case)
    bn = ranks.BLOCK_N
    if entry in ("ooc", "ooc_masked", "ooc_resume"):
        res = jt.solve_out_of_core(x, w, h, cfg, block_n=bn,
                                   mask=mask if entry == "ooc_masked" else None, **a)
        return _solve_arrays(res)
    if entry in ("tr_ooc", "tr_ooc_masked"):
        tr = jt.transform_out_of_core(x, w, config=cfg, block_n=bn, seed=3,
                                      mask=mask if entry == "tr_ooc_masked" else None)
        return {"h": np.asarray(tr.h), "block_costs": np.asarray(tr.block_costs),
                "iterations": np.asarray(tr.iterations), "cost": float(tr.cost)}
    if entry == "nmf_tr_ooc":
        est = jt.NMF(n_components=ranks.K, init="random", max_iter=20).fit(x)
        return {"h": np.asarray(est.transform(x, out_of_core=True)), "w": np.asarray(est.w_)}
    if entry == "online":
        res = jt.solve_online(x, w, cfg, block_n=a.get("block_n", bn), inner_iters=5, passes=2,
                              seed=4)
        return {"w": np.asarray(res.w), "curve": np.asarray(res.learning_curve)}
    if entry == "batched":
        res = jt.solve_batched(*ranks.batch_problem(), cfg)
        return {"w": np.asarray(res.w), "h": np.asarray(res.h), "cost": np.asarray(res.cost),
                "cost_history": np.asarray(res.cost_history),
                "iterations": np.asarray(res.iterations), "converged": np.asarray(res.converged)}
    if entry == "restarts":
        sel = jt.solve_restarts(x, rank=ranks.K, n_restarts=4, config=cfg, seed=2)
        return {"costs": np.asarray(sel.costs), "iterations": np.asarray(sel.iterations),
                "w": np.asarray(sel.best[0]), "h": np.asarray(sel.best[1]),
                "best": int(sel.best_index)}
    if entry == "rank_sweep":
        sel = jt.solve_rank_sweep(x, [2, 3, 4, 5], cfg, seed=2)
        return {"costs": np.asarray(sel.costs), "w": np.asarray(sel.results.w),
                "h": np.asarray(sel.results.h)}
    if entry == "stability":
        st = jt.rank_stability(x, [2, 3], n_restarts=2, config=cfg, seed=1)
        return {"cophenetic": np.asarray(st.cophenetic), "dispersion": np.asarray(st.dispersion),
                "costs": np.asarray(st.sweep.costs), "best_rank": int(st.best_rank())}
    if entry == "nmf_restarts":
        est = jt.NMF(n_components=ranks.K, n_restarts=4, init="random", max_iter=20)
        return {"w": np.asarray(est.fit_transform(x)), "h": np.asarray(est.components_),
                "err": float(est.reconstruction_err_)}
    if entry in ("tiled", "ckpt_tiled"):
        tx = jt.tiles_from_dense(ranks.tiled_problem(), ranks.TILE)
        return _solve_arrays(jt.solve_sparse_tiled(tx, w, h, cfg, tile=ranks.TILE))
    if entry == "ckpt":
        return _solve_arrays(jt.solve(x, w, h, cfg))
    raise AssertionError(f"no single-device reference for {case}")


def _jax_mesh_refusal(case, shape):
    """nmf_tpu's refusal of ``case`` on a mesh of ``shape``, where it raises
    before it compiles (a mesh over the virtual CPU devices)."""
    x, w, h, _ = ranks.problem()
    cfg = _jconfig(case)
    mesh = _jmesh(shape)
    m = ranks.M
    if case == "ooc_indivisible":
        return _refusal(lambda: jt.solve_out_of_core(x[:m - 1], w[:m - 1], h, cfg,
                                                     block_n=ranks.BLOCK_N, mesh=mesh))
    if case == "online_block" and 42 % shape[1]:
        return _refusal(lambda: jt.solve_online(x, w, cfg, block_n=42, inner_iters=5, passes=2,
                                                seed=4, mesh=mesh))
    if case == "tiled_pallas":
        tx = jt.tiles_from_dense(ranks.tiled_problem(), ranks.TILE)
        return _refusal(lambda: jt.solve_sparse_tiled(tx, w, h, cfg, tile=ranks.TILE,
                                                      mesh=mesh))
    return None


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, where):
    assert np.shape(got) == np.shape(want), (where, np.shape(got), np.shape(want))
    assert _rel_fro(got, want) <= FRO, (where, _rel_fro(got, want))


_PARAMS = [pytest.param(shape, case, id=f"{shape[0]}x{shape[1]}-{case}")
           for shape, cases in ranks.GROUPS.items() for case in cases]


@pytest.mark.parametrize("shape,case", _PARAMS)
def test_mesh_path_matches_nmf_tpu(tmp_path_factory, shape, case):
    """The gathered mesh result against nmf_tpu's single-device one; the
    replicated scalars the same on every rank; refusals in JAX's words."""
    out = _group(tmp_path_factory, shape)
    world = shape[0] * shape[1]
    arrays, infos = _ours(out, case, world)
    entry = ranks.CASES[case]["entry"]
    want_err = _jax_mesh_refusal(case, shape)
    if case in _JAX_WORDS:
        want_err = _JAX_WORDS[case](shape)
    if want_err is not None:
        assert all(i.get("error") == want_err["error"] for i in infos), (infos, want_err)
        assert all(i["message"] == want_err["message"] for i in infos), (infos, want_err)
        return
    if case == "ckpt_other_mesh":
        assert all(i.get("error") == "ValueError" for i in infos), infos
        assert all("was written on a 2x2 mesh and this run's mesh is 1x4" in i["message"]
                   for i in infos), infos
        return
    assert all("error" not in i for i in infos), infos
    ref = _jax_single(case)
    if entry in ("ooc", "ooc_masked", "ooc_resume", "tiled", "ckpt", "ckpt_tiled"):
        for key in ("w", "h"):
            _close(arrays[key], ref[key], key)
        np.testing.assert_allclose(arrays["cost_history"][: ref["num_checks"]],
                                   ref["cost_history"][: ref["num_checks"]], rtol=CRTOL)
        if entry in ("ckpt", "ckpt_tiled"):
            assert all(i["bitwise"] for i in infos), "a resumed mesh run differs in bits"
            assert {i["iteration"] for i in infos} == {ref["iterations"]}
        else:
            for key in ("iterations", "num_checks", "converged"):
                assert {i[key] for i in infos} == {ref[key]}, (key, infos, ref[key])
            assert len({i["cost"] for i in infos}) == 1
        if entry == "ooc_resume":
            assert all(i["bitwise"] for i in infos), "the resumed streamed run differs in bits"
        lines = [i["live"] for i in infos]
        if case == "ooc_live":
            # the origin emits each check once; no other rank emits
            assert [len(v) for v in lines] == [ref["num_checks"]] + [0] * (world - 1)
            np.testing.assert_allclose([c for _, c, _ in lines[0]], ref["cost_history"],
                                       rtol=CRTOL)
        else:
            assert not any(lines)
    elif entry in ("tr_ooc", "tr_ooc_masked"):
        _close(arrays["h"], ref["h"], "h")
        np.testing.assert_allclose(arrays["block_costs"], ref["block_costs"], rtol=CRTOL)
        np.testing.assert_array_equal(arrays["iterations"], ref["iterations"])
        assert all(i["cost"] == pytest.approx(ref["cost"], rel=CRTOL) for i in infos)
    elif entry in ("nmf_tr_ooc", "nmf_restarts"):
        for key in ("w", "h"):
            _close(arrays[key], ref[key], key)
        if entry == "nmf_restarts":
            assert all(i["err"] == pytest.approx(ref["err"], rel=CRTOL) for i in infos)
    elif entry == "online":
        _close(arrays["w"], ref["w"], "w")
        np.testing.assert_allclose(arrays["curve"], ref["curve"], rtol=CRTOL)
    elif entry == "batched":
        for key in ("w", "h"):
            for i in range(ranks.BATCH):
                _close(arrays[key][i], ref[key][i], f"{key}[{i}]")
        np.testing.assert_allclose(arrays["cost"], ref["cost"], rtol=CRTOL)
        np.testing.assert_allclose(arrays["cost_history"], ref["cost_history"], rtol=CRTOL)
        np.testing.assert_array_equal(arrays["iterations"], ref["iterations"])
        np.testing.assert_array_equal(arrays["converged"], ref["converged"])
        assert {i["local_members"] for i in infos} == {ranks.BATCH // world}
    elif entry == "restarts":
        np.testing.assert_allclose(arrays["costs"], ref["costs"], rtol=CRTOL)
        np.testing.assert_array_equal(arrays["iterations"], ref["iterations"])
        assert {i["best"] for i in infos} == {ref["best"]}
        for key in ("w", "h"):
            _close(arrays[key], ref[key], key)
    elif entry == "rank_sweep":
        np.testing.assert_allclose(arrays["costs"], ref["costs"], rtol=CRTOL)
        for key in ("w", "h"):
            for i in range(4):
                _close(arrays[key][i], ref[key][i], f"{key}[{i}]")
    elif entry == "stability":
        np.testing.assert_allclose(arrays["costs"], ref["costs"], rtol=CRTOL)
        np.testing.assert_allclose(arrays["cophenetic"], ref["cophenetic"], rtol=1e-6)
        np.testing.assert_allclose(arrays["dispersion"], ref["dispersion"], rtol=1e-6)
        assert {i["best_rank"] for i in infos} == {ref["best_rank"]}
    else:
        raise AssertionError(f"no comparison for {case}")


@pytest.mark.parametrize("shape", list(ranks.GROUPS), ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_leave_no_gloo_thread_behind(tmp_path_factory, shape):
    """After ``shutdown`` and its mesh dropped, no rank of a group runs a
    gloo thread (``test_torch_mesh``'s check, over every path of step 12b:
    the groups of this file's 2x1 and 1x2 grids aborted at exit now and then
    while their groups lived on into the interpreter's teardown)."""
    out = _group(tmp_path_factory, shape)
    for i in range(shape[0] * shape[1]):
        assert json.loads((out / f"exit.r{i}.json").read_text()) == {"gloo_threads": []}, i


def test_selection_shards_over_the_first_axis_and_batched_over_all():
    """On a 2-D mesh the two splits differ, as in JAX: the batched solve's
    members over all R*C ranks, the selection's over 'mr' (replicated over
    'mc'); a FlatMesh reads every rank as one member axis."""
    from nmf_tpu_torch.parallel.batched import member_split
    from nmf_tpu_torch.parallel.mesh import BOTH, ROW_AXIS

    class Fake:
        shape = (2, 2)
        mesh_dim_names = ("mr", "mc")

        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

    spans = {c: (member_split(Fake(c), BOTH, 8), member_split(Fake(c), ROW_AXIS, 8))
             for c in ((0, 0), (0, 1), (1, 0), (1, 1))}
    assert [spans[c][0] for c in sorted(spans)] == [slice(0, 2), slice(2, 4), slice(4, 6),
                                                     slice(6, 8)]
    assert [spans[c][1] for c in sorted(spans)] == [slice(0, 4), slice(0, 4), slice(4, 8),
                                                     slice(4, 8)]


def _torchrun(args, cwd, nproc):
    return tm._torchrun(args, cwd, nproc)


def _files(tmp_path):
    x, w, h, _ = ranks.problem()
    for name, a in (("X", x), ("W", w), ("H", h)):
        jbin.write_matrix(a, tmp_path / f"{name}.bin")
    return x, w, h


_CLI_BASE = ["--device", "cpu", "--max-iter", "20", "--check-every", "5", "-q"]


@pytest.mark.parametrize("mode", ["out_of_core", "checkpoint", "online", "restarts"])
def test_cli_run_mesh_modes_match_nmf_tpu(tmp_path, mode):
    """``run --mesh 2x2`` with ``--out-of-core``, ``--checkpoint-dir``,
    ``--online`` and ``--restarts`` on four gloo ranks, against nmf_tpu's
    single-device library result on the same files; rank 0 writes."""
    x, w, h = _files(tmp_path)
    cfg = jt.SolveConfig(max_iter=20, check_every=5)
    base = ["run", "X.bin", "W.bin", "H.bin", "-o", "Wo.bin", "Ho.bin", "--mesh", "2x2",
            *_CLI_BASE]
    if mode == "out_of_core":
        _torchrun(base + ["--out-of-core", "--block-n", str(ranks.BLOCK_N)], tmp_path, 4)
        ref = jt.solve_out_of_core(x, w, h, cfg, block_n=ranks.BLOCK_N)
        want = (ref.w, ref.h)
    elif mode == "checkpoint":
        _torchrun(base + ["--checkpoint-dir", "ck", "--checkpoint-every", "10"], tmp_path, 4)
        ref = jt.solve(x, w, h, cfg)
        want = (ref.w, ref.h)
        assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000010", "step_00000020"]
        state = jckpt.load_checkpoint(str(tmp_path / "ck" / "step_00000020"))
        _close(state.w, np.asarray(ref.w), "checkpointed W")
    elif mode == "online":
        _torchrun(["run", "X.bin", "W.bin", "-o", "Wo.bin", "Ho.bin", "--mesh", "2x2",
                   "--online", "--block-n", str(ranks.BLOCK_N), *_CLI_BASE], tmp_path, 4)
        res = jt.solve_online(x, w, cfg, block_n=ranks.BLOCK_N, seed=0)
        tr = jt.transform_out_of_core(x, np.asarray(res.w), config=cfg,
                                      block_n=ranks.BLOCK_N, seed=0)
        want = (res.w, tr.h)
    else:
        _torchrun(["run", "X.bin", "--rank", str(ranks.K), "--restarts", "4", "-o", "Wo.bin",
                   "Ho.bin", "--mesh", "2x2", *_CLI_BASE], tmp_path, 4)
        sel = jt.solve_restarts(x, rank=ranks.K, n_restarts=4, config=cfg, seed=0)
        want = sel.best
    for path, ref_a in zip(("Wo.bin", "Ho.bin"), want):
        _close(jbin.read_matrix(tmp_path / path), np.asarray(ref_a), path)


def test_cli_transform_out_of_core_mesh_matches_nmf_tpu(tmp_path):
    x, w, _ = _files(tmp_path)
    tm._torchrun(["transform", "X.bin", "W.bin", "-o", "Ht.bin", "--mesh", "1x2",
                  "--out-of-core", "--block-n", str(ranks.BLOCK_N), *_CLI_BASE], tmp_path, 2)
    cfg = jt.SolveConfig(max_iter=20, check_every=5)
    ref = jt.transform_out_of_core(x, w, config=cfg, block_n=ranks.BLOCK_N, seed=0)
    _close(jbin.read_matrix(tmp_path / "Ht.bin"), np.asarray(ref.h), "Ht.bin")


def test_cli_select_and_batch_on_a_mesh(tmp_path):
    """``select --mesh 2x1`` (members over both ranks) and ``batch --mesh
    2x1`` against nmf_tpu's single-device library runs."""
    x, _, _ = _files(tmp_path)
    tm._torchrun(["select", "X.bin", "--ranks", "3", "--restarts", "2", "-o", "Ws.bin",
                  "Hs.bin", "--mesh", "2x1", "--jsonl", "sel.jsonl", *_CLI_BASE], tmp_path, 2)
    cfg = jt.SolveConfig(max_iter=20, check_every=5)
    sel = jt.solve_rank_sweep(x, [3, 3], cfg, seed=0, init="scaled")
    best = int(np.argmin(np.asarray(sel.costs)))
    _close(jbin.read_matrix(tmp_path / "Ws.bin"), np.asarray(sel.factors(best)[0]), "Ws.bin")
    rec = json.loads((tmp_path / "sel.jsonl").read_text().splitlines()[-1])
    assert rec["best_cost_per_rank"]["3"] == pytest.approx(float(np.min(sel.costs)), rel=CRTOL)
    xs, _, _ = ranks.batch_problem(4)
    (tmp_path / "d").mkdir()
    for i in range(4):
        jbin.write_matrix(xs[i], tmp_path / "d" / f"m{i}.bin")
    tm._torchrun(["batch", "d", "--rank", "4", "--out-dir", "bout", "--mesh", "2x1",
                  *_CLI_BASE], tmp_path, 2)
    rng = np.random.RandomState(0)
    ws = rng.rand(4, xs.shape[1], 4).astype(np.float32)
    hs = rng.rand(4, 4, xs.shape[2]).astype(np.float32)
    ref = jt.solve_batched(xs, ws, hs, cfg)
    for i in range(4):
        _close(jbin.read_matrix(tmp_path / "bout" / f"m{i}.W.bin"), np.asarray(ref.w[i]),
               f"m{i}.W.bin")


def test_cli_mesh_refusals_are_jaxs_words(tmp_path):
    """--restarts and batch on a mesh that does not divide them exit 2 with
    the JAX CLI's words (``nmf_tpu/cli.py:476-503, 1048-1063``)."""
    _files(tmp_path)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node=2", "-m", "nmf_tpu_torch", "run", "X.bin", "--rank", "3",
           "--restarts", "3", "-o", "a.bin", "b.bin", "--mesh", "2x1", *_CLI_BASE]
    proc = subprocess.run(cmd, cwd=tmp_path, env=tm._env(), capture_output=True, text=True,
                          timeout=tm.RANK_SECONDS)
    assert proc.returncode != 0
    assert "--restarts 3 must be a multiple of the mesh device count 2" in proc.stderr


def test_cli_four_ranks_exit_cleanly_again_and_again(tmp_path):
    """A 4x1 gloo group through the CLI under torch.distributed.run, five
    times: every rank exits 0 through the interpreter's own teardown (no
    ``os._exit`` anywhere on the path), the group left by
    ``parallel.mesh.shutdown``."""
    x, w, h = _files(tmp_path)
    for i in range(5):
        tm._torchrun(["run", "X.bin", "W.bin", "H.bin", "-o", f"W{i}.bin", f"H{i}.bin",
                      "--mesh", "4x1", "--out-of-core", "--block-n", str(ranks.BLOCK_N),
                      *_CLI_BASE], tmp_path, 4)
    first = jbin.read_matrix(tmp_path / "W0.bin")
    for i in range(1, 5):
        assert jbin.read_matrix(tmp_path / f"W{i}.bin").tobytes() == first.tobytes()
    for path in (HELPER, tm.HELPER, pathlib.Path(tm.REPO / "nmf_tpu_torch" / "cli.py")):
        assert "os._exit" not in path.read_text(), path


def test_chip_smoke_mesh_paths_read_their_launches():
    """``chip_smoke.py`` phase 18's (f)-(h): the counts each new mesh run
    must show (K1/K2 ``numerator_only`` on the streamed runs, K1-K3 on the
    batched and restart runs, K5 on the tiled grid under ``auto``, nothing
    on the online and plain-sweep runs), the kernels line's reader of
    them, the limits, and the six CLI runs, read without a card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_for_mesh_paths_test",
                                                  tm.REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PHASES[-3:] == ("mesh", "serving", "examples")
    want = smoke._mp_stream_want()
    assert {k: v for k, v in want.items() if v} == {
        "update_h_numerator": smoke.MP_OOC_ITERS, "update_w_numerator": smoke.MP_OOC_ITERS}
    assert smoke.MP_OOC_ITERS == 50 and smoke.MP_OOC == (1025, 65_408, 32)
    assert {k: v for k, v in smoke._mp_tiled_want(True).items() if v} == {
        "K5 h_numerator": smoke.MP_TILED_ITERS, "K5 w_numerator": smoke.MP_TILED_ITERS}
    assert not any(smoke._mp_tiled_want(False).values()) and not any(smoke._mp_want().values())
    assert {k: v for k, v in smoke._mp_batched_want().items() if v} == {
        "update_h": smoke.BATCH_ITERS, "update_w": smoke.BATCH_ITERS}
    assert {k: v for k, v in smoke._mp_restarts_want().items() if v} == {
        "update_h": smoke.SEL_ITERS, "update_w": smoke.SEL_ITERS, "kl_cost": smoke.SEL_ITERS // 25}
    assert (smoke.MP_COST_RTOL, smoke.MP_FRO, smoke.MP_TILED_RTOL) == (1e-5, 1e-4, 1e-4)
    launches = {"mesh paths 1x4 streamed": smoke._mp_stream_want(),
                "mesh paths 2x2 tiled": smoke._mp_tiled_want(True),
                "mesh paths 2x2 batched": smoke._mp_batched_want(),
                "mesh paths 2x2 restarts": smoke._mp_restarts_want()}
    got = {name: smoke._mesh_paths_launches(launches, name)
           for name in ("update_h", "update_w", "kl_cost", "h_numerator", "w_numerator")}
    assert got["update_h"]["mesh paths 1x4 streamed"] == smoke.MP_OOC_ITERS
    assert got["update_h"]["mesh paths 2x2 batched"] == smoke.BATCH_ITERS
    assert got["kl_cost"]["mesh paths 2x2 restarts"] == smoke.SEL_ITERS // 25
    assert got["kl_cost"]["mesh paths 1x4 streamed"] == 0
    assert got["h_numerator"]["mesh paths 2x2 tiled"] == smoke.MP_TILED_ITERS
    assert got["h_numerator"]["mesh paths 1x1 streamed"] == 0      # not run here
    cmds = smoke._mp_cli_commands()
    assert set(cmds) == {"run_ooc", "run_ckpt", "run_online", "run_restarts", "select", "batch"}
    assert all(args[args.index("--mesh") + 1] == "1x1" for args in cmds.values())
    flags = {f for args in cmds.values() for f in args}
    assert {"--out-of-core", "--checkpoint-dir", "--online", "--restarts"} <= flags
    assert {cmds["select"][0], cmds["batch"][0]} == {"select", "batch"}
