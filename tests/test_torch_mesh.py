"""The port's device mesh and sharded solves on the CPU, against nmf_tpu.

Each mesh shape runs once as a group of gloo processes
(``tests/torch_mesh_ranks.py``, rendezvous through a file in the test's
temporary directory, every rank under a wall-clock limit and all killed on
the first failure); the cases then hold each gathered result to the JAX
package's on a mesh of the same shape over its 8 virtual CPU devices
(``tests/conftest.py``), with ``tests/test_sharded.py``'s tolerances:
factors rtol 5e-5 / atol 1e-7, ``cost_history`` rtol 1e-5, HALS factors
scale-relative (``_assert_close_scaled``).  Under xdist the workers share
one run of each group (a lock file beside the workers' directories).
"""

import fcntl
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu.models.masked import solve_masked as j_masked  # noqa: E402
from nmf_tpu.models.masked import solve_masked_h_only as j_masked_h  # noqa: E402
from nmf_tpu.models.nmf import NMF as JNMF  # noqa: E402
from nmf_tpu.models.nmf import solve_h_only as j_h_only  # noqa: E402
from nmf_tpu.models.nmf import solve_w_only as j_w_only  # noqa: E402
from nmf_tpu.models.semi import solve_semi as j_semi  # noqa: E402
from nmf_tpu.ops.quant import quantize_policy as j_quantize  # noqa: E402
from nmf_tpu.parallel import mesh as jmesh  # noqa: E402
from nmf_tpu.parallel import sharded as jsharded  # noqa: E402

import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.parallel import mesh as pmesh  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
HELPER = pathlib.Path(ranks.__file__)
RANK_SECONDS = 240     # each rank group's wall-clock limit
FRTOL, FATOL, CRTOL = 5e-5, 1e-7, 1e-5


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "RANK", "WORLD_SIZE", "MASTER_", "LOCAL_RANK"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(cmds, logs, timeout=RANK_SECONDS):
    """Start every command at once; wait for all under ``timeout`` seconds,
    killing all of them on the first failure or at the limit."""
    procs = [subprocess.Popen(cmd, stdout=open(log, "w"), stderr=subprocess.STDOUT, env=_env())
             for cmd, log in zip(cmds, logs)]
    deadline = time.monotonic() + timeout
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        failed = next((i for i, p in enumerate(procs) if p.poll() not in (None, 0)), None)
        if time.monotonic() > deadline:
            failed = "timeout"
        time.sleep(0.05)
    if failed is None:
        failed = next((i for i, p in enumerate(procs) if p.returncode != 0), None)
    if failed is not None:
        for p in procs:
            p.kill()
            p.wait()
        which = 0 if failed == "timeout" else failed
        tail = pathlib.Path(logs[which]).read_text()[-3000:]
        pytest.fail(f"rank group failed ({failed}): {' '.join(map(str, cmds[which]))}\n{tail}")


def _shared_root(tmp_path_factory) -> pathlib.Path:
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent      # shared by the workers of one session
    return root / "torch_mesh"


def _group(tmp_path_factory, shape) -> pathlib.Path:
    """The output directory of the rank group of ``shape``, run once per
    session whichever worker asks first."""
    root = _shared_root(tmp_path_factory)
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
            _run_ranks(cmds, [out / f"rank{i}.log" for i in range(world)])
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
    if kw.get("backend") == "pallas" and kw["precision"].x_dtype != "int8":
        # K1/K2 numerator_only's plain reference: Pallas runs on the CPU in
        # interpret mode only, and the port's wrappers take their plain
        # version on CPU tensors
        kw["backend"] = "jnp"
    return jt.SolveConfig(**kw)


def _jmesh(shape):
    return jmesh.make_mesh(shape=shape, devices=jax.devices()[: shape[0] * shape[1]])


def _jax(case, shape):
    """nmf_tpu's result of ``case`` on a mesh of ``shape``: arrays, or the
    exception's type name and message for the refusals."""
    x, w, h, mask = ranks.problem()
    cfg = _jconfig(case)
    entry = ranks.CASES[case]["entry"]
    mesh = _jmesh(shape)
    try:
        if entry == "indivisible":
            jmesh.factor_shapes(ranks.M + 1, ranks.K, ranks.N, mesh)
        if entry in ("solve_pair", "solve_pair_rows"):
            xc = np.maximum(x, np.float32(cfg.eps))
            x = j_quantize(xc, cfg.eps, 48 if entry == "solve_pair_rows" else 0)
        if entry in ("solve", "solve_pair", "solve_pair_rows"):
            res = jsharded.solve_sharded(x, w, h, cfg, mesh=mesh)
        elif entry == "masked":
            res = j_masked(x, w, h, mask, cfg, mesh=mesh)
        elif entry == "h_only":
            res = j_h_only(x, w, h, cfg, mesh=mesh)
        elif entry == "masked_h_only":
            res = j_masked_h(x, w, h, mask, cfg, mesh=mesh)
        elif entry == "w_only":
            res = j_w_only(x, w, h, cfg, mesh=mesh)
        elif entry == "semi":
            res = j_semi(x, w, h, cfg, n_frozen=ranks.CASES[case]["n_frozen"], mesh=mesh)
        elif entry == "nmf":
            est = JNMF(n_components=8, init="random", max_iter=20, mesh=mesh)
            w_fit = est.fit_transform(x)
            return {"w": w_fit, "h": est.transform(x, max_iter=10),
                    "components": est.components_, "err": est.reconstruction_err_}
    except (ValueError, NotImplementedError) as e:
        return {"error": type(e).__name__, "message": str(e)}
    return {"w": np.asarray(res.w, np.float32), "h": np.asarray(res.h, np.float32),
            "cost_history": np.asarray(res.cost_history), "iterations": int(res.iterations),
            "num_checks": int(res.num_checks), "converged": bool(res.converged)}


def _assert_close_scaled(a, b, rel: float = 1e-5):
    """``tests/test_sharded.py``'s: HALS's max(., 0) leaves near-boundary
    entries relatively sensitive to the summation order."""
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=rel * max(float(np.abs(b).max()), 1e-6))


_PARAMS = [pytest.param(shape, case, id=f"{shape[0]}x{shape[1]}-{case}")
           for shape, cases in ranks.GROUPS.items() for case in cases]


@pytest.mark.parametrize("shape,case", _PARAMS)
def test_mesh_case_matches_nmf_tpu(tmp_path_factory, shape, case):
    """The gathered result of a gloo grid against nmf_tpu's on a mesh of
    the same shape; the scalars the same on every rank."""
    out = _group(tmp_path_factory, shape)
    world = shape[0] * shape[1]
    arrays, infos = _ours(out, case, world)
    ref = _jax(case, shape)
    if "error" in ref:
        # the same refusal, on every rank
        assert all(i.get("error") == ref["error"] for i in infos), (infos, ref)
        if case in ("pair_not_int8", "pair_ndim", "indivisible"):
            assert all(i["message"] == ref["message"] for i in infos), (infos, ref)
        return
    assert arrays is not None, infos
    hals = ranks.CASES[case].get("algorithm") == "hals"
    close = _assert_close_scaled if hals else (
        lambda a, b: np.testing.assert_allclose(a, b, rtol=FRTOL, atol=FATOL))
    for key in ("w", "h") + (("components",) if case == "nmf" else ()):
        assert arrays[key].shape == ref[key].shape
        close(arrays[key], ref[key])
    if case == "nmf":
        assert float(arrays["err"]) == pytest.approx(float(ref["err"]), rel=CRTOL)
        return
    np.testing.assert_allclose(arrays["cost_history"], ref["cost_history"], rtol=CRTOL)
    for key in ("iterations", "num_checks", "converged"):
        assert {i[key] for i in infos} == {ref[key]}, (key, infos, ref[key])
    # the replicated scalars: one cost on every rank
    assert len({i["cost"] for i in infos}) == 1
    lines = [i["live"] for i in infos]
    if case == "live":
        # the origin emits each check once; no other rank emits
        assert [len(v) for v in lines] == [ref["num_checks"]] + [0] * (world - 1)
        np.testing.assert_allclose([c for _, c, _ in lines[0]], arrays["cost_history"],
                                   rtol=1e-6)
        assert [it for it, _, _ in lines[0]] == [5, 10, 15, 20]
    else:
        assert not any(lines)


def test_thresh_stops_every_rank_at_nmf_tpus_iteration(tmp_path_factory):
    """A ``thresh`` run stops on every rank at the same check, nmf_tpu's."""
    out = _group(tmp_path_factory, (2, 2))
    _, infos = _ours(out, "thresh", 4)
    ref = _jax("thresh", (2, 2))
    assert ref["converged"] and ref["iterations"] < 1000
    assert [i["iterations"] for i in infos] == [ref["iterations"]] * 4
    assert all(i["converged"] for i in infos)


@pytest.mark.parametrize("shape", list(ranks.GROUPS), ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_leave_no_gloo_thread_behind(tmp_path_factory, shape):
    """After ``shutdown`` and its mesh dropped, no rank of a group runs a
    gloo thread: the groups end before the interpreter's teardown, where a
    group torn down with its threads alive aborted a rank now and then
    ("terminate called without an active exception")."""
    out = _group(tmp_path_factory, shape)
    for i in range(shape[0] * shape[1]):
        assert json.loads((out / f"exit.r{i}.json").read_text()) == {"gloo_threads": []}, i


def test_shutdown_drops_the_solvers_that_hold_a_mesh():
    """A sharded solve caches its solver, which holds the mesh and so the
    mesh's groups and their gloo threads; ``shutdown`` empties those caches,
    so that dropping the mesh ends the threads (one rank, a 1x1 mesh)."""
    code = (
        "import os, sys, numpy as np\n"
        "import nmf_tpu_torch as nt\n"
        "from nmf_tpu_torch.parallel.mesh import shutdown\n"
        "def gloo():\n"
        "    names = (open(f'/proc/self/task/{t}/comm').read().strip()\n"
        "             for t in os.listdir('/proc/self/task'))\n"
        "    return sorted(n for n in names if 'gloo' in n)\n"
        "mesh = nt.make_mesh((1, 1), device='cpu')\n"
        "rng = np.random.RandomState(0)\n"
        "nt.solve_sharded(rng.rand(8, 6), rng.rand(8, 2), rng.rand(2, 6),\n"
        "                 nt.SolveConfig(max_iter=5), mesh=mesh)\n"
        "print(len(gloo()) > 0)\n"
        "shutdown()\n"
        "del mesh\n"
        "print(gloo())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=RANK_SECONDS, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines() == ["True", "[]"]


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_is_jaxs_rule(n):
    """The default factorization of a world of n ranks is JAX's of n devices."""
    want = tuple(jmesh.make_mesh(devices=jax.devices()[:n]).shape.values())
    assert pmesh.mesh_shape(n) == want
    assert pmesh.mesh_shape(n, (1, n)) == (1, n)


def test_make_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match=r"mesh shape \(3, 3\) needs 9 devices"):
        pt.make_mesh((3, 3), device="cpu")
    with pytest.raises(ValueError, match="needs 9 devices"):
        jmesh.make_mesh(shape=(3, 3))


def test_check_mesh_refuses_what_is_not_a_mesh():
    with pytest.raises(TypeError, match="make_mesh"):
        pmesh.check_mesh(object())


def test_quant_scale_specs_are_jaxs():
    for ndim in (1, 2):
        assert tuple(pmesh.quant_scale_spec(ndim)) == tuple(jmesh.quant_scale_spec(ndim))
    with pytest.raises(ValueError, match="1-D or 2-D"):
        pmesh.quant_scale_spec(3)


def _no_cluster(monkeypatch):
    for var in (*pmesh._CLUSTER_ENV, "MASTER_PORT", "LOCAL_RANK", pmesh._REQUIRE_ENV):
        monkeypatch.delenv(var, raising=False)


def test_init_distributed_outside_a_cluster_warns_and_returns(monkeypatch):
    _no_cluster(monkeypatch)
    before = torch.distributed.is_initialized()
    with pytest.warns(RuntimeWarning, match="continuing as a single process"):
        pmesh.init_distributed(device="cpu")
    assert torch.distributed.is_initialized() == before


@pytest.mark.parametrize("env", [{pmesh._REQUIRE_ENV: "1"}, {"RANK": "0", "WORLD_SIZE": "2"}],
                         ids=["require_flag", "launcher_env"])
def test_init_distributed_in_a_cluster_raises(monkeypatch, env):
    """The require flag, or a launcher's variables, make the failure fatal."""
    if torch.distributed.is_initialized():
        pytest.skip("a process group exists in this worker: init_distributed is a no-op")
    _no_cluster(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises((ValueError, RuntimeError)):
            pmesh.init_distributed(device="cpu")


def _torchrun(args, cwd, nproc):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "nmf_tpu_torch", *args]
    proc = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True, text=True,
                          timeout=RANK_SECONDS)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc


@pytest.mark.parametrize("sub", ["run", "transform"])
def test_cli_mesh_under_torchrun_matches_nmf_tpu(tmp_path, sub):
    """``run --mesh 2x2`` and ``transform --mesh 2x2`` on four gloo ranks
    against nmf_tpu on a 2x2 mesh over the same files; rank 0 writes."""
    x, w, h, _ = ranks.problem()
    for name, a in (("X", x), ("W", w), ("H", h)):
        jbin.write_matrix(a, tmp_path / f"{name}.bin")
    cfg = jt.SolveConfig(max_iter=20, check_every=5)
    mesh = _jmesh((2, 2))
    if sub == "run":
        _torchrun(["run", "X.bin", "W.bin", "H.bin", "-o", "Wo.bin", "Ho.bin", "--mesh", "2x2",
                   "--device", "cpu", "--max-iter", "20", "--check-every", "5", "-q"],
                  tmp_path, 4)
        ref = jsharded.solve_sharded(x, w, h, cfg, mesh=mesh)
        pairs = (("Wo.bin", ref.w), ("Ho.bin", ref.h))
    else:
        _torchrun(["transform", "X.bin", "W.bin", "-o", "Ht.bin", "--mesh", "2x2",
                   "--device", "cpu", "--max-iter", "20", "--check-every", "5", "-q"],
                  tmp_path, 4)
        h0 = np.random.RandomState(0).rand(ranks.K, ranks.N).astype(np.float32)
        pairs = (("Ht.bin", j_h_only(x, w, h0, cfg, mesh=mesh).h),)
    for path, want in pairs:
        got = jbin.read_matrix(tmp_path / path)
        np.testing.assert_allclose(got, np.asarray(want), rtol=FRTOL, atol=FATOL)


def test_chip_smoke_phase_18_reads_the_mesh_launches():
    """``chip_smoke.py`` phase 18 comes before 19 and 20 and reports K1's and K2's
    ``numerator_only`` launches (K3's own) on each mesh solve."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_for_mesh_test",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PHASES[-3:] == ("mesh", "serving", "examples") and len(smoke.PHASES) == 20
    launches = {"mesh 1x1 reference": {"update_h": 0, "update_h_numerator": 200,
                                       "update_w_numerator": 200, "kl_cost": 0},
                "mesh 1x1 flagship bfloat16": {"update_h_numerator": 50,
                                               "update_w_numerator": 50}}
    assert smoke._mesh_launches(launches, "update_h") == {
        "mesh 1x1 reference": 200, "mesh 2x2 reference": 0, "mesh 1x1 flagship float32": 0,
        "mesh 1x1 flagship bfloat16": 50}
    assert set(smoke._mesh_launches(launches, "kl_cost").values()) == {0}
    assert smoke._numerator_launches(7)["update_w_numerator"] == 7
