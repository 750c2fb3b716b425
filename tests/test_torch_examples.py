"""The port's examples (``nmf_tpu_torch.examples``) against the JAX
package's (``examples/*.py``) on the CPU, quick sizes
(``NMF_TPU_EXAMPLE_QUICK=1``).

Each JAX script runs in-process through ``runpy``, as
``tests/test_examples.py`` runs it (the CPU backend of
``tests/conftest.py``), with the calls whose results it prints recorded;
each port example runs through its ``main`` with ``--device cpu``.  The
figures are held figure by figure:

- f32 costs: relative 1e-5; the ``bfloat16`` tier: relative 1e-3; the int8
  cost: relative 1e-5 (the codes are bitwise, ``ops/quant``);
- factors: rtol 1e-4 / atol 1e-6 (the COO solve's rtol 1e-3: its sums run
  in another order than JAX's scatter; HALS: the cost only);
- ``separate``: the cost relative 1e-4 (``tests/test_torch_separation.py``),
  each component's peak frequency and label equal;
- restart, rank-sweep and online pass costs: relative 1e-5, ``best_index``
  equal; cophenetic coefficients: absolute 1e-6;
- iteration and block counts: equal.  Artifact byte sizes are not compared:
  the two formats differ by design (README).

``distributed`` runs as a 2x2 gloo group of four CPU ranks under
``torch.distributed.run`` (``tests/torch_example_ranks.py``) and is held
to the JAX functions on the same inputs over ``jax.devices()[:4]`` (a 2x2
``make_mesh`` and a four-device batch mesh), since the JAX script's own
figures depend on its device count.
"""

import os
import pathlib
import runpy
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.parallel import mesh as jmesh  # noqa: E402
from nmf_tpu.parallel import sharded as jsharded  # noqa: E402
from nmf_tpu.serving import load_transform as j_load  # noqa: E402
from nmf_tpu.serving import save_transform as j_save  # noqa: E402

import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.examples import (  # noqa: E402
    advanced_features,
    basic_usage,
    distributed,
    separation_demo,
    serving_pipeline,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
RANKS_HELPER = REPO / "tests" / "torch_example_ranks.py"
RANK_SECONDS = 240
COST, BF16_COST, SEP_COST = 1e-5, 1e-3, 1e-4
FRTOL, FATOL = 1e-4, 1e-6
# the COO solve sums its scatter in another order than JAX's (.at[].add):
# at the example's 95%-sparse X, 4 of 1024 entries of H differ by up to
# 4.8e-4 relative; tests/test_torch_sparse.py holds its accelerated
# factors at the same 1e-3
COO_FRTOL = 1e-3


@pytest.fixture
def quick(monkeypatch):
    monkeypatch.setenv("NMF_TPU_EXAMPLE_QUICK", "1")


def _close(a, b, what="", rtol=FRTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=FATOL, err_msg=what)


def _cost(a, b, rel=COST):
    assert float(a) == pytest.approx(float(b), rel=rel)


def _record(monkeypatch, names):
    """Wrap ``nmf_tpu``'s ``names`` so that each call's result is kept,
    in call order, under its name."""
    calls = {name: [] for name in names}
    for name in names:
        def wrapped(*a, _fn=getattr(jt, name), _name=name, **kw):
            res = _fn(*a, **kw)
            calls[_name].append(res)
            return res
        monkeypatch.setattr(jt, name, wrapped)
    return calls


def _run_jax(name, monkeypatch):
    """The JAX example's globals after a quick run (runpy, as
    tests/test_examples.py runs it)."""
    path = str(EXAMPLES / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return runpy.run_path(path, run_name="__main__")


def _no_nan(capsys):
    out = capsys.readouterr().out
    assert out.strip() and "nan" not in out.lower()


def test_basic_usage_matches_nmf_tpu(quick, monkeypatch, tmp_path, capsys):
    calls = _record(monkeypatch, ["solve"])
    fits, transforms, written = [], [], {}

    class RecordedNMF(jt.NMF):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fits.append(self)

        def transform(self, *a, **kw):
            h = super().transform(*a, **kw)
            transforms.append(np.asarray(h))
            return h

    monkeypatch.setattr(jt, "NMF", RecordedNMF)
    # the JAX script writes to /tmp: keep its arrays instead
    monkeypatch.setattr(jt, "write_matrix",
                        lambda a, path: written.__setitem__(os.path.basename(path), np.asarray(a)))
    _run_jax("basic_usage", monkeypatch)
    capsys.readouterr()
    ours = basic_usage.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    _no_nan(capsys)

    (ref,) = calls["solve"]
    a = ours["A"]
    assert (a["iterations"], a["num_checks"], a["converged"]) == (
        int(ref.iterations), int(ref.num_checks), bool(ref.converged))
    _cost(a["cost"], ref.cost)
    _close(a["w"], ref.w)
    _close(a["h"], ref.h)
    (model,) = fits
    b = ours["B"]
    assert b["iterations"] == model.n_iter_
    _cost(b["cost"], model.reconstruction_err_)
    _close(b["w"], model.w_)
    _close(b["h"], model.components_)
    (h_new,) = transforms
    assert ours["transform"]["h"].shape == h_new.shape == (16, 100)
    _close(ours["transform"]["h"], h_new)
    # the .bin files round-trip, and hold what the JAX script wrote
    for path, key, mine in zip(ours["write"]["paths"], ("Wout.bin", "Hout.bin"), (a["w"], a["h"])):
        assert pathlib.Path(path).parent == tmp_path
        back = pt.read_matrix(path)
        np.testing.assert_array_equal(back, mine)
        _close(back, written[key])


def test_separation_demo_matches_nmf_tpu(quick, monkeypatch, capsys):
    calls = _record(monkeypatch, ["separate"])
    _run_jax("separation_demo", monkeypatch)
    capsys.readouterr()
    ours = separation_demo.main(["--device", "cpu"])
    _no_nan(capsys)
    (ref,) = calls["separate"]
    sep = ours["separate"]
    assert sep["iterations"] == int(ref.solve_result.iterations)
    _cost(sep["cost"], ref.solve_result.cost, SEP_COST)
    freqs = np.fft.rfftfreq(1024, 1 / 16000)
    assert len(ours["components"]) == 4
    for comp, col in zip(ours["components"], np.asarray(ref.w).T):
        spread = float((col > 0.25 * col.max()).mean())
        assert comp["peak_hz"] == float(freqs[int(np.argmax(col))])
        assert comp["kind"] == ("tonal" if spread < 0.05 else "broadband")
    assert {c["kind"] for c in ours["components"]} == {"tonal", "broadband"}


def test_separation_demo_writes_the_wavs(quick, tmp_path, capsys):
    wavfile = pytest.importorskip("scipy.io.wavfile")
    ours = separation_demo.main(["--device", "cpu", "--wav", str(tmp_path / "demo")])
    assert "wrote" in capsys.readouterr().out
    paths = ours["wav"]["paths"]
    assert [pathlib.Path(p).name for p in paths] == [
        "demo_mix.wav", *(f"demo_src{i}.wav" for i in range(4))]
    for p in paths:
        sr, data = wavfile.read(p)
        assert sr == 16000 and data.dtype == np.int16 and data.shape == (16000,)


def test_serving_pipeline_matches_nmf_tpu(quick, monkeypatch, capsys):
    g = _run_jax("serving_pipeline", monkeypatch)
    capsys.readouterr()
    ours = serving_pipeline.main(["--device", "cpu"])
    _no_nan(capsys)
    fit = g["fit"]
    assert ours["train"]["iterations"] == int(fit.iterations)
    _cost(ours["train"]["cost"], fit.cost)
    _close(ours["train"]["w"], fit.w)
    for key, ref in (("serve", g["res"]), ("quantized", g["resq"])):
        np.testing.assert_array_equal(ours[key]["block_iterations"], ref.block_iterations)
        _cost(ours[key]["cost"], ref.cost)
        _close(ours[key]["h"], ref.h)
    assert ours["serve"]["blocks"] == len(g["res"].block_iterations) == 4
    assert ours["stream"]["bitwise"]
    np.testing.assert_array_equal(ours["stream"]["h"], ours["serve"]["h"])
    _cost(ours["masked"]["cost"], g["resm"].cost)
    _close(ours["masked"]["h"], g["resm"].h)
    assert ours["masked"]["finite"] and bool(np.isfinite(g["resm"].h).all())
    # the JAX script's streamed masked H (its work directory lives until exit)
    _close(ours["masked_stream"]["h"], jt.read_matrix(g["hm"]))


def test_advanced_features_matches_nmf_tpu(quick, monkeypatch, capsys):
    calls = _record(monkeypatch, ["solve"])
    g = _run_jax("advanced_features", monkeypatch)
    capsys.readouterr()
    with pytest.warns(DeprecationWarning, match="solve_sparse"):
        ours = advanced_features.main(["--device", "cpu"])
    _no_nan(capsys)

    # nt.solve in the JAX script's order: three tiers, int8, live, the
    # in-memory reference, HALS
    assert len(calls["solve"]) == 7
    *tiers, int8, live, ref, hals = calls["solve"]
    for (tier, mine), theirs in zip(ours["tiers"].items(), tiers):
        rel = BF16_COST if tier == "bfloat16" else COST
        _cost(mine["cost"], theirs.cost, rel)
        assert mine["iterations"] == int(theirs.iterations) == 50
        if tier != "bfloat16":
            _close(mine["w"], theirs.w)
            _close(mine["h"], theirs.h)
    assert list(ours["tiers"]) == ["float32", "float32_fast", "bfloat16"]
    pairs = [("int8", int8), ("live", live), ("in_memory", ref), ("out_of_core", g["res_ooc"]),
             ("ooc_accel", g["res_ooa"]), ("strict", g["res_strict"]), ("sparse", g["res_sp"]),
             ("tile_sparse", g["res_t"]), ("hals", hals), ("semi", g["semi"])]
    for key, theirs in pairs:
        mine = ours[key]
        _cost(mine["cost"], theirs.cost)
        assert (mine["iterations"], mine["num_checks"]) == (
            int(theirs.iterations), int(theirs.num_checks)), key
        if key != "hals":       # HALS: the cost only, as tests/test_torch_families.py
            rtol = COO_FRTOL if key == "sparse" else FRTOL
            _close(mine["w"], theirs.w, key, rtol)
            _close(mine["h"], theirs.h, key, rtol)
    _cost(ours["hals"]["out_of_core"]["cost"], g["res_ho"].cost)
    assert ours["sparse"]["nnz"] == g["nnz"]
    assert ours["tile_sparse"]["occupancy"] == pytest.approx(g["tx"].occupancy(), abs=0)
    assert ours["tile_sparse"]["tiles"] == int(g["tx"].tiles.shape[0])

    sel, sweep = g["sel"], g["sweep"]
    np.testing.assert_allclose(ours["restarts"]["costs"], np.asarray(sel.costs), rtol=COST)
    assert ours["restarts"]["best_index"] == int(sel.best_index)
    assert ours["rank_sweep"]["ranks"] == [int(r) for r in sweep.ranks] == [4, 8, 16]
    np.testing.assert_allclose(ours["rank_sweep"]["costs"], np.asarray(sweep.costs), rtol=COST)

    tr = g["tr"]
    _cost(ours["ooc_transform"]["cost"], tr.cost)
    assert ours["ooc_transform"]["blocks"] == len(tr.blocks)
    np.testing.assert_array_equal(ours["ooc_transform"]["iterations"], tr.iterations)
    _close(ours["ooc_transform"]["h"], tr.h)
    served = g["served"]
    _cost(ours["serving"]["cost"], served.cost)
    assert ours["serving"]["blocks"] == len(served.block_iterations) == 2
    _close(ours["serving"]["h"], served.h)

    stab = g["stab"]
    assert ours["stability"]["ranks"] == [int(r) for r in stab.ranks]
    np.testing.assert_allclose(ours["stability"]["cophenetic"], np.asarray(stab.cophenetic),
                               rtol=0, atol=1e-6)
    onl = g["onl"]
    np.testing.assert_allclose(ours["online"]["pass_costs"], [sum(p) for p in onl.block_costs],
                               rtol=COST)
    _close(ours["online"]["w"], onl.w)
    assert ours["semi"]["frozen_ok"] and g["frozen_ok"]


def _flat(npz):
    return {k: npz[k] for k in npz.files}


def test_distributed_on_four_gloo_ranks_matches_nmf_tpu_on_four_devices(quick, tmp_path):
    """The example under ``torch.distributed.run`` on a 2x2 gloo group of
    four CPU ranks, every rank exiting 0, against the JAX functions on the
    same inputs over four devices."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "RANK", "WORLD_SIZE", "MASTER_", "LOCAL_RANK"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=4",
           str(RANKS_HELPER), str(tmp_path)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=RANK_SECONDS)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    ranks = [_flat(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    # each rank printed where its W block lies: rows by its 'mr' coordinate
    for r in range(4):
        rows = f"{r // 2 * 256}:{r // 2 * 256 + 256}"
        assert f"W: rank {r} holds rows {rows}, cols 0:16" in proc.stdout
    ours = ranks[0]
    assert list(ours["mesh.shape"]) == [2, 2] and int(ours["mesh.world"]) == 4
    for other in ranks[1:]:
        for key in ("sharded.cost", "sharded.iterations", "batched.costs", "serving.cost"):
            np.testing.assert_array_equal(other[key], ours[key])

    devs = jax.devices()[:4]
    mesh = jmesh.make_mesh(shape=(2, 2), devices=devs)
    (x, w0, h0), (xs, ws, hs) = distributed.inputs(512, 256, 16, 4, True)
    res = jsharded.solve_sharded(x, w0, h0,
                                 jt.SolveConfig(max_iter=20, thresh=1e-4, check_every=25),
                                 mesh=mesh)
    assert int(ours["sharded.iterations"]) == int(res.iterations)
    assert int(ours["sharded.num_checks"]) == int(res.num_checks)
    _cost(ours["sharded.cost"], res.cost)
    _close(ours["sharded.w"], res.w)
    _close(ours["sharded.h"], res.h)

    bres = jt.solve_batched(xs, ws, hs, jt.SolveConfig(max_iter=20),
                            mesh=Mesh(np.asarray(devs), ("batch",)))
    np.testing.assert_allclose(ours["batched.costs"], np.asarray(bres.cost), rtol=COST)
    np.testing.assert_array_equal(ours["batched.iterations"], np.asarray(bres.iterations))

    art = str(tmp_path / "mesh-model.nmfz")
    j_save(art, np.asarray(res.w), n_block=128,
           config=jt.SolveConfig(max_iter=10, backend="jnp"), platforms=("cpu",),
           mesh_shape=(2, 2))
    served = j_load(art, mesh=mesh)(x)
    _cost(ours["serving.cost"], served.cost)
    np.testing.assert_array_equal(ours["serving.block_iterations"], served.block_iterations)
    _close(ours["serving.h"], served.h)


def test_distributed_as_a_plain_process_is_a_one_rank_mesh(quick, capsys):
    """No launcher: a 1x1 gloo mesh over this process, left through
    ``shutdown`` (no group remains); the figures those of one device."""
    import torch.distributed as dist

    ours = distributed.main(["--device", "cpu"])
    assert not dist.is_initialized()
    assert ours["mesh"] == {"shape": [1, 1], "world": 1}
    assert "W: rank 0 holds rows 0:512, cols 0:16" in capsys.readouterr().out
    (x, w0, h0), (xs, ws, hs) = distributed.inputs(512, 256, 16, 1, True)
    ref = pt.solve(x, w0, h0, pt.SolveConfig(max_iter=20, thresh=1e-4, check_every=25),
                   device="cpu")
    _cost(ours["sharded"]["cost"], ref.cost)
    _close(ours["sharded"]["w"], ref.w)
    bref = pt.solve_batched(xs, ws, hs, pt.SolveConfig(max_iter=20), device="cpu")
    np.testing.assert_allclose(ours["batched"]["costs"], bref.cost.numpy(), rtol=COST)


def test_sections_reach_the_hook_in_order(quick, tmp_path, capsys):
    """``main(section=)`` enters one context a section, around its work."""
    import contextlib

    seen = []

    @contextlib.contextmanager
    def section(name):
        seen.append(("enter", name))
        yield
        seen.append(("exit", name))

    out = basic_usage.main(["--device", "cpu", "--out-dir", str(tmp_path)], section=section)
    names = ["A", "B", "transform"]
    assert seen == [(e, n) for n in names for e in ("enter", "exit")]
    assert set(names) <= set(out)


def test_default_device_is_the_card(quick, tmp_path):
    """Without ``--device`` an example asks for CUDA, which raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        basic_usage.main(["--out-dir", str(tmp_path)])


def test_importing_the_examples_does_no_work():
    """The modules do their work in ``main`` only (the JAX scripts'
    module-level work moved there)."""
    code = ("import nmf_tpu_torch.examples.advanced_features, "
            "nmf_tpu_torch.examples.serving_pipeline, nmf_tpu_torch.examples.basic_usage, "
            "nmf_tpu_torch.examples.distributed, nmf_tpu_torch.examples.separation_demo")
    env = {**os.environ, "PYTHONPATH": str(REPO), "NMF_TPU_EXAMPLE_QUICK": "1"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""


def test_runs_as_a_module_script(tmp_path):
    """``python -m nmf_tpu_torch.examples.basic_usage --device cpu``."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "NMF_TPU_EXAMPLE_QUICK": "1",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "nmf_tpu_torch.examples.basic_usage",
                           "--device", "cpu", "--out-dir", str(tmp_path)],
                          env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("A: 30 iterations, converged=False, KL cost ")
    assert lines[-1] == f"   wrote {tmp_path / 'Wout.bin'} {tmp_path / 'Hout.bin'}"


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_for_examples",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name", ["basic_usage", "separation_demo", "serving_pipeline",
                                  "advanced_features", "distributed"])
def test_phase_20_expects_the_calls_each_section_makes(name, quick, monkeypatch, tmp_path,
                                                        capsys):
    """``chip_smoke.py`` phase 20a's expected launches of each section
    (``_ex_want``) against the kernel wrappers' calls the section makes on
    the CPU, where ``auto`` resolves to the wrappers: one a launch on the
    card wherever the card's route is the kernels too.  The sections the
    H100 rule sends to batched cuBLAS and the mesh's numerators (plain on
    CPU tensors, ``parallel/sharded.py``) route otherwise here."""
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    smoke = _smoke()
    monkeypatch.setattr(fused_mu, "LAUNCHES", dict.fromkeys(fused_mu.LAUNCHES, 0))
    monkeypatch.setattr(ts, "LAUNCHES", dict.fromkeys(ts.LAUNCHES, 0))
    update, kl_plain = fused_mu._update_fused, fused_mu.kl_cost_plain

    def counted_update(kind, w, h, x, eps, precision, numerator_only):
        fused_mu.LAUNCHES[f"{kind}_numerator" if numerator_only else kind] += 1
        return update(kind, w, h, x, eps, precision, numerator_only)

    def counted_kl(*a, **kw):      # a 2-D call's, or a batched call's one member
        fused_mu.LAUNCHES["kl_cost"] += 1
        return kl_plain(*a, **kw)

    monkeypatch.setattr(fused_mu, "_update_fused", counted_update)
    monkeypatch.setattr(fused_mu, "kl_cost_plain", counted_kl)
    for target in ("h_numerator", "w_numerator"):
        def counted_sweep(*a, _fn=getattr(ts, target), _key=target, **kw):
            ts.LAUNCHES[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ts, target, counted_sweep)

    hook = smoke._ExSections(card_modes=False)
    argv = ["--device", "cpu"] + (["--out-dir", str(tmp_path)] if name == "basic_usage" else [])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = smoke._ex_module(name).main(argv, section=hook)
    capsys.readouterr()
    other = {"restarts", "rank_sweep", "stability"} if name == "advanced_features" else (
        {"sharded"} if name == "distributed" else set())
    checked = 0
    for sec, rec in hook.records.items():
        if sec in other:
            continue
        assert rec["counts"] == smoke._ex_want(name, sec, out, rec), sec
        checked += 1
    assert checked == len(hook.records) - len(other)
    launched = {sec for sec, rec in hook.records.items()
                if sec not in other and any(rec["counts"].values())}
    routes = smoke.EX_ROUTES.get(name, {})
    assert launched == {sec for sec in hook.records if sec not in other
                        and routes.get(sec, "pallas") == "pallas"}


def test_phase_20_reads_each_kernels_launches():
    """The kernels line's ``examples_launches``: a kernel's launches on each
    section, K1's and K2's in full and ``numerator_only`` together."""
    smoke = _smoke()
    launches = {"example basic_usage A": {"update_h": 200, "update_w": 200, "kl_cost": 8},
                "example distributed sharded": {"update_h_numerator": 100,
                                                "update_w_numerator": 100},
                "example advanced_features tile_sparse": {"K5 h_numerator": 30,
                                                          "K5 w_numerator": 30},
                "serve auto float32": {"update_h": 400}}
    assert smoke._examples_launches(launches, "update_h") == {
        "basic_usage A": 200, "distributed sharded": 100, "advanced_features tile_sparse": 0}
    assert smoke._examples_launches(launches, "kl_cost") == {
        "basic_usage A": 8, "distributed sharded": 0, "advanced_features tile_sparse": 0}
    assert smoke._examples_launches(launches, "h_numerator") == {
        "basic_usage A": 0, "distributed sharded": 0, "advanced_features tile_sparse": 30}
    assert smoke.PHASES[-1] == "examples"
    assert smoke.EX_NAMES == ("basic_usage", "separation_demo", "serving_pipeline",
                              "advanced_features", "distributed")
