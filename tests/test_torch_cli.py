"""The port's CLI (``python -m nmf_tpu_torch``) on the CPU, and its imports.

The end-to-end case runs the CLI in a subprocess (one torch thread) and
holds its output files to an in-process ``nmf_tpu.solve`` with the solver
tolerances of tests/test_torch_solver.py: factors rtol 1e-4 / atol 1e-6.
"""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.io import binio as jbin  # noqa: E402
from nmf_tpu_torch import cli  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "nmf_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"  # the suite runs several workers
    return env


def _port(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "nmf_tpu_torch", *args], cwd=cwd, env=_env(),
        capture_output=True, text=True, timeout=300,
    )


def test_gen_then_run_matches_jax(tmp_path):
    gen = _port("gen", ".", cwd=tmp_path)
    assert gen.returncode == 0, gen.stderr
    run = _port("run", "X.bin", "W.bin", "H.bin", "-o", "Wout.bin", "Hout.bin",
                "--device", "cpu", "--max-iter", "50", "-q", "--jsonl", "run.jsonl",
                cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    assert run.stderr == ""  # -q
    w_out = jbin.read_matrix(tmp_path / "Wout.bin")
    h_out = jbin.read_matrix(tmp_path / "Hout.bin")
    x, w, h = (jbin.read_matrix(tmp_path / f"{s}.bin") for s in "XWH")
    ref = jt.solve(x, w, h, jt.SolveConfig(max_iter=50))
    np.testing.assert_allclose(w_out, np.asarray(ref.w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(h_out, np.asarray(ref.h), rtol=1e-4, atol=1e-6)
    rec = json.loads((tmp_path / "run.jsonl").read_text().splitlines()[-1])
    assert (rec["m"], rec["k"], rec["n"]) == (4096, 128, 350)
    assert rec["iterations"] == 50 and [c["iteration"] for c in rec["checks"]] == [25, 50]
    assert rec["final_cost"] == pytest.approx(float(ref.cost), rel=1e-5)


def test_run_with_random_init(tmp_path):
    x = np.random.RandomState(2).rand(40, 30).astype(np.float32)
    jbin.write_matrix(x, tmp_path / "X.bin")
    rc = cli.main(["run", str(tmp_path / "X.bin"), "--rank", "4", "--init", "random",
                   "--seed", "3", "--device", "cpu", "--max-iter", "20", "-q",
                   "-o", str(tmp_path / "W.bin"), str(tmp_path / "H.bin")])
    assert rc == 0
    from nmf_tpu.models.init import random_init

    w0, h0 = random_init(40, 4, 30, seed=3)
    ref = jt.solve(x, w0, h0, jt.SolveConfig(max_iter=20))
    np.testing.assert_allclose(jbin.read_matrix(tmp_path / "W.bin"), np.asarray(ref.w),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "flags",
    [
        ["--mask", "X.bin"],
        ["--accelerate"],
        ["--dtype", "bfloat16"],
        ["--x-dtype", "int8"],
        ["--backend", "jnp"],
        ["--mesh", "2x1"],
        ["--no-cost"],
        ["--beta", "2"],
        ["--checkpoint-dir", "ckpt"],
        ["--strict-compat"],
        ["--mesh", "1x1", "--out-of-core"],
        ["--restarts", "4"],
    ],
)
def test_refused_flag_exits_2(capsys, tmp_path, flags):
    """A flag not in the port exits 2 naming its ROADMAP.md item.  The
    precision flags, ``--backend jnp`` and ``--no-cost``, refused when this
    test was named, are ported: the parser takes them, and the run exits 2
    later, on its (here missing) input.  ``--out-of-core`` is ported too;
    with ``--mesh`` it is refused for the mesh.  ``--accelerate``,
    ``--strict-compat``, ``--beta 2`` and ``--mask`` are ported: they run on
    a small problem through both CLIs (:func:`_run_both_clis`; the mask is
    X.bin itself, real-valued weights).  ``--restarts`` is ported too: the
    parser takes it and the run exits 2 on its missing input
    (``test_run_restarts_matches_jax_cli`` runs it).  ``--checkpoint-dir``
    is ported: it runs through both CLIs (:func:`_ckpt_both_clis`).
    ``--mesh`` is ported (tests/test_torch_mesh.py runs it under
    ``torch.distributed.run``): without a launcher a 2x1 mesh exits 2 naming
    the launcher.  ``--mesh`` with ``--out-of-core``, refused naming
    ROADMAP.md step 12b when this test was named, runs: a 1x1 mesh in this
    process matches the JAX CLI's single-device streamed run
    (tests/test_torch_mesh_paths.py runs wider meshes under
    ``torch.distributed.run``)."""
    if flags[0] == "--checkpoint-dir":
        _ckpt_both_clis(tmp_path, [])
        return
    if flags[0] == "--mask":
        flags = ["--mask", str(tmp_path / "X.bin")]
    if flags[0] in ("--accelerate", "--strict-compat", "--beta", "--mask"):
        _run_both_clis(tmp_path, flags)
        return
    if flags[:2] == ["--mesh", "1x1"]:
        _run_both_clis(tmp_path, flags, jax_flags=flags[2:])
        return
    rc = cli.main(["run", "X.bin", "W.bin", "H.bin", "--device", "cpu", *flags])
    assert rc == 2
    err = capsys.readouterr().err
    if flags[0] in ("--dtype", "--x-dtype", "--backend", "--no-cost", "--restarts"):
        assert "file not found" in err and "ROADMAP.md" not in err
        return
    if flags[:2] == ["--mesh", "2x1"]:
        assert "--mesh 2x1 needs 2 ranks" in err and "torch.distributed.run" in err
        return
    assert flags[0] in err and "ROADMAP.md" in err


@pytest.mark.parametrize(
    "flags,item",
    [
        (["--beta", "2"], "--beta (ROADMAP.md Queue 1: ops (beta family))"),
        (["--backend", "autotune"], "--backend autotune (ROADMAP.md Queue 1 step 11"),
        (["--algorithm", "hals"], "--algorithm (ROADMAP.md Queue 1: ops (HALS))"),
        (["--checkpoint-every", "50"], "--checkpoint-every (ROADMAP.md Queue 1 item 13"),
        (["--online-passes", "2"], "--online-passes (ROADMAP.md Queue 1: model families"),
        (["--l2-h", "0.5"], "--l2-h (ROADMAP.md Queue 1: ops (penalized MU))"),
    ],
)
def test_non_default_value_refused(capsys, tmp_path, flags, item):
    """A value other than the JAX CLI's default is still refused, before
    any input is read, naming its ROADMAP.md item.  ``--beta 2``,
    ``--algorithm hals`` (with the ``--beta 2`` HALS requires in both CLIs)
    and ``--l2-h 0.5``, refused when this test was named, are ported: they
    run through both CLIs (:func:`_run_both_clis`); so is ``--online-passes
    2``, with the ``--online`` it applies to (:func:`_online_both_clis`),
    and ``--checkpoint-every 50``, which without ``--checkpoint-dir`` leaves
    the run as it is in both CLIs, and ``--backend autotune`` (on the CPU it
    measures nothing in either package)."""
    if flags[0] in ("--checkpoint-every", "--backend"):
        _run_both_clis(tmp_path, flags)
        return
    if flags[0] == "--online-passes":
        _online_both_clis(tmp_path, flags)
        return
    if flags[0] in ("--beta", "--algorithm", "--l2-h"):
        _run_both_clis(tmp_path, flags + (["--beta", "2"] if flags[0] == "--algorithm" else []))
        return
    rc = cli.main(["run", "X.bin", "W.bin", "H.bin", "--device", "cpu", *flags])
    assert rc == 2
    err = capsys.readouterr().err
    assert item in err and "file not found" not in err


def _run_both_clis(tmp_path, flags, jax_flags=None):
    """``run`` with ``flags`` through both CLIs (the JAX CLI with
    ``jax_flags`` where given) on a small problem: the files agree to rtol
    1e-4 / atol 1e-6 (test_gen_then_run_matches_jax's)."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = [str(tmp_path / f"{s}.bin") for s in "XWH"]
    common = ["--max-iter", "50", "--check-every", "10", "-q"]
    jax_flags = flags if jax_flags is None else jax_flags
    out = {tag: [str(tmp_path / f"{f}{tag}.bin") for f in "WH"] for tag in "pj"}
    assert cli.main(["run", *files, "-o", *out["p"], "--device", "cpu", *common, *flags]) == 0
    assert _jax_cli(["run", *files, "-o", *out["j"], *common, *jax_flags], tmp_path) == 0
    for ours, ref in zip(out["p"], out["j"]):
        np.testing.assert_allclose(jbin.read_matrix(ours), jbin.read_matrix(ref),
                                   rtol=1e-4, atol=1e-6)


# JAX-CLI run flags spelled out at their JAX defaults (nmf_tpu/cli.py:42-114,
# 1188-1227), and the two ported solver flags
_DEFAULT_SPELLINGS = [
    ["--beta", "1"], ["--algorithm", "mu"], ["--restarts", "1"], ["--freeze", "0"],
    ["--l1-w", "0"], ["--l1-h", "0"], ["--l2-w", "0"], ["--l2-h", "0"],
    ["--checkpoint-every", "100"], ["--online-passes", "1"], ["--online-rho", "1"],
    ["--online-inner-iters", "20"], ["--backend", "auto"], ["--backend", "jnp"], ["--no-cost"],
]


@pytest.fixture(scope="module")
def gen_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("gen")
    assert cli.main(["gen", str(d)]) == 0
    return d


def _jax_cli(args, cwd):
    from nmf_tpu import cli as jcli

    here = os.getcwd()
    os.chdir(cwd)
    try:
        return jcli.main(args)
    finally:
        os.chdir(here)


@pytest.mark.parametrize(
    "flags",
    [*_DEFAULT_SPELLINGS, [f for spelling in _DEFAULT_SPELLINGS[:12] for f in spelling]],
    ids=[*(" ".join(f) for f in _DEFAULT_SPELLINGS), "all-defaults"],
)
def test_jax_default_flags_match_jax_cli(gen_dir, tmp_path, flags):
    """Each JAX default spelled out, ``--backend jnp`` and ``--no-cost`` run
    through both CLIs on the same ``gen`` files: factors rtol 1e-4 / atol
    1e-6 and the final cost within 1e-5, as test_gen_then_run_matches_jax
    holds them (none in either without a cost)."""
    files = [str(gen_dir / f"{s}.bin") for s in "XWH"]
    common = ["--max-iter", "10", "--check-every", "5", "-q", *flags]
    out = {tag: [str(tmp_path / f"{f}{tag}.bin") for f in "WH"] for tag in "pj"}
    assert cli.main(["run", *files, "-o", *out["p"], "--device", "cpu",
                     "--jsonl", str(tmp_path / "port.jsonl"), *common]) == 0
    assert _jax_cli(["run", *files, "-o", *out["j"], "--jsonl", "jax.jsonl", *common],
                    tmp_path) == 0
    for ours, ref in zip(out["p"], out["j"]):
        np.testing.assert_allclose(jbin.read_matrix(ours), jbin.read_matrix(ref),
                                   rtol=1e-4, atol=1e-6)
    ours, ref = (json.loads((tmp_path / f"{s}.jsonl").read_text().splitlines()[-1])
                 for s in ("port", "jax"))
    assert ours["iterations"] == ref["iterations"] == 10
    assert [c["iteration"] for c in ours["checks"]] == [c["iteration"] for c in ref["checks"]]
    if "--no-cost" in flags:
        assert ours["final_cost"] is None and ref["final_cost"] is None
    else:
        assert ours["final_cost"] == pytest.approx(ref["final_cost"], rel=1e-5)


def _write_problem(d, m=96, k=12, n=1000, seed=17):
    """The tests/test_streaming.py problem as .bin files (or another size)."""
    rng = np.random.RandomState(seed)
    for name, shape in (("X", (m, n)), ("W", (m, k)), ("H", (k, n))):
        jbin.write_matrix(rng.rand(*shape).astype(np.float32), d / f"{name}.bin")


def test_out_of_core_run_matches_jax_cli(tmp_path):
    """``run --out-of-core --block-n 256`` against the JAX CLI's on the same
    files: factors rtol 1e-5 (the blockwise-summation drift of
    tests/test_streaming.py), the cost within 1e-5."""
    from nmf_tpu import cli as jcli

    _write_problem(tmp_path)
    common = ["X.bin", "W.bin", "H.bin", "--out-of-core", "--block-n", "256",
              "--max-iter", "30", "--check-every", "10"]
    run = _port("run", *common, "-o", "Wp.bin", "Hp.bin", "--device", "cpu",
                "--jsonl", "port.jsonl", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    assert "[nmf] out-of-core: streamed 96x1000 X (0.00 GB as float32)" in run.stderr
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert jcli.main(["run", *common, "-o", "Wj.bin", "Hj.bin", "-q",
                          "--jsonl", "jax.jsonl"]) == 0
    finally:
        os.chdir(cwd)
    for f in "WH":
        np.testing.assert_allclose(jbin.read_matrix(tmp_path / f"{f}p.bin"),
                                   jbin.read_matrix(tmp_path / f"{f}j.bin"), rtol=1e-5, atol=1e-8)
    ours, ref = (json.loads((tmp_path / f"{s}.jsonl").read_text().splitlines()[-1])
                 for s in ("port", "jax"))
    assert ours["iterations"] == ref["iterations"] == 30
    assert [c["iteration"] for c in ours["checks"]] == [10, 20, 30]
    assert ours["final_cost"] == pytest.approx(ref["final_cost"], rel=1e-5)


@pytest.mark.parametrize("flags", [["--backend", "jnp"], ["--no-cost"], ["--beta", "1", "--freeze", "0"]])
def test_out_of_core_default_flags_match_jax_cli(tmp_path, flags):
    """``--out-of-core`` takes ``--backend``, ``--no-cost`` and the JAX
    defaults as the JAX CLI does: the files of both CLIs agree as in
    test_out_of_core_run_matches_jax_cli."""
    _write_problem(tmp_path)
    common = ["X.bin", "W.bin", "H.bin", "--out-of-core", "--block-n", "256",
              "--max-iter", "10", "--check-every", "5", "-q", *flags]
    run = _port("run", *common, "-o", "Wp.bin", "Hp.bin", "--device", "cpu",
                "--jsonl", "port.jsonl", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    assert _jax_cli(["run", *common, "-o", "Wj.bin", "Hj.bin", "--jsonl", "jax.jsonl"],
                    tmp_path) == 0
    for f in "WH":
        np.testing.assert_allclose(jbin.read_matrix(tmp_path / f"{f}p.bin"),
                                   jbin.read_matrix(tmp_path / f"{f}j.bin"), rtol=1e-5, atol=1e-8)
    ours, ref = (json.loads((tmp_path / f"{s}.jsonl").read_text().splitlines()[-1])
                 for s in ("port", "jax"))
    assert ours["iterations"] == ref["iterations"] == 10
    if "--no-cost" in flags:
        assert ours["final_cost"] is None and ref["final_cost"] is None
    else:
        assert ours["final_cost"] == pytest.approx(ref["final_cost"], rel=1e-5)


def test_out_of_core_with_random_init(tmp_path):
    """--rank --init random streams too, from the init the JAX CLI draws."""
    _write_problem(tmp_path)
    rc = cli.main(["run", str(tmp_path / "X.bin"), "--rank", "4", "--init", "random",
                   "--seed", "3", "--out-of-core", "--block-n", "300", "--device", "cpu",
                   "--max-iter", "20", "-q", "-o", str(tmp_path / "W.bin"), str(tmp_path / "H.bin")])
    assert rc == 0
    from nmf_tpu.models.init import random_init
    from nmf_tpu.models.streaming import solve_out_of_core

    x = jbin.read_matrix(tmp_path / "X.bin")
    w0, h0 = random_init(96, 4, 1000, seed=3)
    ref = solve_out_of_core(x, w0, h0, jt.SolveConfig(max_iter=20), block_n=300)
    np.testing.assert_allclose(jbin.read_matrix(tmp_path / "W.bin"), np.asarray(ref.w),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize(
    "flags,msg",
    [
        (["--strict-compat"], "requires the in-memory solver; drop --out-of-core"),
        (["--rank", "3"], "--out-of-core init must be 'random'"),
        (["--checkpoint-dir", "ck"], "--checkpoint-dir (ROADMAP.md Queue 1 item 13"),
        (["--freeze", "2"], "--freeze (ROADMAP.md Queue 1 item 8"),
    ],
)
def test_out_of_core_refusals_exit_2(tmp_path, capsys, flags, msg):
    """The JAX CLI's --out-of-core messages, and the flags still refused.
    ``--freeze 2``, refused when this test was named, is ported: it streams
    through both CLIs (:func:`_ooc_both_clis`); so is ``--checkpoint-dir``
    (:func:`_ckpt_both_clis`)."""
    if flags[0] == "--checkpoint-dir":
        _ckpt_both_clis(tmp_path, ["--out-of-core", "--block-n", "8"])
        return
    if flags[0] == "--freeze":
        _ooc_both_clis(tmp_path, flags)
        return
    _write_problem(tmp_path)
    rc = cli.main(["run", str(tmp_path / "X.bin"), "--out-of-core", "--device", "cpu", *flags])
    assert rc == 2
    assert msg in capsys.readouterr().err


def test_block_n_without_out_of_core_is_ignored(tmp_path):
    """As in the JAX CLI, ``--block-n`` alone leaves the in-memory run as it
    is: the same files, byte for byte."""
    _write_problem(tmp_path)
    files = [str(tmp_path / f"{s}.bin") for s in "XWH"]
    for tag, extra in (("a", []), ("b", ["--block-n", "64"])):
        assert cli.main(["run", *files, "--device", "cpu", "--max-iter", "5", "-q", *extra,
                         "-o", str(tmp_path / f"W{tag}.bin"), str(tmp_path / f"H{tag}.bin")]) == 0
    for f in "WH":
        assert (tmp_path / f"{f}a.bin").read_bytes() == (tmp_path / f"{f}b.bin").read_bytes()


def test_every_jax_run_flag_is_known():
    """Each flag of the JAX CLI's run is either supported or refused."""
    from nmf_tpu.cli import build_parser as jax_parser

    def run_flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {o for a in sub.choices["run"]._actions for o in a.option_strings}

    ours = run_flags(cli.build_parser())
    assert run_flags(jax_parser()) <= ours
    assert "--device" in ours


def test_rank_without_random_init_exits_2(tmp_path, capsys):
    """``run X.bin --rank 2`` with no ``--init``, refused when this test was
    named, runs at the JAX CLI's default ``--init nndsvda`` through both
    CLIs and writes the same bytes: the inits are byte-equal
    (tests/test_torch_init.py), and on this X (all ones, whose rank-2
    NNDSVDa start is exact) every f32 sum of both packages agrees."""
    x = np.ones((6, 5), np.float32)
    jbin.write_matrix(x, tmp_path / "X.bin")
    args = ["run", str(tmp_path / "X.bin"), "--rank", "2", "-q"]
    out = {tag: [str(tmp_path / f"{f}{tag}.bin") for f in "WH"] for tag in "pj"}
    assert cli.main([*args, "-o", *out["p"], "--device", "cpu"]) == 0
    assert _jax_cli([*args, "-o", *out["j"]], tmp_path) == 0
    assert capsys.readouterr().err == ""
    for f in "WH":
        assert (tmp_path / f"{f}p.bin").read_bytes() == (tmp_path / f"{f}j.bin").read_bytes()
    assert jbin.read_matrix(tmp_path / "Wp.bin").shape == (6, 2)


@pytest.mark.parametrize("init", ["random", "scaled", "nndsvd", "nndsvda", "nndsvdar"])
def test_rank_init_matches_jax_cli(tmp_path, init):
    """``run X.bin --rank 4 --init ...`` through both CLIs: the same init
    (byte-equal in process), then files within rtol 1e-4 / atol 1e-6, as
    test_gen_then_run_matches_jax holds them."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    args = ["run", str(tmp_path / "X.bin"), "--rank", "4", "--init", init, "--seed", "5",
            "--max-iter", "50", "-q"]
    out = {tag: [str(tmp_path / f"{f}{tag}.bin") for f in "WH"] for tag in "pj"}
    assert cli.main([*args, "-o", *out["p"], "--device", "cpu"]) == 0
    assert _jax_cli([*args, "-o", *out["j"]], tmp_path) == 0
    for f in "WH":
        np.testing.assert_allclose(jbin.read_matrix(tmp_path / f"{f}p.bin"),
                                   jbin.read_matrix(tmp_path / f"{f}j.bin"), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flags", [["--accelerate"], ["--accelerate", "--thresh", "1e-4"],
                                   ["--accelerate", "--x-dtype", "int8"], ["--strict-compat"],
                                   ["--strict-compat", "--no-cost"]])
def test_ported_solver_flags_match_jax_cli(tmp_path, flags):
    """``--accelerate`` (in memory) and ``--strict-compat`` through both
    CLIs on the same files: iterations and checks equal, files within rtol
    1e-4 / atol 1e-6, the final cost within 1e-5."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = [str(tmp_path / f"{s}.bin") for s in "XWH"]
    common = ["--max-iter", "60", "--check-every", "10", "-q", *flags]
    assert cli.main(["run", *files, "-o", str(tmp_path / "Wp.bin"), str(tmp_path / "Hp.bin"),
                     "--device", "cpu", "--jsonl", str(tmp_path / "port.jsonl"), *common]) == 0
    assert _jax_cli(["run", *files, "-o", "Wj.bin", "Hj.bin", "--jsonl", "jax.jsonl", *common],
                    tmp_path) == 0
    for f in "WH":
        np.testing.assert_allclose(jbin.read_matrix(tmp_path / f"{f}p.bin"),
                                   jbin.read_matrix(tmp_path / f"{f}j.bin"), rtol=1e-4, atol=1e-6)
    ours, ref = (json.loads((tmp_path / f"{s}.jsonl").read_text().splitlines()[-1])
                 for s in ("port", "jax"))
    assert ours["iterations"] == ref["iterations"]
    assert [c["iteration"] for c in ours["checks"]] == [c["iteration"] for c in ref["checks"]]
    if ref["final_cost"] is None:
        assert ours["final_cost"] is None
    else:
        assert ours["final_cost"] == pytest.approx(ref["final_cost"], rel=1e-5)


def test_strict_compat_with_accelerate_exits_2_like_jax(tmp_path, capsys):
    """strict mode replays one algorithm: both CLIs exit 2 with the same message."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = [str(tmp_path / f"{s}.bin") for s in "XWH"]
    assert cli.main(["run", *files, "--device", "cpu", "--strict-compat", "--accelerate"]) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(["run", *files, "--strict-compat", "--accelerate"], tmp_path) == 2
    assert ours == capsys.readouterr().err and "replicates" in ours


def test_strict_compat_files_are_depadded_and_repeatable(tmp_path):
    """The logical shapes, bit for bit on a rerun."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = [str(tmp_path / f"{s}.bin") for s in "XWH"]
    for tag in "ab":
        assert cli.main(["run", *files, "--device", "cpu", "--strict-compat", "--max-iter", "20",
                         "-q", "-o", str(tmp_path / f"W{tag}.bin"), str(tmp_path / f"H{tag}.bin")]) == 0
    assert jbin.read_matrix(tmp_path / "Wa.bin").shape == (40, 4)
    assert jbin.read_matrix(tmp_path / "Ha.bin").shape == (4, 30)
    for f in "WH":
        assert (tmp_path / f"{f}a.bin").read_bytes() == (tmp_path / f"{f}b.bin").read_bytes()


@pytest.mark.parametrize("block_n", ["256", "384"])
def test_out_of_core_accelerate_matches_jax_cli(tmp_path, block_n):
    """``run --out-of-core --accelerate`` through both CLIs: the costs agree
    to 1e-5, the files to rtol 1e-3 / atol 1e-6 after 30 iterations.  The
    plain streamed files agree to 1e-5 (test_out_of_core_run_matches_jax_cli);
    each extrapolation scales a difference by up to 1 + momentum, so the
    blockwise summation-order drift grows: measured 2.3e-4 on one entry of
    12000."""
    _write_problem(tmp_path)
    common = ["X.bin", "W.bin", "H.bin", "--out-of-core", "--block-n", block_n, "--accelerate",
              "--max-iter", "30", "--check-every", "10", "-q"]
    run = _port("run", *common, "-o", "Wp.bin", "Hp.bin", "--device", "cpu",
                "--jsonl", "port.jsonl", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    assert _jax_cli(["run", *common, "-o", "Wj.bin", "Hj.bin", "--jsonl", "jax.jsonl"],
                    tmp_path) == 0
    for f in "WH":
        np.testing.assert_allclose(jbin.read_matrix(tmp_path / f"{f}p.bin"),
                                   jbin.read_matrix(tmp_path / f"{f}j.bin"), rtol=1e-3, atol=1e-6)
    ours, ref = (json.loads((tmp_path / f"{s}.jsonl").read_text().splitlines()[-1])
                 for s in ("port", "jax"))
    assert ours["iterations"] == ref["iterations"] == 30
    assert [c["iteration"] for c in ours["checks"]] == [10, 20, 30]
    assert ours["final_cost"] == pytest.approx(ref["final_cost"], rel=1e-5)


def test_lone_init_file_exits_2(tmp_path, capsys):
    jbin.write_matrix(np.ones((6, 5), np.float32), tmp_path / "X.bin")
    jbin.write_matrix(np.ones((6, 2), np.float32), tmp_path / "W.bin")
    rc = cli.main(["run", str(tmp_path / "X.bin"), str(tmp_path / "W.bin"), "--device", "cpu"])
    assert rc == 2
    assert "BOTH" in capsys.readouterr().err


def test_missing_input_exits_2(tmp_path, capsys):
    rc = cli.main(["run", str(tmp_path / "nope.bin"), "--rank", "2", "--init", "random",
                   "--device", "cpu"])
    assert rc == 2
    assert "file not found" in capsys.readouterr().err


def test_cuda_run_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["run", str(tmp_path / "X.bin"), str(tmp_path / "W.bin"),
                  str(tmp_path / "H.bin")])


def test_info_prints_shapes(tmp_path, capsys):
    jbin.write_matrix(np.full((3, 7), 2.0, np.float32), tmp_path / "A.bin")
    assert cli.main(["info", str(tmp_path / "A.bin")]) == 0
    out = capsys.readouterr().out
    assert "3x7 f32" in out and "mean 2" in out


def test_gen_writes_reference_fixtures(tmp_path, capsys):
    assert cli.main(["gen", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["H.bin", "W.bin", "X.bin"]
    assert (tmp_path / "X.bin").stat().st_size == 8 + 4096 * 350 * 4


def test_import_loads_no_jax():
    code = (
        "import sys, nmf_tpu_torch, nmf_tpu_torch.cli, nmf_tpu_torch.utils.convert, "
        "nmf_tpu_torch.utils.metrics, nmf_tpu_torch.ops.kernels.fused_mu, "
        "nmf_tpu_torch.ops.kernels.tile_sparse, nmf_tpu_torch.models.sparse_tiled, "
        "nmf_tpu_torch.models.streaming, nmf_tpu_torch.models.strict, "
        "nmf_tpu_torch.models.init, nmf_tpu_torch.ops.kernels._build, "
        "nmf_tpu_torch.models.nmf, nmf_tpu_torch.ops.hals\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nmf_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_import_jax_or_the_jax_package():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|nmf_tpu)(\.|\s|,|$)")
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py", REPO / "tests" / "torch_mesh_ranks.py",
                 REPO / "tests" / "torch_serving_ranks.py"]:
        for line in path.read_text().splitlines():
            assert not banned.match(line), f"{path}: {line}"


def test_kernel_path_has_no_fallback_handler():
    """No ``except`` on the CUDA path: a failed build or launch raises."""
    for rel in ("ops/kernels/fused_mu.py", "ops/kernels/tile_sparse.py", "ops/kernels/_build.py",
                "models/solver.py", "models/sparse_tiled.py", "models/streaming.py",
                "models/nmf.py", "models/semi.py", "models/masked.py", "models/online.py",
                "models/separation.py", "parallel/sharded.py"):
        src = (PKG / rel).read_text()
        assert "except" not in src, rel


@pytest.mark.parametrize(
    "flags,msg",
    [
        (["--out-of-core", "--beta", "2"], "--beta with --out-of-core (ROADMAP.md Queue 1 step 6"),
        (["--out-of-core", "--algorithm", "hals", "--beta", "2"],
         "--algorithm with --out-of-core (ROADMAP.md Queue 1 step 6"),
        (["--out-of-core", "--l1-h", "0.1"], "--l1-h with --out-of-core (ROADMAP.md Queue 1 step 6"),
    ],
)
def test_streamed_families_exit_2(tmp_path, capsys, flags, msg):
    """The families stream: refused when this test was named, ``--out-of-core``
    with ``--beta 2``, ``--algorithm hals`` and ``--l1-h`` runs through both
    CLIs on the same files (:func:`_ooc_both_clis`)."""
    _ooc_both_clis(tmp_path, flags[1:], hals="hals" in flags)


@pytest.mark.parametrize("flags", [["--beta", "2"], ["--algorithm", "hals", "--beta", "2"],
                                   ["--l1-h", "0.1"]])
def test_strict_compat_with_a_family_exits_2_like_jax(tmp_path, capsys, flags):
    """strict mode replays the KL MU alone: both CLIs exit 2 with
    solve_strict's message."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = [str(tmp_path / f"{s}.bin") for s in "XWH"]
    assert cli.main(["run", *files, "--device", "cpu", "--strict-compat", *flags]) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(["run", *files, "--strict-compat", *flags], tmp_path) == 2
    assert ours == capsys.readouterr().err and "replicates" in ours


@pytest.mark.parametrize(
    "flags",
    [["--beta", "0"], ["--beta", "0.5", "--dtype", "bfloat16"], ["--l1-w", "0.1", "--l2-h", "0.2"],
     ["--algorithm", "hals", "--beta", "2", "--accelerate"], ["--beta", "3", "--x-dtype", "int8"]],
)
def test_families_match_jax_cli(tmp_path, flags):
    """The in-memory families through both CLIs: files within rtol 1e-4 /
    atol 1e-6 (accelerated HALS: relative Frobenius norm 1e-4, as its
    clipped coordinate steps carry last-ulp differences further, measured
    1.9e-5 after 40 iterations), iterations and checks equal, the final cost
    within 1e-5."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = [str(tmp_path / f"{s}.bin") for s in "XWH"]
    common = ["--max-iter", "40", "--check-every", "10", "-q", *flags]
    assert cli.main(["run", *files, "-o", str(tmp_path / "Wp.bin"), str(tmp_path / "Hp.bin"),
                     "--device", "cpu", "--jsonl", str(tmp_path / "port.jsonl"), *common]) == 0
    assert _jax_cli(["run", *files, "-o", "Wj.bin", "Hj.bin", "--jsonl", "jax.jsonl", *common],
                    tmp_path) == 0
    for f in "WH":
        ours, ref = (jbin.read_matrix(tmp_path / f"{f}{t}.bin") for t in "pj")
        if "--accelerate" in flags:
            assert np.linalg.norm(ours - ref) <= 1e-4 * np.linalg.norm(ref), f
        else:
            np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
    ours, ref = (json.loads((tmp_path / f"{s}.jsonl").read_text().splitlines()[-1])
                 for s in ("port", "jax"))
    assert ours["iterations"] == ref["iterations"] == 40
    assert [c["iteration"] for c in ours["checks"]] == [c["iteration"] for c in ref["checks"]]
    assert ours["final_cost"] == pytest.approx(ref["final_cost"], rel=1e-5)


@pytest.mark.parametrize(
    "flags",
    [[], ["--h0", "H.bin"], ["--seed", "7", "--thresh", "1e-3", "--check-every", "5"],
     ["--beta", "2", "--algorithm", "hals"], ["--l1-h", "0.2"], ["--x-dtype", "int8"],
     ["--out-of-core", "--block-n", "7"], ["--out-of-core", "--block-n", "12", "--h0", "H.bin"],
     ["--out-of-core", "--block-n", "16", "--beta", "0.5"],
     ["--out-of-core", "--block-n", "8", "--x-dtype", "bfloat16"]],
)
def test_transform_matches_jax_cli(tmp_path, flags):
    """``transform X W -o H`` through both CLIs, in memory and
    ``--out-of-core`` (ragged last blocks): without ``--h0`` both draw the
    start from ``RandomState(seed)`` (per block: ``seed + i``), so the files
    agree to rtol 1e-4 / atol 1e-6."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    common = ["X.bin", "W.bin", "--max-iter", "40", "-q", *flags]
    run = _port("transform", *common, "-o", "Hp.bin", "--device", "cpu", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    assert _jax_cli(["transform", *common, "-o", "Hj.bin"], tmp_path) == 0
    ours, ref = (jbin.read_matrix(tmp_path / f"H{t}.bin") for t in "pj")
    assert ours.shape == ref.shape == (4, 30)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "flags,msg",
    [
        (["--mask", "X.bin"], "--mask (ROADMAP.md Queue 1 step 6"),
        (["--mesh", "2x1"], "--mesh 2x1 needs 2 ranks and the world has 1: launch it with "
                            "python -m torch.distributed.run --nproc-per-node 2"),
        (["--validate"], "--validate (ROADMAP.md Queue 1 step 9"),
        (["--live"], "--live (ROADMAP.md Queue 1 step 9"),
        (["--backend", "autotune"], "--backend autotune (ROADMAP.md Queue 1 step 11"),
        (["--checkpoint-dir", "ck"], "transform does not checkpoint"),
        (["--strict-compat"], "--strict-compat is a full-solve replication mode (use 'run')"),
    ],
)
def test_transform_refusals_exit_2(tmp_path, capsys, flags, msg):
    """transform's flags not in the port, and the two the JAX CLI refuses
    with its own message, exit 2 before any input is read.  ``--mesh``,
    refused when this test was named, is ported (tests/test_torch_mesh.py):
    without a launcher a 2x1 mesh exits 2 naming it.  ``--mask``,
    refused when this test was named, is ported: ``transform --mask`` runs
    through both CLIs (:func:`_transform_mask_both_clis`); so do
    ``--validate`` and ``--live``, each leaving the file as it is without
    the flag, and ``--backend autotune`` (on the CPU: no measurement, the
    bits of ``auto``)."""
    if flags[0] == "--mask":
        _transform_mask_both_clis(tmp_path, [])
        return
    if flags[0] in ("--validate", "--live", "--backend"):
        _write_problem(tmp_path, 40, 4, 30, 2)
        common = ["transform", "X.bin", "W.bin", "--max-iter", "30", "-q"]
        assert _port_cli([*common, "-o", "Hp.bin", *flags], tmp_path) == 0
        assert _jax_cli([*common, "-o", "Hj.bin", *flags], tmp_path) == 0
        _assert_files_close(tmp_path, "H")
        assert _port_cli([*common, "-o", "Hq.bin"], tmp_path) == 0
        assert (tmp_path / "Hp.bin").read_bytes() == (tmp_path / "Hq.bin").read_bytes()
        return
    rc = cli.main(["transform", str(tmp_path / "X.bin"), "W.bin", "--device", "cpu", *flags])
    assert rc == 2
    err = capsys.readouterr().err
    assert msg in err and "file not found" not in err


def test_every_jax_transform_flag_is_known():
    """Each flag of the JAX CLI's transform is either supported or refused."""
    from nmf_tpu.cli import build_parser as jax_parser

    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {o for a in sub.choices["transform"]._actions for o in a.option_strings}

    assert flags(jax_parser()) <= flags(cli.build_parser())


# --- Queue 1 step 6: --mask, --freeze, --online*, the streamed families,
# transform --mask and separate, through both CLIs on the same files.  The
# files agree to rtol 1e-4 / atol 1e-6 (test_gen_then_run_matches_jax's);
# HALS and the int16 WAVs as stated where they are compared.


def _port_cli(args, cwd):
    """The port's CLI in-process from ``cwd`` (so both CLIs take the same
    relative paths), on the CPU."""
    here = os.getcwd()
    os.chdir(cwd)
    try:
        return cli.main([*args, "--device", "cpu"])
    finally:
        os.chdir(here)


def _assert_files_close(tmp_path, names, hals=False):
    for name in names:
        ours, ref = (jbin.read_matrix(tmp_path / f"{name}{t}.bin") for t in "pj")
        assert ours.shape == ref.shape, name
        if hals:
            assert np.linalg.norm(ours - ref) <= 1e-4 * np.linalg.norm(ref), name
        else:
            np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6, err_msg=name)


def _write_mask(tmp_path, nan_x=True, seed=5):
    """M.bin, a 0/1 mask of X.bin's shape (80% observed); with ``nan_x``
    the unobserved entries of X.bin become NaN, which both CLIs must ignore."""
    x = jbin.read_matrix(tmp_path / "X.bin")
    mask = (np.random.RandomState(seed).rand(*x.shape) > 0.2).astype(np.float32)
    if nan_x:
        x[mask == 0] = np.nan
        jbin.write_matrix(x, tmp_path / "X.bin")
    jbin.write_matrix(mask, tmp_path / "M.bin")
    return mask


def _both_run(tmp_path, args, hals=False):
    common = [*args, "--max-iter", "20", "--check-every", "10", "-q"]
    assert _port_cli(["run", *common, "-o", "Wp.bin", "Hp.bin"], tmp_path) == 0
    assert _jax_cli(["run", *common, "-o", "Wj.bin", "Hj.bin"], tmp_path) == 0
    _assert_files_close(tmp_path, "WH", hals=hals)


def _ooc_both_clis(tmp_path, flags, hals=False):
    """``run --out-of-core --block-n 8`` (ragged last block) with ``flags``
    through both CLIs on a 40 x 30, K=4 problem."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    _both_run(tmp_path, ["X.bin", "W.bin", "H.bin", "--out-of-core", "--block-n", "8", *flags],
              hals=hals)


def _online_both_clis(tmp_path, flags):
    """``run X.bin --rank 4 --init random --online`` with ``flags`` through
    both CLIs: W learned online, H by the streamed transform."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    _both_run(tmp_path, ["X.bin", "--rank", "4", "--init", "random", "--online",
                         "--block-n", "8", *flags])


def _transform_mask_both_clis(tmp_path, flags):
    _write_problem(tmp_path, 40, 4, 30, 2)
    _write_mask(tmp_path)
    common = ["transform", "X.bin", "W.bin", "--mask", "M.bin", "--max-iter", "30", "-q", *flags]
    assert _port_cli([*common, "-o", "Hp.bin"], tmp_path) == 0
    assert _jax_cli([*common, "-o", "Hj.bin"], tmp_path) == 0
    _assert_files_close(tmp_path, "H")


@pytest.mark.parametrize("where", [[], ["--out-of-core", "--block-n", "8"]],
                         ids=["in_memory", "out_of_core"])
@pytest.mark.parametrize("flags", [[], ["--l1-h", "0.1", "--l2-w", "0.2"], ["--x-dtype", "bfloat16"]],
                         ids=["kl", "penalized", "bf16_x"])
def test_run_mask_matches_jax_cli(tmp_path, where, flags):
    """``run --mask`` (NaN in the unobserved entries of X) in memory and
    streamed, through both CLIs: the same files to rtol 1e-4 / atol 1e-6,
    all finite."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    _write_mask(tmp_path)
    _both_run(tmp_path, ["X.bin", "W.bin", "H.bin", "--mask", "M.bin", *where, *flags])
    for f in "WH":
        assert np.isfinite(jbin.read_matrix(tmp_path / f"{f}p.bin")).all()


def test_run_mask_file_is_the_in_process_solve_bytes(tmp_path):
    """The CLI's files are ``solve_masked``'s factors byte for byte."""
    import nmf_tpu_torch as nt

    _write_problem(tmp_path, 40, 4, 30, 2)
    mask = _write_mask(tmp_path)
    assert _port_cli(["run", "X.bin", "W.bin", "H.bin", "--mask", "M.bin", "--max-iter", "20",
                      "-q", "-o", "Wp.bin", "Hp.bin"], tmp_path) == 0
    x, w, h = (jbin.read_matrix(tmp_path / f"{s}.bin") for s in "XWH")
    res = nt.solve_masked(x, w, h, mask, nt.SolveConfig(max_iter=20), device="cpu")
    for f in "WH":
        assert (jbin.read_matrix(tmp_path / f"{f}p.bin").tobytes()
                == getattr(res, f.lower()).numpy().tobytes()), f


@pytest.mark.parametrize(
    "flags,msg",
    [(["--mask", "M.bin", "--freeze", "2"], "--freeze is not implemented for masked solves"),
     (["--mask", "M.bin", "--strict-compat"], "--mask runs the masked solver"),
     (["--freeze", "2", "--strict-compat"], "--freeze composes with the plain"),
     (["--mask", "W.bin"], "mask shape (40, 4) != X shape (40, 30)")],
)
def test_mask_and_freeze_refusals_match_jax_cli(tmp_path, capsys, flags, msg):
    """The combinations the JAX CLI refuses exit 2 in both CLIs with the same
    message."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    _write_mask(tmp_path, nan_x=False)
    args = ["run", "X.bin", "W.bin", "H.bin", "--max-iter", "2", "-q", *flags]
    assert _port_cli(args, tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(args, tmp_path) == 2
    assert msg in ours and ours == capsys.readouterr().err


@pytest.mark.parametrize("where", [[], ["--out-of-core", "--block-n", "8"]],
                         ids=["in_memory", "out_of_core"])
@pytest.mark.parametrize("flags", [[], ["--beta", "2"], ["--accelerate"]],
                         ids=["kl", "beta2", "accelerate"])
def test_run_freeze_matches_jax_cli(tmp_path, where, flags):
    """``run --freeze 2`` in memory and streamed through both CLIs: the same
    files, and the two frozen columns of W are W.bin's, bit for bit."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    _both_run(tmp_path, ["X.bin", "W.bin", "H.bin", "--freeze", "2", *where, *flags])
    w0, w_out = (jbin.read_matrix(tmp_path / f) for f in ("W.bin", "Wp.bin"))
    assert w_out[:, :2].tobytes() == np.ascontiguousarray(w0[:, :2]).tobytes()
    assert not np.array_equal(w_out[:, 2:], w0[:, 2:])


@pytest.mark.parametrize(
    "flags",
    [[], ["--online-passes", "2", "--online-rho", "0.9"], ["--online-inner-iters", "5"],
     ["--x-dtype", "bfloat16"], ["--x-dtype", "int8"], ["--no-cost"]],
    ids=["default", "passes_rho", "inner", "bf16_x", "int8_x", "no_cost"],
)
def test_run_online_matches_jax_cli(tmp_path, flags):
    """``run --online`` through both CLIs: W learned in one pass (or two),
    H from the streamed transform, the same files."""
    _online_both_clis(tmp_path, flags)


def test_run_online_from_a_w_file_and_its_jsonl(tmp_path):
    """``--online`` from a W init file, and the free-form JSONL record both
    CLIs write (pass cost sums and the transform cost within 1e-5)."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    common = ["run", "X.bin", "W.bin", "--online", "--block-n", "8", "--max-iter", "20", "-q"]
    assert _port_cli([*common, "-o", "Wp.bin", "Hp.bin", "--jsonl", "p.jsonl"], tmp_path) == 0
    assert _jax_cli([*common, "-o", "Wj.bin", "Hj.bin", "--jsonl", "j.jsonl"], tmp_path) == 0
    _assert_files_close(tmp_path, "WH")
    ours, ref = (json.loads((tmp_path / f"{t}.jsonl").read_text().splitlines()[-1]) for t in "pj")
    assert ours["mode"] == ref["mode"] == "online"
    assert (ours["shape"], ours["rank"], ours["passes"], ours["blocks"]) == (
        ref["shape"], ref["rank"], ref["passes"], ref["blocks"])
    np.testing.assert_allclose(ours["pass_cost_sums"], ref["pass_cost_sums"], rtol=1e-5)
    assert ours["transform_cost"] == pytest.approx(ref["transform_cost"], rel=1e-5)


@pytest.mark.parametrize(
    "flags",
    [["--out-of-core"], ["--strict-compat"], ["--freeze", "1"], ["--mask", "X.bin"],
     ["--online-rho", "0"], ["--online-passes", "0"], ["--init", "nndsvda"], ["W.bin", "H.bin"]],
)
def test_run_online_refusals_match_jax_cli(tmp_path, capsys, flags):
    """What the JAX CLI refuses of ``--online`` exits 2 in both CLIs with the
    same message."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = flags if flags[0] == "W.bin" else []
    flags = [] if files else flags
    args = ["run", "X.bin", *files, "--rank", "4", "--online", "-q", *flags]
    if "--init" not in flags:
        args += ["--init", "random"]
    assert _port_cli(args, tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(args, tmp_path) == 2
    assert ours.startswith("error: ") and ours == capsys.readouterr().err


@pytest.mark.parametrize("flags", [[], ["--l1-h", "0.1"], ["--x-dtype", "bfloat16"], ["--h0", "H.bin"]],
                         ids=["kl", "l1_h", "bf16_x", "h0"])
def test_transform_mask_matches_jax_cli(tmp_path, flags):
    """``transform --mask`` in memory through both CLIs: the same H."""
    _transform_mask_both_clis(tmp_path, flags)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_transform_mask_out_of_core_matches_jax(tmp_path, x_dtype):
    """``transform --mask --out-of-core`` streams the mask beside X (the JAX
    CLI refuses the pair; its library streams it): H equals
    ``nmf_tpu.transform_out_of_core(mask=...)``'s to rtol 1e-4 / atol 1e-6."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    _write_mask(tmp_path)
    assert _port_cli(["transform", "X.bin", "W.bin", "--mask", "M.bin", "--out-of-core",
                      "--block-n", "8", "--max-iter", "30", "--x-dtype", x_dtype, "-q",
                      "-o", "Hp.bin"], tmp_path) == 0
    ref = jt.transform_out_of_core(
        str(tmp_path / "X.bin"), jbin.read_matrix(tmp_path / "W.bin"),
        config=jt.SolveConfig(max_iter=30, precision=jt.Precision(x_dtype=x_dtype)),
        block_n=8, mask=str(tmp_path / "M.bin"))
    np.testing.assert_allclose(jbin.read_matrix(tmp_path / "Hp.bin"), ref.h, rtol=1e-4, atol=1e-6)


def _write_wav(path, kind="int16", seed=0, seconds=0.5, rate=8000):
    """A two-tone clip with noise, as a WAV of ``kind`` samples (stereo for
    "stereo16")."""
    from scipy.io import wavfile

    t = np.arange(int(seconds * rate)) / rate
    rng = np.random.RandomState(seed)
    a = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 1250 * t) * (t > seconds / 2)
    a = (a + 0.05 * rng.randn(t.size)).clip(-1, 1)
    if kind == "uint8":
        data = ((a + 1) * 127.5).astype(np.uint8)
    elif kind == "float32":
        data = a.astype(np.float32)
    elif kind == "stereo16":
        data = (np.stack([a, 0.5 * a], axis=1) * 32767).astype(np.int16)
    else:
        data = (a * 32767).astype(np.int16)
    wavfile.write(path, rate, data)


def _read_sources(d):
    from scipy.io import wavfile

    files = sorted(os.listdir(d))
    return files, np.stack([wavfile.read(os.path.join(d, f))[1] for f in files])


@pytest.mark.parametrize("kind", ["int16", "uint8", "float32", "stereo16"])
def test_separate_matches_jax_cli(tmp_path, kind):
    """``separate clip.wav`` through both CLIs: the same ``source_%03d.wav``
    files, int16 samples within 4 steps of each other (the sources within
    1e-4 of the peak, which the files scale to 32767), and the port's files
    byte-equal to its in-process ``separate`` written by ``write_sources``."""
    import nmf_tpu_torch as nt

    _write_wav(tmp_path / "clip.wav", kind)
    common = ["separate", "clip.wav", "--rank", "4", "--n-fft", "256", "--hop", "64",
              "--max-iter", "50", "-q"]
    assert _port_cli([*common, "--out-dir", "sp"], tmp_path) == 0
    assert _jax_cli([*common, "--out-dir", "sj"], tmp_path) == 0
    files, ours = _read_sources(tmp_path / "sp")
    ref_files, ref = _read_sources(tmp_path / "sj")
    assert files == ref_files == [f"source_{i:03d}.wav" for i in range(4)]
    assert ours.dtype == np.int16 and ours.shape == ref.shape
    assert np.abs(ours.astype(np.int32) - ref).max() <= 4
    rate, audio = cli._read_wav(str(tmp_path / "clip.wav"))
    res = nt.separate(audio, n_components=4, n_fft=256, hop=64,
                      config=nt.SolveConfig(max_iter=50, thresh=1e-5), device="cpu")
    cli.write_sources(res.sources, rate, str(tmp_path / "inproc"))
    for f in files:
        assert (tmp_path / "sp" / f).read_bytes() == (tmp_path / "inproc" / f).read_bytes(), f


@pytest.mark.parametrize(
    "flags,msg",
    [(["--out-of-core"], "--out-of-core does not apply to 'separate'"),
     (["--block-n", "8"], "--block-n does not apply to 'separate'"),
     (["--strict-compat"], "--strict-compat does not apply to 'separate'"),
     (["--checkpoint-dir", "ck"], "--checkpoint-dir does not apply to 'separate'"),
     (["--mesh", "2x1"], "--mesh does not apply to 'separate'")],
)
def test_separate_refusals_match_jax_cli(tmp_path, capsys, flags, msg):
    """The flags that do not apply to ``separate`` exit 2 in both CLIs with
    the JAX CLI's message, before the WAV is read."""
    args = ["separate", "missing.wav", "-q", *flags]
    assert _port_cli(args, tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(args, tmp_path) == 2
    assert msg in ours and ours == capsys.readouterr().err


def test_separate_restarts_still_refused(tmp_path, capsys):
    """``--restarts 2``, refused when this test was named, is ported: the
    port's files are byte-equal to its in-process ``separate(n_restarts=2)``
    and within 4 int16 steps of the JAX CLI's."""
    import nmf_tpu_torch as nt

    _write_wav(tmp_path / "clip.wav")
    common = ["separate", "clip.wav", "--rank", "4", "--n-fft", "256", "--hop", "64",
              "--max-iter", "30", "--restarts", "2", "-q"]
    assert _port_cli([*common, "--out-dir", "sp"], tmp_path) == 0
    assert capsys.readouterr().err == ""
    assert _jax_cli([*common, "--out-dir", "sj"], tmp_path) == 0
    files, ours = _read_sources(tmp_path / "sp")
    ref_files, ref = _read_sources(tmp_path / "sj")
    assert files == ref_files and np.abs(ours.astype(np.int32) - ref).max() <= 4
    rate, audio = cli._read_wav(str(tmp_path / "clip.wav"))
    res = nt.separate(audio, n_components=4, n_fft=256, hop=64, n_restarts=2,
                      config=nt.SolveConfig(max_iter=30, thresh=1e-5), device="cpu")
    cli.write_sources(res.sources, rate, str(tmp_path / "inproc"))
    for f in files:
        assert (tmp_path / "sp" / f).read_bytes() == (tmp_path / "inproc" / f).read_bytes(), f


def test_every_jax_separate_flag_is_known():
    """Each flag of the JAX CLI's separate is in the port's."""
    from nmf_tpu.cli import build_parser as jax_parser

    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {o for a in sub.choices["separate"]._actions for o in a.option_strings}

    assert flags(jax_parser()) <= flags(cli.build_parser())


# --- Queue 1 step 7: run --restarts, select and batch, through both CLIs
# on the same files.  The port's files are byte-equal to its in-process
# solve (one torch thread in both); against the JAX CLI's, rtol 5e-5 /
# atol 1e-7 (tests/test_torch_batched.py's F32).


def _write_x(tmp_path, m=48, n=40, seed=0):
    x = np.random.RandomState(seed).rand(m, n).astype(np.float32)
    jbin.write_matrix(x, tmp_path / "X.bin")
    return x


def _close_files(a, b):
    np.testing.assert_allclose(jbin.read_matrix(a), jbin.read_matrix(b), rtol=5e-5, atol=1e-7)


@pytest.mark.parametrize("init", ["random", "scaled", "nndsvda"])
def test_run_restarts_matches_jax_cli(tmp_path, capsys, init):
    """``run X.bin --rank 4 --restarts 3``: the lowest-cost member written,
    the same member as the JAX CLI keeps; a deterministic init is replaced
    by 'scaled' with the JAX CLI's notice."""
    import nmf_tpu_torch as nt

    x = _write_x(tmp_path)
    common = ["run", "X.bin", "--rank", "4", "--restarts", "3", "--init", init, "--seed", "2",
              "--max-iter", "20", "--check-every", "5"]
    assert _port_cli([*common, "-o", "Wp.bin", "Hp.bin"], tmp_path) == 0
    ours = capsys.readouterr().err
    assert _jax_cli([*common, "-o", "Wj.bin", "Hj.bin"], tmp_path) == 0
    ref = capsys.readouterr().err
    kept = [line for line in ours.splitlines() if "restarts (seeds" in line]
    assert len(kept) == 1 and kept[0].split("kept")[1] in ref
    assert ("deterministic" in ours) == ("deterministic" in ref) == (init == "nndsvda")
    for f in "WH":
        _close_files(tmp_path / f"{f}p.bin", tmp_path / f"{f}j.bin")
    sel = nt.solve_restarts(x, rank=4, n_restarts=3, seed=2, device="cpu",
                            init="scaled" if init == "nndsvda" else init,
                            config=nt.SolveConfig(max_iter=20, check_every=5))
    w, h = sel.best
    assert jbin.read_matrix(tmp_path / "Wp.bin").tobytes() == w.numpy().tobytes()
    assert jbin.read_matrix(tmp_path / "Hp.bin").tobytes() == h.numpy().tobytes()


@pytest.mark.parametrize(
    "flags,files",
    [(["--restarts", "2", "--out-of-core"], False), (["--restarts", "2", "--online"], False),
     (["--restarts", "2"], True), (["--restarts", "2", "--rank", "4", "--freeze", "2"], False),
     (["--restarts", "2", "--rank", "4", "--strict-compat"], False),
     (["--restarts", "2", "--rank", "4", "--mask", "X.bin"], False)],
    ids=["out_of_core", "online", "init_files", "freeze", "strict", "mask"],
)
def test_run_restarts_refusals_match_jax_cli(tmp_path, capsys, flags, files):
    """What ``--restarts`` refuses, with the JAX CLI's exit code and words."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    args = ["run", "X.bin", *(["W.bin", "H.bin"] if files else []), *flags, "-q"]
    assert _port_cli(args, tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(args, tmp_path) == 2
    assert ours == capsys.readouterr().err and "--restarts" in ours


@pytest.mark.parametrize(
    "flags",
    [["--ranks", "2,4,6"], ["--ranks", "2:6:2", "--restarts", "2"],
     ["--ranks", "3,5", "--stability", "--restarts", "3"],
     ["--ranks", "4", "--init", "random"]],
    ids=["list", "range_restarts", "stability", "single_rank"],
)
def test_select_matches_jax_cli(tmp_path, capsys, flags):
    """``select``: the same table and recommendation on stderr and JSONL
    record as the JAX CLI (costs to 1e-5); with a recommended or single
    rank, ``-o`` files byte-equal to the in-process sweep's member and
    within F32 of the JAX CLI's."""
    import json

    import nmf_tpu_torch as nt

    x = _write_x(tmp_path)
    common = ["select", "X.bin", *flags, "--max-iter", "20", "--check-every", "10"]
    writes = "--stability" in flags or flags[1].isdigit()
    out = lambda tag: ["-o", f"W{tag}.bin", f"H{tag}.bin"] if writes else []  # noqa: E731
    assert _port_cli([*common, *out("p"), "--jsonl", "p.jsonl"], tmp_path) == 0
    ours = capsys.readouterr().err
    assert _jax_cli([*common, *out("j"), "--jsonl", "j.jsonl"], tmp_path) == 0
    ref = capsys.readouterr().err
    strip = lambda e: [ln.split()[0] for ln in e.splitlines()]  # noqa: E731
    assert strip(ours) == strip(ref)
    rp, rj = (json.loads((tmp_path / f"{t}.jsonl").read_text()) for t in "pj")
    assert rp["ranks"] == rj["ranks"] and rp["restarts"] == rj["restarts"]
    assert rp["recommended_rank"] == rj["recommended_rank"]
    for k, v in rj["best_cost_per_rank"].items():
        assert rp["best_cost_per_rank"][k] == pytest.approx(v, rel=1e-5)
    if not writes:
        return
    for f in "WH":
        _close_files(tmp_path / f"{f}p.bin", tmp_path / f"{f}j.bin")
    target = rp["recommended_rank"] or rp["ranks"][0]
    cfg = nt.SolveConfig(max_iter=20, check_every=10)
    init = "random" if "random" in flags else "scaled"
    if "--stability" in flags:
        sel = nt.rank_stability(x, rp["ranks"], n_restarts=3, config=cfg, init=init,
                                device="cpu").sweep
    else:
        sel = nt.solve_rank_sweep(x, [target], cfg, init=init, device="cpu")
    at = np.nonzero(sel.ranks == target)[0]
    w, h = sel.factors(int(at[np.argmin(sel.costs[at])]))
    assert jbin.read_matrix(tmp_path / "Wp.bin").tobytes() == w.numpy().tobytes()
    assert jbin.read_matrix(tmp_path / "Hp.bin").tobytes() == h.numpy().tobytes()


@pytest.mark.parametrize(
    "flags",
    [["--ranks", "2,4", "-o", "W.bin", "H.bin"], ["--ranks", "0,2"], ["--ranks", "a:b"],
     ["--ranks", "4", "--out-of-core"], ["--ranks", "4", "--block-n", "8"],
     ["--ranks", "4", "--strict-compat"], ["--ranks", "4", "--restarts", "0"]],
    ids=["o_needs_one_rank", "zero_rank", "bad_spec", "out_of_core", "block_n", "strict",
         "zero_restarts"],
)
def test_select_refusals_match_jax_cli(tmp_path, capsys, flags):
    _write_x(tmp_path)
    args = ["select", "X.bin", *flags, "--max-iter", "2", "-q"]
    assert _port_cli(args, tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(args, tmp_path) == 2
    ref = capsys.readouterr().err
    assert ours.split(":")[:2] == ref.split(":")[:2]


def _write_batch_dir(tmp_path, b=3, m=30, n=20):
    d = tmp_path / "d"
    d.mkdir()
    rng = np.random.RandomState(5)
    xs = [rng.rand(m, n).astype(np.float32) for _ in range(b)]
    for i, x in enumerate(xs):
        jbin.write_matrix(x, d / f"m{i}.bin")
    (d / "notes.txt").write_text("not a matrix")
    return np.stack(xs)


@pytest.mark.parametrize("extra", [[], ["--thresh", "1e-3", "--check-every", "2"],
                                   ["--x-dtype", "int8"]], ids=["plain", "thresh", "int8"])
def test_batch_matches_jax_cli(tmp_path, capsys, extra):
    """``batch d/``: one ``<stem>.W.bin`` / ``<stem>.H.bin`` per matrix, the
    JAX CLI's names and JSONL record, files byte-equal to the in-process
    ``solve_batched`` from the same seeded inits."""
    import json

    import nmf_tpu_torch as nt

    xs = _write_batch_dir(tmp_path)
    common = ["batch", "d", "--rank", "3", "--seed", "4", "--max-iter", "12", *extra, "-q"]
    assert _port_cli([*common, "--out-dir", "bp", "--jsonl", "p.jsonl"], tmp_path) == 0
    assert _jax_cli([*common, "--out-dir", "bj", "--jsonl", "j.jsonl"], tmp_path) == 0
    names = sorted(os.listdir(tmp_path / "bp"))
    assert names == sorted(os.listdir(tmp_path / "bj")) == sorted(
        f"m{i}.{f}.bin" for i in range(3) for f in "WH")
    for name in names:
        _close_files(tmp_path / "bp" / name, tmp_path / "bj" / name)
    rp, rj = (json.loads((tmp_path / f"{t}.jsonl").read_text()) for t in "pj")
    assert {k: rp[k] for k in ("kind", "batch", "shape", "rank", "iterations")} == \
        {k: rj[k] for k in ("kind", "batch", "shape", "rank", "iterations")}
    rng = np.random.RandomState(4)
    ws = rng.rand(3, 30, 3).astype(np.float32)
    hs = rng.rand(3, 3, 20).astype(np.float32)
    args = cli.build_parser().parse_args(common)
    res = nt.solve_batched(xs, ws, hs, cli._config(args), device="cpu")
    for i in range(3):
        assert jbin.read_matrix(tmp_path / "bp" / f"m{i}.W.bin").tobytes() == \
            res.w[i].numpy().tobytes()


@pytest.mark.parametrize("case", ["empty", "shapes", "out_of_core", "mesh"])
def test_batch_refusals(tmp_path, capsys, case):
    """An empty directory and mixed shapes exit 2 with the JAX CLI's words;
    the modes a batch lacks exit 2.  ``--mesh``, refused naming its ROADMAP.md
    step when this test was named, is ported (tests/test_torch_mesh_paths.py
    runs it on gloo ranks): without a launcher it exits 2 naming one."""
    d = tmp_path / "d"
    d.mkdir()
    flags = {"out_of_core": ["--out-of-core"], "mesh": ["--mesh", "2x1"]}.get(case, [])
    if case != "empty":
        jbin.write_matrix(np.ones((4, 5), np.float32), d / "a.bin")
        jbin.write_matrix(np.ones((4, 6 if case == "shapes" else 5), np.float32), d / "b.bin")
    args = ["batch", "d", "--rank", "2", "--max-iter", "2", "-q", *flags]
    assert _port_cli(args, tmp_path) == 2
    ours = capsys.readouterr().err
    if case == "mesh":
        assert "--mesh 2x1 needs 2 ranks" in ours and "torch.distributed.run" in ours
        return
    assert _jax_cli(args, tmp_path) == 2
    ref = capsys.readouterr().err
    assert ours.split("(")[0].replace(str(tmp_path), "") == ref.split("(")[0].replace(
        str(tmp_path), "")


@pytest.mark.parametrize("sub", ["select", "batch"])
def test_every_jax_flag_of_the_step7_subcommands_is_known(sub):
    """Each flag of the JAX CLI's select and batch is in the port's."""
    from nmf_tpu.cli import build_parser as jax_parser

    def flags(parser):
        action = next(a for a in parser._actions if a.dest == "command")
        return {o for a in action.choices[sub]._actions for o in a.option_strings}

    assert flags(jax_parser()) <= flags(cli.build_parser())


@pytest.mark.parametrize("args", [["select", "X.bin", "--ranks", "2"],
                                  ["batch", "d", "--rank", "2"]], ids=["select", "batch"])
def test_select_and_batch_default_to_the_card(tmp_path, args):
    """Without ``--device`` both run on the card, and raise without one
    before reading their input."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(RuntimeError, match="no usable NVIDIA card"):
            cli.main([*args, "-q"])
    finally:
        os.chdir(here)


# --- step 9: --checkpoint-dir, --live, --validate, doctor --------------------------


def _ckpt_both_clis(tmp_path, where, flags=()):
    """``run ... --checkpoint-dir`` (every 8 of 20 iterations) through both
    CLIs, each into its own directory: the files agree as in
    :func:`_assert_files_close`, both CLIs write the same steps, the last
    step's ``W.bin`` and ``H.bin`` are the output files' bytes, and a rerun
    of the port's CLI resumes the finished run and writes the same bytes."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    common = ["run", "X.bin", "W.bin", "H.bin", *where, "--max-iter", "20", "--check-every", "5",
              "--checkpoint-every", "8", "-q", *flags]
    assert _port_cli([*common, "--checkpoint-dir", "ckp", "-o", "Wp.bin", "Hp.bin"], tmp_path) == 0
    assert _jax_cli([*common, "--checkpoint-dir", "ckj", "-o", "Wj.bin", "Hj.bin"], tmp_path) == 0
    _assert_files_close(tmp_path, "WH")
    steps = sorted(os.listdir(tmp_path / "ckp"))
    assert steps == sorted(os.listdir(tmp_path / "ckj")) and steps[-1] == "step_00000020"
    for f in "WH":
        assert (tmp_path / "ckp" / steps[-1] / f"{f}.bin").read_bytes() == \
            (tmp_path / f"{f}p.bin").read_bytes()
    assert _port_cli([*common, "--checkpoint-dir", "ckp", "-o", "Wq.bin", "Hq.bin"], tmp_path) == 0
    for f in "WH":
        assert (tmp_path / f"{f}q.bin").read_bytes() == (tmp_path / f"{f}p.bin").read_bytes()


@pytest.mark.parametrize("where", [[], ["--out-of-core", "--block-n", "8"]],
                         ids=["in_memory", "out_of_core"])
@pytest.mark.parametrize("flags", [[], ["--accelerate"], ["--x-dtype", "int8"],
                                   ["--x-dtype", "bfloat16"]],
                         ids=["plain", "accelerate", "int8_x", "bf16_x"])
def test_run_checkpoint_dir_matches_jax_cli(tmp_path, where, flags):
    _ckpt_both_clis(tmp_path, where, flags)


def test_run_checkpoint_dir_equals_in_process(tmp_path):
    """The port's checkpointed files, byte for byte, are
    ``solve_with_checkpoints``' (in memory) and ``solve_out_of_core``'s
    (streamed); the JSONL labels the checks with their global iterations."""
    import json

    import nmf_tpu_torch as nt

    _write_problem(tmp_path, 40, 4, 30, 2)
    x, w, h = (jbin.read_matrix(tmp_path / f"{s}.bin") for s in "XWH")
    cfg = nt.SolveConfig(max_iter=20, check_every=6)
    common = ["run", "X.bin", "W.bin", "H.bin", "--max-iter", "20", "--check-every", "6",
              "--checkpoint-every", "8", "-q"]
    assert _port_cli([*common, "--checkpoint-dir", "a", "-o", "Wa.bin", "Ha.bin",
                      "--jsonl", "a.jsonl"], tmp_path) == 0
    st = nt.utils.solve_with_checkpoints(x, w, h, cfg, str(tmp_path / "a2"), every=8, device="cpu")
    assert jbin.read_matrix(tmp_path / "Wa.bin").tobytes() == st.w.tobytes()
    rec = json.loads((tmp_path / "a.jsonl").read_text())
    assert [c["iteration"] for c in rec["checks"]] == st.check_iterations == [6, 8, 14, 16, 20]
    assert _port_cli([*common, "--out-of-core", "--block-n", "8", "--checkpoint-dir", "b",
                      "-o", "Wb.bin", "Hb.bin"], tmp_path) == 0
    ref = nt.solve_out_of_core(x, w, h, cfg, block_n=8, device="cpu")
    assert jbin.read_matrix(tmp_path / "Hb.bin").tobytes() == ref.h.numpy().tobytes()


@pytest.mark.parametrize(
    "flags,msg",
    [(["--mask", "X.bin"], "--mask runs the masked solver (no --strict-compat / --checkpoint-dir"),
     (["--freeze", "2"], "--freeze composes with the plain / --mesh / --out-of-core solvers only"),
     (["--strict-compat"], "--strict-compat is a single-device exact-replication mode"),
     (["--rank", "3", "--restarts", "2"], "--restarts composes with --mesh only"),
     (["--rank", "3", "--init", "random", "--online"], "--online composes with --mesh only")],
    ids=["mask", "freeze", "strict", "restarts", "online"],
)
def test_checkpoint_dir_refusals_match_jax_cli(tmp_path, capsys, flags, msg):
    """The modes that do not checkpoint exit 2 with the JAX CLI's message."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = [] if "--rank" in flags else ["W.bin", "H.bin"]
    args = ["run", "X.bin", *files, *flags, "--checkpoint-dir", "ck", "--max-iter", "2", "-q"]
    assert _port_cli(args, tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(args, tmp_path) == 2
    assert msg in ours and ours == capsys.readouterr().err
    assert not (tmp_path / "ck").exists()


@pytest.mark.parametrize("sub", ["transform", "separate", "select", "batch"])
def test_checkpoint_dir_refused_where_jax_refuses_it(tmp_path, capsys, sub):
    """transform, separate, select and batch never checkpoint, as in JAX:
    the same exit and message in both CLIs, before any input is read."""
    args = {"transform": ["transform", "X.bin", "W.bin"], "separate": ["separate", "a.wav"],
            "select": ["select", "X.bin", "--ranks", "2"],
            "batch": ["batch", "d", "--rank", "2"]}[sub]
    args = [*args, "--checkpoint-dir", "ck", "-q"]
    assert _port_cli(args, tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli(args, tmp_path) == 2
    # batch names its solve its own way ("batched", JAX's "vmapped")
    assert "checkpoint" in ours and ours.split("(")[0] == capsys.readouterr().err.split("(")[0]


@pytest.mark.parametrize("where", [[], ["--out-of-core", "--block-n", "8"], ["--accelerate"],
                                   ["--checkpoint-dir", "ck", "--checkpoint-every", "10"]],
                         ids=["in_memory", "out_of_core", "accelerate", "checkpointed"])
def test_run_live_prints_each_check(tmp_path, capsys, where):
    """``run --live`` prints one ``(live)`` line a check on stderr, as the
    solve runs, and writes the bytes of the run without it; the JAX CLI's
    files agree as in :func:`_assert_files_close`."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    common = ["run", "X.bin", "W.bin", "H.bin", *where, "--max-iter", "20", "--check-every", "5"]
    assert _port_cli([*common, "-q", "-o", "Wq.bin", "Hq.bin"], tmp_path) == 0
    shutil.rmtree(tmp_path / "ck", ignore_errors=True)   # else the live run resumes a finished one
    capsys.readouterr()
    assert _port_cli([*common, "-q", "--live", "-o", "Wp.bin", "Hp.bin"], tmp_path) == 0
    live = [ln for ln in capsys.readouterr().err.splitlines() if ln.endswith("(live)")]
    assert len(live) == 4, live
    if "--checkpoint-dir" not in where:   # a segment counts its own iterations
        assert [int(ln.split()[2]) for ln in live] == [5, 10, 15, 20]
    for f in "WH":
        assert (tmp_path / f"{f}p.bin").read_bytes() == (tmp_path / f"{f}q.bin").read_bytes()
    jwhere = ["--checkpoint-dir", "ckj", "--checkpoint-every", "10"] if "--checkpoint-dir" in where \
        else where
    common_j = ["run", "X.bin", "W.bin", "H.bin", *jwhere, "--max-iter", "20", "--check-every", "5"]
    assert _jax_cli([*common_j, "-q", "--live", "-o", "Wj.bin", "Hj.bin"], tmp_path) == 0
    _assert_files_close(tmp_path, "WH")


def _bad_x(tmp_path, name="X.bin"):
    x = jbin.read_matrix(tmp_path / name)
    x[1, 2] = -5.0
    jbin.write_matrix(x, tmp_path / name)


# subcommand -> (args with {t} for the output tag, whether it checks its input)
_VALIDATE = {
    "run": (["run", "X.bin", "W.bin", "H.bin", "-o", "W{t}.bin", "H{t}.bin"], True),
    "run_rank": (["run", "X.bin", "--rank", "3", "--init", "random", "-o", "W{t}.bin", "H{t}.bin"],
                 True),
    "run_out_of_core": (["run", "X.bin", "W.bin", "H.bin", "--out-of-core", "--block-n", "8",
                         "-o", "W{t}.bin", "H{t}.bin"], False),
    "run_checkpointed": (["run", "X.bin", "W.bin", "H.bin", "--checkpoint-dir", "ck{t}",
                          "--checkpoint-every", "4", "-o", "W{t}.bin", "H{t}.bin"], True),
    "run_restarts": (["run", "X.bin", "--rank", "3", "--restarts", "2", "-o", "W{t}.bin",
                      "H{t}.bin"], True),
    "run_online": (["run", "X.bin", "--rank", "3", "--init", "random", "--online", "--block-n",
                    "8", "-o", "W{t}.bin", "H{t}.bin"], False),
    "transform": (["transform", "X.bin", "W.bin", "-o", "H{t}.bin"], False),
    "transform_out_of_core": (["transform", "X.bin", "W.bin", "--out-of-core", "--block-n", "8",
                               "-o", "H{t}.bin"], False),
    "select": (["select", "X.bin", "--ranks", "2,3", "--restarts", "2", "--init", "random"],
               True),
    "batch": (["batch", "d", "--rank", "3", "--out-dir", "b{t}"], True),
    "separate": (["separate", "clip.wav", "--rank", "3", "--n-fft", "128", "--hop", "32",
                  "--out-dir", "s{t}"], False),
}


@pytest.mark.parametrize("sub", list(_VALIDATE))
def test_validate_on_every_subcommand(tmp_path, capsys, sub):
    """``--validate`` wherever the JAX CLI takes it: clean inputs run in both
    CLIs (exit 0, the port's files the bytes of its run without the flag);
    where the JAX CLI checks the input, X with a negative entry exits 2 in
    both with the same message."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    _write_batch_dir(tmp_path)
    _write_wav(tmp_path / "clip.wav")
    args, checks_input = _VALIDATE[sub]
    common = ["--max-iter", "8", "--check-every", "4", "-q"]

    def with_tag(t):
        return [a.format(t=t) for a in args] + common

    assert _port_cli([*with_tag("p"), "--validate"], tmp_path) == 0
    assert _port_cli(with_tag("q"), tmp_path) == 0
    assert _jax_cli([*with_tag("j"), "--validate"], tmp_path) == 0
    outs = [f"{f}p.bin" for f in "WH" if f"{f}{{t}}.bin" in args]
    for name in outs:
        assert (tmp_path / name).read_bytes() == (tmp_path / name.replace("p.", "q.")).read_bytes()
    if not checks_input:
        return
    _bad_x(tmp_path)
    _bad_x(tmp_path, "d/m1.bin")
    capsys.readouterr()
    assert _port_cli([*with_tag("r"), "--validate"], tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli([*with_tag("s"), "--validate"], tmp_path) == 2
    ref = capsys.readouterr().err
    assert "negative entries" in ours and ours == ref


def test_validate_rejects_a_non_finite_result(tmp_path, capsys):
    """A result with NaN (here from NaN in X) exits 2 in both CLIs with the
    guard's message; without ``--validate`` the port writes it."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    x = jbin.read_matrix(tmp_path / "X.bin")
    x[0, 0] = np.nan
    jbin.write_matrix(x, tmp_path / "X.bin")
    args = ["run", "X.bin", "W.bin", "H.bin", "--out-of-core", "--block-n", "8", "--max-iter",
            "4", "-q", "--validate"]
    assert _port_cli([*args, "-o", "Wp.bin", "Hp.bin"], tmp_path) == 2
    ours = capsys.readouterr().err
    assert _jax_cli([*args, "-o", "Wj.bin", "Hj.bin"], tmp_path) == 2
    assert "non-finite entries" in ours and ours.split(" entries")[0].split(":")[1] == \
        capsys.readouterr().err.split(" entries")[0].split(":")[1]


def test_batch_reads_through_bindataset(tmp_path, monkeypatch):
    """``batch`` loads its directory with ``BinDataset`` (sorted paths, the
    ``.bin`` files only): the files are ``solve_batched`` of its batch."""
    import nmf_tpu_torch as nt

    _write_batch_dir(tmp_path)
    seen = []
    load = nt.BinDataset.load_batch

    def spy(self, indices=None):
        seen.append(list(self.paths))
        return load(self, indices)

    monkeypatch.setattr(nt.BinDataset, "load_batch", spy)
    args = ["batch", "d", "--rank", "3", "--max-iter", "5", "-q", "--out-dir", "b"]
    assert _port_cli(args, tmp_path) == 0
    assert [os.path.basename(p) for p in seen[0]] == ["m0.bin", "m1.bin", "m2.bin"]
    xs = nt.BinDataset(tmp_path / "d").load_batch()
    rng = np.random.RandomState(0)
    ws, hs = rng.rand(3, 30, 3).astype(np.float32), rng.rand(3, 3, 20).astype(np.float32)
    res = nt.solve_batched(xs, ws, hs, nt.SolveConfig(max_iter=5), device="cpu")
    for i in range(3):
        assert jbin.read_matrix(tmp_path / "b" / f"m{i}.H.bin").tobytes() == res.h[i].numpy().tobytes()


def test_doctor_cpu_json_through_both_clis(tmp_path, capsys):
    """``doctor --platform cpu --json``: the port's in a subprocess exits 0
    with ``up: true`` and the matmul check passed on the CPU; the JAX CLI's
    says the same of its CPU backend."""
    run = _port("doctor", "--platform", "cpu", "--json", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    ours = json.loads(run.stdout)
    assert ours["up"] is True and ours["backend"]["matmul_ok"] is True
    assert ours["backend"]["platform"] == "cpu" and ours["versions"]["torch"] == torch.__version__
    assert _jax_cli(["doctor", "--platform", "cpu", "--json"], tmp_path) == 0
    ref = json.loads(capsys.readouterr().out)
    assert ref["up"] is True and ref["backend"]["platform"] == "cpu"
    assert set(ours["backend"]) <= set(ref["backend"])


def test_doctor_human_report_and_down_exit(capsys, monkeypatch):
    """The text report names the state; a probe that is down exits 1."""
    from nmf_tpu_torch.utils import doctor

    assert cli.main(["doctor", "--platform", "cpu"]) == 0
    assert "UP" in capsys.readouterr().out
    monkeypatch.setattr(doctor, "diagnose", lambda **kw: {
        "up": False, "error": "probe subprocess crashed: boom", "probe_s": 0.1,
        "versions": {"python": "3", "torch": "t", "cuda": None, "numpy": "n"},
        "kernel_build": {"dir": "b", "libraries": 0, "bytes": 0, "current_built": False}})
    assert cli.main(["doctor", "--platform", "cpu"]) == 1
    assert "DOWN" in capsys.readouterr().out


def test_every_jax_doctor_flag_is_known():
    from nmf_tpu.cli import build_parser as jax_parser

    def flags(parser):
        action = next(a for a in parser._actions if a.dest == "command")
        return {o for a in action.choices["doctor"]._actions for o in a.option_strings}

    assert flags(jax_parser()) == flags(cli.build_parser())
