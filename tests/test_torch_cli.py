"""The port's CLI (``python -m nmf_tpu_torch``) on the CPU, and its imports.

The end-to-end case runs the CLI in a subprocess (one torch thread) and
holds its output files to an in-process ``nmf_tpu.solve`` with the solver
tolerances of tests/test_torch_solver.py: factors rtol 1e-4 / atol 1e-6.
"""

import json
import os
import pathlib
import re
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
        ["--mesh", "2x1", "--out-of-core"],
        ["--restarts", "4"],
    ],
)
def test_refused_flag_exits_2(capsys, tmp_path, flags):
    """A flag not in the port exits 2 naming its ROADMAP.md item.  The
    precision flags, ``--backend jnp`` and ``--no-cost``, refused when this
    test was named, are ported: the parser takes them, and the run exits 2
    later, on its (here missing) input.  ``--out-of-core`` is ported too;
    with ``--mesh`` it is refused for the mesh.  ``--accelerate``,
    ``--strict-compat`` and ``--beta 2`` are ported: they run on a small
    problem through both CLIs (:func:`_run_both_clis`)."""
    if flags[0] in ("--accelerate", "--strict-compat", "--beta"):
        _run_both_clis(tmp_path, flags)
        return
    rc = cli.main(["run", "X.bin", "W.bin", "H.bin", "--device", "cpu", *flags])
    assert rc == 2
    err = capsys.readouterr().err
    if flags[0] in ("--dtype", "--x-dtype", "--backend", "--no-cost"):
        assert "file not found" in err and "ROADMAP.md" not in err
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
    run through both CLIs (:func:`_run_both_clis`)."""
    if flags[0] in ("--beta", "--algorithm", "--l2-h"):
        _run_both_clis(tmp_path, flags + (["--beta", "2"] if flags[0] == "--algorithm" else []))
        return
    rc = cli.main(["run", "X.bin", "W.bin", "H.bin", "--device", "cpu", *flags])
    assert rc == 2
    err = capsys.readouterr().err
    assert item in err and "file not found" not in err


def _run_both_clis(tmp_path, flags):
    """``run`` with ``flags`` through both CLIs on a small problem: the files
    agree to rtol 1e-4 / atol 1e-6 (test_gen_then_run_matches_jax's)."""
    _write_problem(tmp_path, 40, 4, 30, 2)
    files = [str(tmp_path / f"{s}.bin") for s in "XWH"]
    common = ["--max-iter", "50", "--check-every", "10", "-q", *flags]
    out = {tag: [str(tmp_path / f"{f}{tag}.bin") for f in "WH"] for tag in "pj"}
    assert cli.main(["run", *files, "-o", *out["p"], "--device", "cpu", *common]) == 0
    assert _jax_cli(["run", *files, "-o", *out["j"], *common], tmp_path) == 0
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
    """The JAX CLI's --out-of-core messages, and the flags still refused."""
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
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            assert not banned.match(line), f"{path}: {line}"


def test_kernel_path_has_no_fallback_handler():
    """No ``except`` on the CUDA path: a failed build or launch raises."""
    for rel in ("ops/kernels/fused_mu.py", "ops/kernels/tile_sparse.py", "ops/kernels/_build.py",
                "models/solver.py", "models/sparse_tiled.py", "models/streaming.py",
                "models/nmf.py"):
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
    """The families run in memory; the streamed solve refuses them, before
    any input is read, naming the ROADMAP.md step that brings them."""
    rc = cli.main(["run", str(tmp_path / "X.bin"), "W.bin", "H.bin", "--device", "cpu", *flags])
    assert rc == 2
    err = capsys.readouterr().err
    assert msg in err and "file not found" not in err


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
        (["--mesh", "2x1"], "--mesh (ROADMAP.md Queue 1 step 12"),
        (["--validate"], "--validate (ROADMAP.md Queue 1 step 9"),
        (["--live"], "--live (ROADMAP.md Queue 1 step 9"),
        (["--backend", "autotune"], "--backend autotune (ROADMAP.md Queue 1 step 11"),
        (["--checkpoint-dir", "ck"], "transform does not checkpoint"),
        (["--strict-compat"], "--strict-compat is a full-solve replication mode (use 'run')"),
    ],
)
def test_transform_refusals_exit_2(tmp_path, capsys, flags, msg):
    """transform's flags not in the port, and the two the JAX CLI refuses
    with its own message, exit 2 before any input is read."""
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
