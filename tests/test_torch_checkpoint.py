"""Checkpoint / resume of the port (``nmf_tpu_torch.utils.checkpoint`` and the
streamed solve's ``checkpoint_dir``) against ``nmf_tpu`` on the CPU.

* The on-disk format is JAX's byte for byte: the same state saved by both
  packages gives the same ``W.bin``, ``H.bin``, ``Wex.bin``, ``Hex.bin``
  and ``meta.json``, and each package loads and resumes the other's.
* ``solve_with_checkpoints`` matches ``nmf_tpu``'s within the solve parity
  bar of tests/test_torch_solver.py (factors rtol 1e-4 / atol 1e-6, costs
  rel 1e-5; the accelerated runs and the tile-sparse ones at the bars of
  tests/test_torch_accel.py and tests/test_torch_tile_sparse.py: factors
  rtol 1e-3, costs 1e-5), with the same check labels.
* In the port a run killed after a checkpoint and resumed gives the bits
  of the uninterrupted run: plain and accelerated, in memory, tile-sparse
  and streamed.  A checkpointed run gives the bits of the straight
  ``solve`` where its segments end on checks.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import nmf_tpu as jt  # noqa: E402
from nmf_tpu.models import streaming as jstream  # noqa: E402
from nmf_tpu.utils import checkpoint as jck  # noqa: E402
import nmf_tpu_torch as pt  # noqa: E402
from nmf_tpu_torch.utils import checkpoint as pck  # noqa: E402
from nmf_tpu_torch.utils.convert import config_from_dict  # noqa: E402

RTOL, ATOL, COST_RTOL = 1e-4, 1e-6, 1e-5
ACCEL_RTOL = 1e-3


def _problem(m=48, k=5, n=40, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(m, n).astype(np.float32), rng.rand(m, k).astype(np.float32),
            rng.rand(k, n).astype(np.float32))


def _tiled_x(seed=41):
    rng = np.random.RandomState(seed)
    x = np.zeros((96, 100), np.float32)
    for bi, bj in [(0, 0), (1, 2), (2, 3), (0, 1)]:
        blk = rng.rand(32, 32).astype(np.float32)
        x[bi * 32:(bi + 1) * 32, bj * 32:min((bj + 1) * 32, 100)] = blk[:, : min(32, 100 - bj * 32)]
    return x, rng.rand(96, 6).astype(np.float32), rng.rand(6, 100).astype(np.float32)


def _pcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _state(accel: bool, seed=0):
    rng = np.random.RandomState(seed)
    w, h = rng.rand(7, 3).astype(np.float32), rng.rand(3, 5).astype(np.float32)
    kw = dict(momentum=0.7234, w_ex=w * 1.5, h_ex=h * 0.5) if accel else {}
    return dict(w=w, h=h, iteration=42, cost_history=[3.25, 2.0, 1.0 / 3.0], converged=False,
                check_iterations=[10, 20, 42], **kw)


def _files(step_dir):
    return {name: open(os.path.join(step_dir, name), "rb").read()
            for name in sorted(os.listdir(step_dir))}


# --- the format -------------------------------------------------------------------


@pytest.mark.parametrize("accel", [False, True], ids=["plain", "accelerated"])
@pytest.mark.parametrize("with_config", [False, True], ids=["no_config", "config"])
def test_same_bytes_on_disk(tmp_path, accel, with_config):
    """The same state saved by both packages: every file byte-equal."""
    jc = jt.SolveConfig(accelerate=accel, beta=1.0, check_every=10,
                        precision=jt.Precision(x_dtype="int8", x_quant_rows=16)) if with_config else None
    pc = _pcfg(jc) if with_config else None
    sj = jck.save_checkpoint(str(tmp_path / "j"), jck.CheckpointState(**_state(accel)), jc)
    sp = pck.save_checkpoint(str(tmp_path / "p"), pck.CheckpointState(**_state(accel)), pc)
    assert os.path.basename(sj) == os.path.basename(sp) == "step_00000042"
    fj, fp = _files(sj), _files(sp)
    assert list(fp) == list(fj) == (["H.bin", "Hex.bin", "W.bin", "Wex.bin", "meta.json"] if accel
                                    else ["H.bin", "W.bin", "meta.json"])
    assert fp == fj


@pytest.mark.parametrize("accel", [False, True], ids=["plain", "accelerated"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_loads_the_others(tmp_path, accel, direction):
    save, load = ((jck.save_checkpoint, pck.load_checkpoint) if direction == "jax_to_port"
                  else (pck.save_checkpoint, jck.load_checkpoint))
    state_cls = jck.CheckpointState if direction == "jax_to_port" else pck.CheckpointState
    cfg = jt.SolveConfig(accelerate=accel) if direction == "port_to_jax" else None
    step = save(str(tmp_path), state_cls(**_state(accel)),
                _pcfg(cfg) if cfg is not None else jt.SolveConfig(accelerate=accel))
    back = load(step, cfg if cfg is not None else pt.SolveConfig(accelerate=accel))
    want = _state(accel)
    for f in ("w", "h", "w_ex", "h_ex"):
        a, b = getattr(back, f), want.get(f)
        assert (a is None and b is None) or np.asarray(a).tobytes() == b.tobytes(), f
    assert back.iteration == 42 and back.cost_history == want["cost_history"]
    assert back.check_iterations == [10, 20, 42] and back.converged is False
    if accel:
        assert back.momentum == 0.7234
    else:
        assert np.isnan(back.momentum)


def test_fingerprint_keys_are_jaxs():
    for cfg in (jt.SolveConfig(), jt.SolveConfig(beta=2.0, algorithm="hals", l1_w=0.5,
                                                 precision=jt.Precision("bfloat16"))):
        assert pck._config_fingerprint(_pcfg(cfg)) == jck._config_fingerprint(cfg)
        assert list(pck._config_fingerprint(_pcfg(cfg))) == list(jck._config_fingerprint(cfg))


@pytest.mark.parametrize("change", [dict(beta=2.0), dict(check_every=7), dict(accelerate=True),
                                    dict(eps=1e-9), dict(l2_h=0.1)],
                         ids=["beta", "check_every", "accelerate", "eps", "l2_h"])
def test_fingerprint_mismatch_refused_with_jaxs_message(tmp_path, change):
    st = _state(False)
    step = pck.save_checkpoint(str(tmp_path), pck.CheckpointState(**st), pt.SolveConfig())
    with pytest.raises(ValueError) as ep:
        pck.load_checkpoint(step, pt.SolveConfig(**change))
    with pytest.raises(ValueError) as ej:
        jck.load_checkpoint(step, jt.SolveConfig(**change))
    assert str(ep.value) == str(ej.value) and "refusing to mix objectives" in str(ep.value)


def test_fingerprint_missing_keys_stay_compatible(tmp_path):
    """A checkpoint written before a fingerprint field existed resumes."""
    step = pck.save_checkpoint(str(tmp_path), pck.CheckpointState(**_state(False)),
                               pt.SolveConfig())
    meta = json.loads(open(os.path.join(step, "meta.json")).read())
    for key in ("x_quant_rows", "accelerate", "check_every"):
        del meta["config"][key]
    json.dump(meta, open(os.path.join(step, "meta.json"), "w"))
    pck.load_checkpoint(step, pt.SolveConfig(accelerate=True, check_every=3))


def test_crash_between_the_renames_recovers(tmp_path):
    """A step parked as ``.old_*`` by a crash in a same-step overwrite is put
    back by latest_checkpoint, which never sweeps staging directories; the
    next save does; with both present the parked copy goes."""
    d = str(tmp_path / "ck")
    st = pck.CheckpointState(w=np.ones((4, 2), np.float32), h=np.ones((2, 3), np.float32),
                             iteration=5, cost_history=[1.0], momentum=0.7)
    step = pck.save_checkpoint(d, st)
    parked = os.path.join(d, ".old_step_00000005_12345")
    os.rename(step, parked)
    staging = os.path.join(d, ".tmp_ckpt_leftover")
    os.makedirs(os.path.join(staging, "junk"))
    assert pck.latest_checkpoint(d) == step
    assert not os.path.exists(parked) and os.path.exists(staging)
    pck.save_checkpoint(d, st)
    assert not os.path.exists(staging)
    assert pck.load_checkpoint(step).momentum == pytest.approx(0.7, rel=1e-6)
    shutil.copytree(step, parked)
    assert pck.latest_checkpoint(d) == step and not os.path.exists(parked)


def test_same_step_overwrite_and_failed_rename(tmp_path, monkeypatch):
    """Overwriting a step replaces it; a rename that fails mid-overwrite
    puts the old copy back and leaves no staging directory."""
    d = str(tmp_path)
    st = pck.CheckpointState(**_state(False))
    pck.save_checkpoint(d, st)
    st2 = dataclasses.replace(st, cost_history=[9.0])
    step = pck.save_checkpoint(d, st2)
    assert pck.load_checkpoint(step).cost_history == [9.0]
    real = os.rename

    def flaky(src, dst):
        if os.path.basename(src).startswith(".tmp_ckpt_"):
            raise OSError("disk full")
        return real(src, dst)

    monkeypatch.setattr(os, "rename", flaky)
    with pytest.raises(OSError, match="disk full"):
        pck.save_checkpoint(d, dataclasses.replace(st, cost_history=[1.0]))
    monkeypatch.setattr(os, "rename", real)
    assert pck.load_checkpoint(step).cost_history == [9.0]
    assert sorted(os.listdir(d)) == ["step_00000042"]


def test_latest_checkpoint_ignores_leftovers(tmp_path):
    d = tmp_path
    assert pck.latest_checkpoint(str(d / "absent")) is None
    for name in ("step_00000010", "step_00000030"):
        pck.save_checkpoint(str(d), pck.CheckpointState(**{**_state(False),
                                                           "iteration": int(name[5:])}))
    os.makedirs(d / "step_00000099")            # no meta.json: incomplete
    os.makedirs(d / "step_00000050.old")        # not digits
    assert pck.latest_checkpoint(str(d)) == str(d / "step_00000030")
    assert jck.latest_checkpoint(str(d)) == pck.latest_checkpoint(str(d))


# --- the checkpointed solve against nmf_tpu's ---------------------------------------


CASES = {
    "plain": dict(max_iter=40, check_every=10),
    "segments_off_checks": dict(max_iter=37, check_every=6),
    "thresh": dict(max_iter=400, check_every=5, thresh=3e-3),
    "accelerate": dict(max_iter=40, check_every=10, accelerate=True),
    "int8_x": dict(max_iter=30, check_every=10, precision=jt.Precision(x_dtype="int8")),
    "bf16_x": dict(max_iter=30, check_every=10, precision=jt.Precision(x_dtype="bfloat16")),
    "beta2": dict(max_iter=30, check_every=10, beta=2.0),
    "hals": dict(max_iter=30, check_every=10, beta=2.0, algorithm="hals"),
    "penalized": dict(max_iter=30, check_every=10, l1_h=0.1, l2_w=0.2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_with_checkpoints_matches_jax(tmp_path, case):
    x, w, h = _problem()
    jc = jt.SolveConfig(**CASES[case])
    ref = jck.solve_with_checkpoints(x, w, h, jc, str(tmp_path / "j"), every=15)
    ours = pck.solve_with_checkpoints(x, w, h, _pcfg(jc), str(tmp_path / "p"), every=15,
                                      device="cpu")
    assert ours.iteration == ref.iteration and ours.converged == ref.converged
    assert ours.check_iterations == ref.check_iterations
    np.testing.assert_allclose(ours.cost_history, ref.cost_history, rtol=COST_RTOL)
    rtol = ACCEL_RTOL if jc.accelerate else RTOL
    for f in ("w", "h"):
        a, b = getattr(ours, f), np.asarray(getattr(ref, f), np.float32)
        if jc.algorithm == "hals":   # exact zeros: tests/test_torch_families.py's norm
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), f
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL, err_msg=f)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))


@pytest.mark.parametrize("accel", [False, True], ids=["plain", "accelerated"])
def test_tile_sparse_checkpoints_match_jax(tmp_path, accel):
    x, w, h = _tiled_x()
    jc = jt.SolveConfig(max_iter=20, check_every=5, accelerate=accel)
    ref = jck.solve_with_checkpoints(jt.tiles_from_dense(x, (32, 32)), w, h, jc,
                                     str(tmp_path / "j"), every=10)
    ours = pck.solve_with_checkpoints(pt.tiles_from_dense(x, (32, 32)), w, h, _pcfg(jc),
                                      str(tmp_path / "p"), every=10, device="cpu")
    assert ours.w.shape == (96, 6) and ours.h.shape == (6, 100)
    assert ours.check_iterations == ref.check_iterations == [5, 10, 15, 20]
    np.testing.assert_allclose(ours.cost_history, ref.cost_history, rtol=COST_RTOL)
    for f in ("w", "h", *(("w_ex", "h_ex") if accel else ())):
        np.testing.assert_allclose(getattr(ours, f), np.asarray(getattr(ref, f), np.float32),
                                   rtol=ACCEL_RTOL, atol=2e-6, err_msg=f)


# --- bits in the port: checkpointed vs straight, resumed vs uninterrupted -------------


@pytest.mark.parametrize("accel", [False, True], ids=["plain", "accelerated"])
def test_checkpointed_equals_straight_solve(tmp_path, accel):
    """Segments ending on checks take the straight solve's steps: the same
    bits (the accelerated carry and momentum cross each segment)."""
    x, w, h = _problem()
    cfg = pt.SolveConfig(max_iter=40, check_every=10, accelerate=accel)
    straight = pt.solve(x, w, h, cfg, device="cpu")
    st = pck.solve_with_checkpoints(x, w, h, cfg, str(tmp_path), every=20, device="cpu")
    assert st.w.tobytes() == straight.w.numpy().tobytes()
    assert st.h.tobytes() == straight.h.numpy().tobytes()
    assert np.float32(st.cost_history).tobytes() == straight.cost_history.numpy().tobytes()
    if accel:
        assert np.float32(st.momentum) == straight.momentum.numpy()


class _Killed(Exception):
    pass


def _kill_after(monkeypatch, module, saves: int):
    """Make ``module.save_checkpoint`` raise after ``saves`` real saves."""
    real = pck.save_checkpoint
    done = [0]

    def save(*a, **kw):
        if done[0] == saves:
            raise _Killed()
        done[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(module, "save_checkpoint", save)


SOLVES = ["in_memory", "tile_sparse", "streamed", "streamed_frozen"]


def _run(solve, cfg, d, x, w, h):
    """(W, H, history) of one checkpointed run of ``solve`` into ``d``."""
    if solve == "in_memory":
        st = pck.solve_with_checkpoints(x, w, h, cfg, d, every=10, device="cpu")
        return st.w, st.h, np.float32(st.cost_history)
    if solve == "tile_sparse":
        st = pck.solve_with_checkpoints(pt.tiles_from_dense(x, (32, 32)), w, h, cfg, d, every=10,
                                        device="cpu")
        return st.w, st.h, np.float32(st.cost_history)
    res = pt.solve_out_of_core(x, w, h, cfg, block_n=16, checkpoint_dir=d, checkpoint_every=10,
                               n_frozen=2 if solve == "streamed_frozen" else 0, device="cpu")
    return res.w.numpy(), res.h.numpy(), res.cost_history.numpy()[: int(res.num_checks)]


@pytest.mark.parametrize("accel", [False, True], ids=["plain", "accelerated"])
@pytest.mark.parametrize("solve", SOLVES)
def test_killed_and_resumed_equals_uninterrupted(tmp_path, monkeypatch, solve, accel):
    """A run killed after its second checkpoint and run again from the same
    directory gives the bits of the run that was never stopped."""
    x, w, h = _tiled_x() if solve == "tile_sparse" else _problem()
    cfg = pt.SolveConfig(max_iter=40, check_every=5, accelerate=accel)
    whole = _run(solve, cfg, str(tmp_path / "whole"), x, w, h)
    module = pck if solve in ("in_memory", "tile_sparse") else pt.models.streaming.ckpt
    with monkeypatch.context() as mp:
        _kill_after(mp, module, 2)
        with pytest.raises(_Killed):
            _run(solve, cfg, str(tmp_path / "cut"), x, w, h)
    assert len(os.listdir(tmp_path / "cut")) == 2
    resumed = _run(solve, cfg, str(tmp_path / "cut"), x, w, h)
    for a, b in zip(resumed, whole):
        assert a.tobytes() == b.tobytes()
    assert sorted(os.listdir(tmp_path / "cut")) == sorted(os.listdir(tmp_path / "whole"))


@pytest.mark.parametrize("accel", [False, True], ids=["plain", "accelerated"])
def test_streamed_checkpoints_match_jax(tmp_path, accel):
    """The streamed solve's checkpoints: the same steps and labels as
    ``nmf_tpu``'s, the states within the streamed parity bar
    (tests/test_torch_streaming.py: factors rtol 1e-5, accelerated 1e-3)."""
    x, w, h = _problem()
    cfg = dict(max_iter=20, check_every=5, accelerate=accel)
    jstream.solve_out_of_core(x, w, h, jt.SolveConfig(**cfg), block_n=16,
                              checkpoint_dir=str(tmp_path / "j"), checkpoint_every=8)
    pt.solve_out_of_core(x, w, h, pt.SolveConfig(**cfg), block_n=16,
                         checkpoint_dir=str(tmp_path / "p"), checkpoint_every=8, device="cpu")
    steps = sorted(os.listdir(tmp_path / "p"))
    assert steps == sorted(os.listdir(tmp_path / "j"))
    for s in steps:
        a, b = (pck.load_checkpoint(str(tmp_path / t / s)) for t in "pj")
        assert a.check_iterations == b.check_iterations and a.iteration == b.iteration
        np.testing.assert_allclose(a.cost_history, b.cost_history, rtol=1e-6)
        for f in ("w", "h", "w_ex", "h_ex"):
            if getattr(b, f) is None:
                assert getattr(a, f) is None
            else:
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           rtol=1e-3 if accel else 1e-5, atol=1e-8)
        assert (np.isnan(a.momentum) and np.isnan(b.momentum)) or a.momentum == b.momentum


@pytest.mark.parametrize("accel", [False, True], ids=["plain", "accelerated"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_one_package_resumes_the_others_run(tmp_path, accel, direction):
    """The first 20 of 40 iterations in one package, the rest in the other:
    within the parity bar of a straight 40-iteration run in the second."""
    x, w, h = _problem()
    jc = jt.SolveConfig(max_iter=40, check_every=10, accelerate=accel)
    half = dataclasses.replace(jc, max_iter=20)
    d = str(tmp_path / "ck")
    if direction == "jax_to_port":
        jck.solve_with_checkpoints(x, w, h, half, d, every=10)
        st = pck.solve_with_checkpoints(x, w, h, _pcfg(jc), d, every=10, device="cpu")
        ref = pck.solve_with_checkpoints(x, w, h, _pcfg(jc), str(tmp_path / "r"), every=10,
                                         device="cpu")
    else:
        pck.solve_with_checkpoints(x, w, h, _pcfg(half), d, every=10, device="cpu")
        st = jck.solve_with_checkpoints(x, w, h, jc, d, every=10)
        ref = jck.solve_with_checkpoints(x, w, h, jc, str(tmp_path / "r"), every=10)
    assert st.iteration == 40 and st.check_iterations == ref.check_iterations == [10, 20, 30, 40]
    np.testing.assert_allclose(st.cost_history, ref.cost_history, rtol=COST_RTOL)
    np.testing.assert_allclose(np.asarray(st.w, np.float32), np.asarray(ref.w, np.float32),
                               rtol=ACCEL_RTOL if accel else RTOL, atol=ATOL)


def test_a_finished_run_resumes_to_itself(tmp_path):
    x, w, h = _problem()
    cfg = pt.SolveConfig(max_iter=20, check_every=10)
    a = pck.solve_with_checkpoints(x, w, h, cfg, str(tmp_path), every=10, device="cpu")
    steps = sorted(os.listdir(tmp_path))
    b = pck.solve_with_checkpoints(x, w, h, cfg, str(tmp_path), every=10, device="cpu")
    assert sorted(os.listdir(tmp_path)) == steps
    assert a.w.tobytes() == b.w.tobytes() and b.iteration == 20
    assert b.cost_history == a.cost_history and b.check_iterations == a.check_iterations


def test_an_entry_below_eps_resumes_as_saved_in_the_port_and_clamped_in_jax(tmp_path):
    """A checkpoint whose W holds an entry below eps (an accelerated step
    can take one there).  ``nmf_tpu``'s resume clamps it to eps again; the
    port's takes it as it was saved, so that the resumed run is the
    uninterrupted one: the same bits as an unclamped ``solve`` continued
    from the saved state.  A run already complete returns the loaded
    factors: eps in JAX's, the saved 1e-30 in the port's."""
    x, w, h = _problem()
    cfg = dict(max_iter=10, check_every=5)
    mid = pt.solve(x, w, h, pt.SolveConfig(max_iter=5, check_every=5), device="cpu")
    w5, h5 = mid.w.numpy().copy(), mid.h.numpy().copy()
    w5[0, 0] = np.float32(1e-30)
    eps = np.float32(pt.SolveConfig().eps)
    assert w5[0, 0] < eps
    c5 = float(mid.cost)
    state = pck.CheckpointState(w=w5, h=h5, iteration=5, cost_history=[c5], converged=False,
                                check_iterations=[5])
    dirs = {}
    for pkg in ("port", "jax"):
        dirs[pkg] = str(tmp_path / pkg)
        pck.save_checkpoint(dirs[pkg], state, pt.SolveConfig(**cfg))

    done_p = pck.solve_with_checkpoints(x, w, h, pt.SolveConfig(max_iter=5, check_every=5),
                                        dirs["port"], every=5, device="cpu")
    done_j = jck.solve_with_checkpoints(x, w, h, jt.SolveConfig(max_iter=5, check_every=5),
                                        dirs["jax"], every=5)
    assert np.asarray(done_p.w)[0, 0] == np.float32(1e-30)
    assert np.asarray(done_j.w, np.float32)[0, 0] == eps

    ours = pck.solve_with_checkpoints(x, w, h, pt.SolveConfig(**cfg), dirs["port"], every=5,
                                      device="cpu")
    ref = jck.solve_with_checkpoints(x, w, h, jt.SolveConfig(**cfg), dirs["jax"], every=5)
    assert ours.iteration == ref.iteration == 10
    x_dev = torch.clamp_min(torch.from_numpy(x), float(eps))
    straight = pt.solve(x_dev, torch.from_numpy(w5), torch.from_numpy(h5),
                        pt.SolveConfig(max_iter=5, check_every=5), clamp_inputs=False,
                        initial_cost=c5, device="cpu")
    assert ours.w.tobytes() == straight.w.numpy().tobytes()
    assert ours.h.tobytes() == straight.h.numpy().tobytes()
    w5c = np.maximum(w5, eps)
    jstraight = jt.solve(np.maximum(x, eps), w5c, h5, jt.SolveConfig(max_iter=5, check_every=5),
                         clamp_inputs=False, initial_cost=c5)
    assert np.asarray(ref.w, np.float32).tobytes() == np.asarray(jstraight.w, np.float32).tobytes()
    # the two resumes start one entry apart, so they part after it
    np.testing.assert_allclose(np.asarray(ours.w), np.asarray(ref.w, np.float32),
                               rtol=RTOL, atol=ATOL)


def test_resume_false_starts_over(tmp_path):
    x, w, h = _problem()
    cfg = pt.SolveConfig(max_iter=20, check_every=10)
    a = pck.solve_with_checkpoints(x, w, h, cfg, str(tmp_path), every=10, device="cpu")
    b = pck.solve_with_checkpoints(x, w, h, cfg, str(tmp_path), every=10, resume=False,
                                   device="cpu")
    assert a.w.tobytes() == b.w.tobytes() and len(b.cost_history) == 2


def _messages(ours, ref, exc):
    with pytest.raises(exc) as eo:
        ours()
    with pytest.raises(exc) as er:
        ref()
    return str(eo.value), str(er.value)


@pytest.mark.parametrize("case", ["every0", "shape", "sharded_without_mesh"])
def test_refusals_match_jax(tmp_path, case):
    x, w, h = _problem()
    cfg = jt.SolveConfig(max_iter=10)
    if case == "shape":
        jck.solve_with_checkpoints(x, w, h, cfg, str(tmp_path), every=10)
        w, h = w[:, :3], h[:3]
    kw = {"every0": dict(every=0), "shape": {},
          "sharded_without_mesh": dict(sharded_checkpoints=True)}[case]
    ours, ref = _messages(
        lambda: pck.solve_with_checkpoints(x, w, h, _pcfg(cfg), str(tmp_path), device="cpu", **kw),
        lambda: jck.solve_with_checkpoints(x, w, h, cfg, str(tmp_path), **kw), ValueError)
    assert ours == ref


@pytest.mark.parametrize("call", ["mesh", "sharded", "save_sharded", "load_sharded"])
def test_sharded_paths_name_step_12(tmp_path, call):
    """The mesh paths and the sharded checkpoints, refused naming ROADMAP.md
    Queue 1 step 12 when this test was named, are ported
    (tests/test_torch_mesh_paths.py runs them on gloo ranks): what is not a
    ``make_mesh`` DeviceMesh is refused, and a sharded checkpoint of the
    JAX package (an orbax directory) is refused by both loaders, naming its
    format."""
    import json

    x, w, h = _problem()
    if call == "load_sharded":
        step = tmp_path / "step_00000010"
        step.mkdir()
        (step / "meta.json").write_text(json.dumps({"iteration": 10,
                                                    "format": "nmf_tpu.sharded.v1"}))
        with pytest.raises(ValueError, match="orbax format"):
            pck.load_checkpoint(str(step))
        with pytest.raises(TypeError, match="make_mesh"):
            pck.load_checkpoint_sharded(str(step), None)
        return
    fn = {
        "mesh": lambda: pck.solve_with_checkpoints(x, w, h, pt.SolveConfig(), str(tmp_path),
                                                   mesh=object(), device="cpu"),
        "sharded": lambda: pck.solve_with_checkpoints(x, w, h, pt.SolveConfig(), str(tmp_path),
                                                      mesh=object(), sharded_checkpoints=True,
                                                      device="cpu"),
        "save_sharded": lambda: pck.save_checkpoint_sharded(str(tmp_path), None, mesh=object()),
    }[call]
    with pytest.raises(TypeError, match="make_mesh"):
        fn()


def test_a_failed_step_of_a_mesh_keeps_no_frame_of_its_caller_alive():
    """A step of a sharded checkpoint whose part raises on this rank
    re-raises that error on a one-rank gloo mesh, and once the caught error
    is gone nothing local to the step's caller lives on, with the collector
    off: the error is in no reference cycle through the frame that raised
    it.  (Such a cycle kept the caller's frames, a mesh and its groups with
    their gloo threads, alive until the collector ran.)"""
    import gc
    import weakref

    from nmf_tpu_torch.parallel.mesh import shutdown

    class Local:
        pass

    def part():
        raise OSError("no space left on device")

    def caller(mesh, refs):
        local = Local()
        refs.append(weakref.ref(local))
        pck._step_of_mesh(mesh, "step_00000010", part)

    mesh = pt.make_mesh((1, 1), device="cpu")
    collecting = gc.isenabled()
    gc.disable()
    refs = []
    try:
        try:
            caller(mesh, refs)
        except OSError as e:
            assert str(e) == "no space left on device"
        else:
            pytest.fail("the failed part did not raise")
        assert refs[0]() is None, "the caller's frame outlived the caught error"
    finally:
        if collecting:
            gc.enable()
        shutdown()


def test_streamed_resume_shape_mismatch_is_jaxs(tmp_path):
    x, w, h = _problem()
    jstream.solve_out_of_core(x, w, h, jt.SolveConfig(max_iter=4), block_n=16,
                              checkpoint_dir=str(tmp_path))
    ours, ref = _messages(
        lambda: pt.solve_out_of_core(x, w[:, :3], h[:3], pt.SolveConfig(max_iter=8), block_n=16,
                                     checkpoint_dir=str(tmp_path), device="cpu"),
        lambda: jstream.solve_out_of_core(x, w[:, :3], h[:3], jt.SolveConfig(max_iter=8),
                                          block_n=16, checkpoint_dir=str(tmp_path)),
        ValueError)
    assert ours == ref


def test_public_names():
    from nmf_tpu import utils as jutils
    from nmf_tpu_torch import utils

    assert set(jutils.__all__) <= set(utils.__all__)
    for name in ("CheckpointState", "save_checkpoint", "load_checkpoint", "latest_checkpoint",
                 "solve_with_checkpoints"):
        assert getattr(utils, name) is getattr(pck, name)


def test_chip_smoke_lists_utils_launches():
    """Phase 15's runs in the kernels line: each kernel's launches on the
    checkpointed, live and streamed-resume runs, 0 where a run has none."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_utils_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = {"float32": {"update_h": 200},
                "utils checkpointed plain": {"update_h": 200, "kl_cost": 8},
                "utils tiled checkpointed": {"update_h": 0, "h_numerator": 200}}
    assert smoke._utils_launches(launches, "update_h") == {"checkpointed plain": 200,
                                                            "tiled checkpointed": 0}
    assert smoke._utils_launches(launches, "h_numerator") == {"checkpointed plain": 0,
                                                               "tiled checkpointed": 200}
    # phases 16-20 (sparse, backend, mesh, serving, examples) follow phase 15 (utils)
    assert smoke.PHASES[-6:] == ("utils", "sparse", "backend", "mesh", "serving", "examples")
    assert smoke.UTILS_CKPT_EVERY == 50
