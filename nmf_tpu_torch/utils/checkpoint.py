"""Checkpoint / resume for long factorizations.

Counterpart of ``nmf_tpu.utils.checkpoint``, on the same on-disk format, so
that either package resumes the other's run:

  * ``<directory>/step_%08d/`` holds ``W.bin`` and ``H.bin`` (the reference
    ``.bin`` format), ``Wex.bin`` and ``Hex.bin`` for an accelerated run
    (its extrapolated pair), and ``meta.json``: the iteration, the cost
    history, the global iteration of each check, the converged flag, the
    accelerated loop's momentum (null when none) and the fingerprint of the
    config fields that change the objective or its trajectory;
  * a step is written into a ``.tmp_ckpt_*`` directory and renamed into
    place; a same-step overwrite parks the old copy as
    ``.old_step_NNNNNNNN_<pid>`` between two renames, and
    :func:`_recover_and_sweep` restores or drops a copy parked by a crash.

:func:`solve_with_checkpoints` runs the solve in segments of ``every``
iterations through the port's own solves, on the card by default: dense X
through :func:`~nmf_tpu_torch.solve` (K1-K3), a
:class:`~nmf_tpu_torch.TileSparseX` through the tile-sparse solve (K5), X
prepared (clamped, cast or quantized) once for the whole run and the
factors kept on the device between segments.  The streamed solve
checkpoints itself (``solve_out_of_core(checkpoint_dir=...)``).

Not in the port yet: the sharded checkpoints (``save_checkpoint_sharded``,
``load_checkpoint_sharded``, ``sharded_checkpoints=True``) and ``mesh=``,
ROADMAP.md Queue 1 step 12b.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import List, Optional

import numpy as np

from ..io import binio
from .config import SolveConfig

__all__ = [
    "CheckpointState",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "solve_with_checkpoints",
    "save_checkpoint_sharded",
    "load_checkpoint_sharded",
]

_META = "meta.json"
_SHARDED = ("sharded checkpoints and mesh= (ROADMAP.md Queue 1 step 12b: checkpoints on a mesh) "
            "are not in the PyTorch port yet")


@dataclasses.dataclass
class CheckpointState:
    """A run's resume state: the factors as f32 NumPy arrays
    (``save_checkpoint`` also takes tensors on any device, or bf16, and
    writes them as f32), the iteration, the cost history and the global
    iteration of each of its checks (None for checkpoints written without
    them), the accelerated loop's momentum (NaN when none) and extrapolated
    pair (None when none)."""

    w: np.ndarray
    h: np.ndarray
    iteration: int
    cost_history: List[float]
    converged: bool = False
    check_iterations: Optional[List[int]] = None
    momentum: float = float("nan")
    w_ex: Optional[np.ndarray] = None
    h_ex: Optional[np.ndarray] = None


def _config_fingerprint(config: SolveConfig) -> dict:
    """Every field that changes the optimisation objective or its trajectory
    (the keys and order of ``nmf_tpu``'s, so ``meta.json`` is byte-equal)."""
    return {
        "eps": config.eps,
        "beta": config.beta,
        "algorithm": config.algorithm,
        "matmul_dtype": config.precision.matmul_dtype,
        "x_dtype": config.precision.x_dtype,
        "x_quant_rows": config.precision.x_quant_rows,
        "accelerate": config.accelerate,
        "check_every": config.check_every,
        "l1_w": config.l1_w,
        "l1_h": config.l1_h,
        "l2_w": config.l2_w,
        "l2_h": config.l2_h,
    }


def _fingerprint_mismatch(have: dict, want: dict) -> bool:
    """True if a field PRESENT in the stored fingerprint disagrees (a key
    missing from an older checkpoint is compatible)."""
    return any(k in have and have[k] != want[k] for k in want)


def _recover_and_sweep(directory: str, sweep_tmp: bool = True) -> None:
    """Best-effort clean-up of what a crashed ``save_checkpoint`` left.

    A step parked under ``.old_step_NNN_<pid>`` is put back when its step
    vanished and dropped when the step exists; with ``sweep_tmp`` (a
    writer's call only: the directory has one writer) abandoned
    ``.tmp_ckpt_*`` staging directories go too.  A reader never sweeps
    them: it could delete a live writer's staging directory.
    """
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    for name in entries:
        path = os.path.join(directory, name)
        try:
            if name.startswith(".old_step_"):
                step = name[len(".old_"):].rsplit("_", 1)[0]
                step_dir = os.path.join(directory, step)
                if os.path.exists(step_dir):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.rename(path, step_dir)
            elif sweep_tmp and name.startswith(".tmp_ckpt_"):
                shutil.rmtree(path, ignore_errors=True)
        except OSError:
            pass  # clean-up is best effort: never fail a save or a listing over it


def _f32(a) -> np.ndarray:
    """A factor as an f32 NumPy array (a tensor on any device, or bf16)."""
    if hasattr(a, "detach"):
        a = a.detach().float().cpu()
    return np.asarray(a, np.float32)


def save_checkpoint(directory: str, state: CheckpointState,
                    config: Optional[SolveConfig] = None) -> str:
    """Write ``<directory>/step_<iteration>`` atomically; returns its path."""
    os.makedirs(directory, exist_ok=True)
    _recover_and_sweep(directory)
    step_dir = os.path.join(directory, f"step_{state.iteration:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        binio.write_matrix(_f32(state.w), os.path.join(tmp, "W.bin"))
        binio.write_matrix(_f32(state.h), os.path.join(tmp, "H.bin"))
        if state.w_ex is not None:
            binio.write_matrix(_f32(state.w_ex), os.path.join(tmp, "Wex.bin"))
            binio.write_matrix(_f32(state.h_ex), os.path.join(tmp, "Hex.bin"))
        meta = {
            "iteration": int(state.iteration),
            "cost_history": [float(c) for c in state.cost_history],
            "converged": bool(state.converged),
            "check_iterations": (
                [int(i) for i in state.check_iterations]
                if state.check_iterations is not None else None
            ),
            # null when NaN: portable JSON
            "momentum": float(state.momentum) if state.momentum == state.momentum else None,
            "config": _config_fingerprint(config) if config else None,
            "format": "nmf_tpu.v1",
        }
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        if os.path.exists(step_dir):
            # same-step overwrite: the parked name is dot-prefixed, so a
            # crash between the two renames never leaves a directory that
            # latest_checkpoint would take for a step
            old = os.path.join(directory, f".old_{os.path.basename(step_dir)}_{os.getpid()}")
            os.rename(step_dir, old)
            try:
                os.rename(tmp, step_dir)
            except BaseException:
                # the step must never vanish: put the parked copy back
                if not os.path.exists(step_dir):
                    os.rename(old, step_dir)
                raise
            shutil.rmtree(old)
        else:
            os.rename(tmp, step_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return step_dir


def load_checkpoint(step_dir: str, config: Optional[SolveConfig] = None) -> CheckpointState:
    """Load a checkpoint; with ``config``, refuse one written under another
    objective or trajectory (its fingerprint)."""
    with open(os.path.join(step_dir, _META)) as f:
        meta = json.load(f)
    if config is not None and meta.get("config") is not None:
        want = _config_fingerprint(config)
        have = meta["config"]
        if _fingerprint_mismatch(have, want):
            raise ValueError(
                f"checkpoint {step_dir} was written with config {have}, "
                f"resume requested with {want}; refusing to mix objectives"
            )
    wex_path = os.path.join(step_dir, "Wex.bin")
    has_ex = os.path.exists(wex_path)
    return CheckpointState(
        w=binio.read_matrix(os.path.join(step_dir, "W.bin")),
        h=binio.read_matrix(os.path.join(step_dir, "H.bin")),
        w_ex=binio.read_matrix(wex_path) if has_ex else None,
        h_ex=binio.read_matrix(os.path.join(step_dir, "Hex.bin")) if has_ex else None,
        iteration=int(meta["iteration"]),
        cost_history=list(meta.get("cost_history", [])),
        converged=bool(meta.get("converged", False)),
        check_iterations=meta.get("check_iterations"),
        momentum=float(meta["momentum"]) if meta.get("momentum") is not None else float("nan"),
    )


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest complete ``step_*`` directory under ``directory``, or None.
    Puts back a step parked by a crash (:func:`_recover_and_sweep`), and
    never sweeps staging directories (it is a read path)."""
    if not os.path.isdir(directory):
        return None
    _recover_and_sweep(directory, sweep_tmp=False)
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and d[len("step_"):].isdigit()
        and os.path.exists(os.path.join(directory, d, _META))
    )
    return os.path.join(directory, steps[-1]) if steps else None


def save_checkpoint_sharded(*args, **kwargs):
    """Refused: the sharded (orbax) checkpoints are ROADMAP.md Queue 1 step 12b."""
    raise NotImplementedError(_SHARDED)


def load_checkpoint_sharded(*args, **kwargs):
    """Refused: the sharded (orbax) checkpoints are ROADMAP.md Queue 1 step 12b."""
    raise NotImplementedError(_SHARDED)


def _resume(directory: str, config: SolveConfig, w0, h0) -> Optional[CheckpointState]:
    """The newest checkpoint's state, its shapes checked against the inputs."""
    latest = latest_checkpoint(directory)
    if latest is None:
        return None
    state = load_checkpoint(latest, config)
    if tuple(np.shape(state.w)) != tuple(np.shape(w0)) or tuple(np.shape(state.h)) != tuple(np.shape(h0)):
        raise ValueError(
            f"checkpoint shapes {np.shape(state.w)}/{np.shape(state.h)} "
            f"do not match inputs {np.shape(w0)}/{np.shape(h0)}"
        )
    return state


def solve_with_checkpoints(x, w0, h0, config: SolveConfig, directory: str, every: int = 100,
                           resume: bool = True, mesh=None, sharded_checkpoints: bool = False,
                           device="cuda") -> CheckpointState:
    """Checkpointed (and resumable) solve (``checkpoint.py:420-704`` of the
    JAX package).

    Runs ``config.max_iter`` iterations in all, in segments of ``every``,
    and checkpoints after each.  With ``resume`` and a checkpoint in
    ``directory`` it continues from the newest one (``w0``/``h0`` then give
    only the shapes, which must match).  Returns the final state, its cost
    history stitched across segments and its check labels global.

    X (dense, or a :class:`~nmf_tpu_torch.TileSparseX`) is placed on
    ``device`` and prepared once: dense X clamped to eps in f32 and cast to
    ``x_dtype`` or quantized (``x_dtype="int8"``), W and H clamped in the
    state dtype, then each segment is an unclamped
    :func:`~nmf_tpu_torch.solve` (the fused kernels on the card); tile-sparse
    X is tiled, padded and planned once and each segment is a
    :func:`~nmf_tpu_torch.models.sparse_tiled._run_tiled` on the padded
    factors (K5 on the card), the files holding the cropped ones.  The
    factors stay on the device between segments; each segment gets the last
    check's cost as its baseline, and under ``accelerate`` the momentum and
    the extrapolated pair, so a segmented run, and a resumed one, takes the
    steps of the uninterrupted run.  The factors of a resumed run are the
    checkpoint's as they are: ``nmf_tpu`` clamps them to eps again on
    resume, which changes an entry an update took below eps (seen under
    ``accelerate``) and so the resumed run; the port skips that clamp, so
    that resumed equals uninterrupted bit for bit, as JAX's docstring
    promises.  Fresh inputs get the reference's load-time clamp in both.

    ``mesh`` and ``sharded_checkpoints`` are refused (ROADMAP.md Queue 1
    step 12b).
    """
    import torch

    from ..models.solver import _prep, solve, to_state
    from ..models.sparse_tiled import _CHUNK, TileSparseX, _prepare_tiled, _run_tiled
    from .device import resolve_device

    config.validate()
    if every <= 0:
        raise ValueError("every must be >= 1")
    if sharded_checkpoints and mesh is None:
        raise ValueError("sharded_checkpoints=True requires a mesh")
    if mesh is not None or sharded_checkpoints:
        raise NotImplementedError(_SHARDED)
    dev = resolve_device(device)

    start_iter, cost_history, check_iterations = 0, [], []
    last_mom, last_ex, converged = float("nan"), None, False
    w, h = w0, h0
    state = _resume(directory, config, w0, h0) if resume else None
    if state is not None:
        w, h, start_iter = state.w, state.h, state.iteration
        cost_history = state.cost_history
        converged = state.converged
        check_iterations = list(state.check_iterations or [])
        last_mom = float(state.momentum)
        if state.w_ex is not None:
            last_ex = (state.w_ex, state.h_ex)

    if isinstance(x, TileSparseX):
        # tiles, plans and padded factors prepared once; the files hold the
        # cropped factors, and a resumed carry is padded back with zeros
        # (the padded rows and columns see zero numerators)
        xarg, w_dev, h_dev, info = _prepare_tiled(x, w, h, config, _CHUNK, x.tile_shape, dev)
        m, n = info["m"], info["n"]
        if state is not None:   # resumed factors go in unclamped (docstring)
            w_dev[:m] = to_state(state.w, config, dev, clamp=False)
            h_dev[:, :n] = to_state(state.h, config, dev, clamp=False)
        if last_ex is not None:
            wex, hex_ = torch.zeros_like(w_dev), torch.zeros_like(h_dev)
            wex[:m] = to_state(last_ex[0], config, dev, clamp=False)
            hex_[:, :n] = to_state(last_ex[1], config, dev, clamp=False)
            last_ex = (wex, hex_)

        def segment(w_dev, h_dev, seg_cfg, last_cost, last_mom, last_ex):
            return _run_tiled(xarg, w_dev, h_dev, seg_cfg, info, last_cost, last_mom, last_ex)
    else:
        m = n = None   # nothing to crop
        x_dev, w_dev, h_dev = _prep(x, w, h, config, True, dev)
        if state is not None:   # resumed factors go in unclamped (docstring)
            w_dev, h_dev = (to_state(a, config, dev, clamp=False) for a in (state.w, state.h))
        if last_ex is not None:
            last_ex = tuple(to_state(a, config, dev, clamp=False) for a in last_ex)

        def segment(w_dev, h_dev, seg_cfg, last_cost, last_mom, last_ex):
            return solve(x_dev, w_dev, h_dev, seg_cfg, clamp_inputs=False,
                         initial_cost=last_cost, device=dev, initial_momentum=last_mom,
                         initial_extrap=last_ex)
    del w, h

    def host(w_t, h_t):
        """The logical (cropped) factors as f32 NumPy arrays."""
        return _f32(w_t[:m]), _f32(h_t[:, :n])

    it = start_iter
    last_cost = cost_history[-1] if cost_history else float("nan")
    state = None
    while it < config.max_iter and not converged:
        seg_cfg = dataclasses.replace(config, max_iter=min(every, config.max_iter - it))
        if config.accelerate and last_ex is None:
            last_ex = (w_dev, h_dev)   # the first segment's carry starts at the iterate
        res = segment(w_dev, h_dev, seg_cfg, last_cost, last_mom, last_ex)
        w_dev, h_dev = res.w, res.h
        seg_iters, n_checks = int(res.iterations), int(res.num_checks)
        seg_hist = [float(c) for c in res.cost_history.cpu().numpy()[:n_checks]]
        check_iterations.extend(it + min((i + 1) * config.check_every, seg_iters)
                                for i in range(n_checks))
        it += seg_iters
        cost_history.extend(seg_hist)
        if seg_hist:
            last_cost = seg_hist[-1]
        if res.momentum is not None:
            last_mom = float(res.momentum)
        if res.w_ex is not None:
            last_ex = (res.w_ex, res.h_ex)
        converged = bool(res.converged)
        w_ex, h_ex = host(res.w_ex, res.h_ex) if res.w_ex is not None else (None, None)
        state = CheckpointState(*host(res.w, res.h), it, cost_history, converged,
                                check_iterations, momentum=last_mom, w_ex=w_ex, h_ex=h_ex)
        save_checkpoint(directory, state, config)
    if state is None:
        # a resumed run that was already complete: no segment ran
        state = CheckpointState(*host(w_dev, h_dev), it, cost_history, converged,
                                check_iterations, momentum=last_mom)
    return state
