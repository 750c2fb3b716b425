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

On a mesh (``mesh=``, one process a rank) the segments are the sharded
solve's (:func:`~nmf_tpu_torch.solve_sharded`'s loop on each rank's
blocks, X prepared once).  By default the factors are gathered and rank 0
writes the ``.bin`` checkpoint above, which either package and any mesh
shape resumes.  ``sharded_checkpoints=True`` writes the port's own sharded
format instead (:func:`save_checkpoint_sharded`: each rank its own blocks,
``format`` ``"nmf_tpu_torch.sharded.v1"``).  The JAX package's sharded
checkpoints are orbax directories (``"nmf_tpu.sharded.v1"``): neither
package reads the other's sharded checkpoints, and each loader says so.
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
_FORMAT = "nmf_tpu.v1"
SHARDED_FORMAT = "nmf_tpu_torch.sharded.v1"
_JAX_SHARDED_FORMAT = "nmf_tpu.sharded.v1"   # the JAX package's orbax directories


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
            "format": _FORMAT,
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
    meta = _read_meta(step_dir, config)
    if meta.get("format") in (SHARDED_FORMAT, _JAX_SHARDED_FORMAT):
        raise ValueError(
            f"checkpoint {step_dir} is a sharded checkpoint (format {meta['format']!r}), "
            f"not a .bin one: {_SHARDED_READER[meta['format']]}"
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


_SHARDED_READER = {
    SHARDED_FORMAT: "load it with load_checkpoint_sharded on the mesh shape that wrote it",
    _JAX_SHARDED_FORMAT: "it is the JAX package's orbax format, which the PyTorch port "
                         "does not read (resume it with nmf_tpu, or write .bin checkpoints)",
}


def _read_meta(step_dir: str, config: Optional[SolveConfig]) -> dict:
    """A step's ``meta.json``; with ``config``, the fingerprint refusal."""
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
    return meta


def _durable(path: str, write) -> None:
    """``write(f)`` into a staging file beside ``path``, fsynced, then
    renamed onto ``path``: a reader sees the old file or the whole new one."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _shard_file(step_dir: str, coord) -> str:
    return os.path.join(step_dir, f"shard_r{coord[0]:04d}_c{coord[1]:04d}.npz")


def _all_ok(mesh, ok: bool) -> bool:
    """A barrier over the mesh's ranks that also tells whether every rank
    got through its part (a one-element sum over both axes, read back)."""
    import torch

    from ..parallel.mesh import BOTH, mesh_device, psum

    bad = torch.tensor([0 if ok else 1], dtype=torch.int32, device=mesh_device(mesh))
    return int(psum(bad, mesh, BOTH).cpu()[0]) == 0


def _step_of_mesh(mesh, step_dir: str, part) -> None:
    """Run ``part()`` on every rank of the mesh, then agree: if any rank
    failed, every rank raises (the failed one its own error)."""
    err = None
    try:
        part()
    except BaseException as e:   # re-raised below, after the others have heard
        err = e
    try:
        if not _all_ok(mesh, err is None):
            if err is not None:
                raise err
            raise RuntimeError(f"sharded checkpoint {step_dir}: another rank failed its part")
    finally:
        # the raised error's traceback holds this frame: without this, the
        # frame's err would close a cycle that keeps every caller's frame
        # (the mesh, its groups and their gloo threads) alive until the
        # collector runs
        err = None


def save_checkpoint_sharded(directory: str, state: CheckpointState,
                            config: Optional[SolveConfig] = None, *, mesh,
                            layout: str = "canonical") -> str:
    """A checkpoint whose factors stay sharded: each rank of ``mesh`` writes
    only its own blocks (``state.w``/``state.h``, and the extrapolated
    pair, as tensors or arrays: the rank's blocks) to
    ``step_NNNNNNNN/shard_rRRRR_cCCCC.npz``.  Every rank calls it.

    The pod-safety rules of the JAX package's (``checkpoint.py:277-357``):
    ``meta.json`` is written by the rank at (0, 0) only, and only after
    every rank's shard is durable (each fsynced and renamed into place),
    itself fsynced and renamed into place; a step being rewritten loses
    its meta first; :func:`latest_checkpoint` sees a step only once it has
    its meta; and the ranks meet after each part, so that none returns (or
    reads the step) while another is still writing, and a failure on one
    rank raises on all.  The meta records the mesh shape and the blocks'
    ``layout`` (``"canonical"``, or the streamed solve's
    ``"streamed:<block width>"``), which :func:`load_checkpoint_sharded`
    checks.  Returns the step's path.
    """
    from ..parallel.mesh import COL_AXIS, ROW_AXIS, axis_size, check_mesh, mesh_coordinate

    mesh = check_mesh(mesh)
    coord = mesh_coordinate(mesh)
    lead = coord == (0, 0)
    step_dir = os.path.abspath(os.path.join(directory, f"step_{state.iteration:08d}"))
    meta_path = os.path.join(step_dir, _META)

    def hide():
        os.makedirs(step_dir, exist_ok=True)
        if lead and os.path.exists(meta_path):
            os.unlink(meta_path)    # a rewritten step is invisible until its new meta

    def shard():
        arrays = {"w": _f32(state.w), "h": _f32(state.h)}
        if state.w_ex is not None:
            arrays.update(w_ex=_f32(state.w_ex), h_ex=_f32(state.h_ex))
        _durable(_shard_file(step_dir, coord), lambda f: np.savez(f, **arrays))

    def meta():
        if not lead:
            return
        body = {
            "iteration": int(state.iteration),
            "cost_history": [float(c) for c in state.cost_history],
            "converged": bool(state.converged),
            "check_iterations": (
                [int(i) for i in state.check_iterations]
                if state.check_iterations is not None else None
            ),
            "momentum": float(state.momentum) if state.momentum == state.momentum else None,
            "has_extrap": state.w_ex is not None,
            "config": _config_fingerprint(config) if config else None,
            "format": SHARDED_FORMAT,
            "mesh": [axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)],
            "layout": layout,
        }
        _durable(meta_path, lambda f: f.write(json.dumps(body).encode()))

    for part in (hide, shard, meta):
        _step_of_mesh(mesh, step_dir, part)
    return step_dir


def load_checkpoint_sharded(step_dir: str, mesh, config: Optional[SolveConfig] = None,
                            layout: Optional[str] = "canonical") -> CheckpointState:
    """This rank's blocks of a :func:`save_checkpoint_sharded` step (f32
    NumPy arrays), with the replicated scalars.  With ``config``, the
    fingerprint refusal of :func:`load_checkpoint`.  A step written on
    another mesh shape, or in another ``layout`` (None: any), raises
    ``ValueError``: each rank's file holds the writer's blocks."""
    from ..parallel.mesh import COL_AXIS, ROW_AXIS, axis_size, check_mesh, mesh_coordinate

    mesh = check_mesh(mesh)
    meta = _read_meta(step_dir, config)
    fmt = meta.get("format")
    if fmt != SHARDED_FORMAT:
        hint = (_SHARDED_READER[_JAX_SHARDED_FORMAT] if fmt == _JAX_SHARDED_FORMAT
                else "load it with load_checkpoint")
        raise ValueError(f"checkpoint {step_dir} is not a sharded checkpoint of the PyTorch "
                         f"port (format {fmt!r}): {hint}")
    here = [axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)]
    if list(meta["mesh"]) != here:
        raise ValueError(
            f"checkpoint {step_dir} was written on a {meta['mesh'][0]}x{meta['mesh'][1]} mesh "
            f"and this run's mesh is {here[0]}x{here[1]}: each rank's shard holds the writer's "
            f"blocks; resume on the writer's mesh shape, or write gathered .bin checkpoints "
            f"(sharded_checkpoints=False), which any mesh resumes"
        )
    if layout is not None and meta.get("layout") != layout:
        raise ValueError(f"checkpoint {step_dir} holds the {meta.get('layout')!r} layout of "
                         f"the factors, this run reads {layout!r}")
    with np.load(_shard_file(step_dir, mesh_coordinate(mesh))) as z:
        arrays = {key: z[key] for key in z.files}
    return CheckpointState(
        w=arrays["w"], h=arrays["h"], w_ex=arrays.get("w_ex"), h_ex=arrays.get("h_ex"),
        iteration=int(meta["iteration"]),
        cost_history=list(meta.get("cost_history", [])),
        converged=bool(meta.get("converged", False)),
        check_iterations=meta.get("check_iterations"),
        momentum=float(meta["momentum"]) if meta.get("momentum") is not None else float("nan"),
    )


def _resume(directory: str, config: SolveConfig, w0, h0, mesh=None,
            sharded: bool = False) -> Optional[CheckpointState]:
    """The newest checkpoint's state, its shapes checked against the inputs
    (a sharded one's against this rank's blocks of them)."""
    latest = latest_checkpoint(directory)
    if latest is None:
        return None
    want_w, want_h = tuple(np.shape(w0)), tuple(np.shape(h0))
    if sharded:
        from ..parallel.mesh import factor_shapes

        state = load_checkpoint_sharded(latest, mesh, config)
        _, want_w, want_h = factor_shapes(want_w[0], want_w[1], want_h[1], mesh)
    else:
        state = load_checkpoint(latest, config)
    if tuple(np.shape(state.w)) != want_w or tuple(np.shape(state.h)) != want_h:
        raise ValueError(
            f"checkpoint shapes {np.shape(state.w)}/{np.shape(state.h)} "
            f"do not match inputs {want_w}/{want_h}"
        )
    return state


def solve_with_checkpoints(x, w0, h0, config: SolveConfig, directory: str, every: int = 100,
                           resume: bool = True, mesh=None, sharded_checkpoints: bool = False,
                           device="cuda") -> Optional[CheckpointState]:
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

    ``mesh`` (every rank calls it with the same global inputs): each rank
    prepares its blocks of X once (the tiled solve: its tiles) and each
    segment is the sharded loop on its blocks, on the mesh's devices.  By
    default the factors are gathered and the rank at (0, 0) writes the
    ``.bin`` checkpoint, and every rank returns the global state;
    ``sharded_checkpoints=True`` writes :func:`save_checkpoint_sharded`'s
    format, each rank its own blocks, and returns this rank's blocks
    (dense X only, as in JAX).  A rank outside the mesh gets None.
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
    tiled = isinstance(x, TileSparseX)
    if tiled and sharded_checkpoints:
        raise NotImplementedError(
            "tile-sparse checkpointing stores the cropped logical "
            "factors; orbax sharded checkpoints would need padded-shape "
            "restore plumbing — use the default host checkpoints"
        )
    if mesh is not None:
        from ..parallel.mesh import (
            COL_AXIS,
            ROW_AXIS,
            Placement,
            check_mesh,
            local_block,
            mesh_coordinate,
            mesh_device,
        )
        from ..parallel.sharded import (
            _fused_for,
            _local_problem,
            build_sharded_solver,
            gather_result,
        )

        mesh = check_mesh(mesh)
        if mesh_coordinate(mesh) is None:
            return None
        dev = mesh_device(mesh)
        w_place, h_place = Placement(mesh, (ROW_AXIS, None)), Placement(mesh, (None, COL_AXIS))
    else:
        dev = resolve_device(device)

    start_iter, cost_history, check_iterations = 0, [], []
    last_mom, last_ex, converged = float("nan"), None, False
    w, h = w0, h0
    state = _resume(directory, config, w0, h0, mesh, sharded_checkpoints) if resume else None
    if state is not None:
        w, h, start_iter = state.w, state.h, state.iteration
        cost_history = state.cost_history
        converged = state.converged
        check_iterations = list(state.check_iterations or [])
        last_mom = float(state.momentum)
        if state.w_ex is not None:
            last_ex = (state.w_ex, state.h_ex)

    def lay(a, place):
        """A resumed factor as this run holds it: a gathered checkpoint's
        global factor cut to this rank's block on a mesh."""
        if mesh is None or sharded_checkpoints:
            return a
        return local_block(a, place, "cpu")

    if tiled:
        # tiles, plans and padded factors prepared once; the files hold the
        # cropped factors, and a resumed carry is padded back with zeros
        # (the padded rows and columns see zero numerators)
        xarg, w_dev, h_dev, info = _prepare_tiled(x, w, h, config, _CHUNK, x.tile_shape, dev,
                                                  mesh=mesh)
        m, n = info["m"], info["n"]

        def padded(a, like, rows: bool):
            """A cropped global factor padded with zeros (this rank's block
            of it on a mesh), unclamped, in the state dtype."""
            full = torch.zeros((info["mp"], like.shape[1]) if rows else
                               (like.shape[0], info["np_"]), dtype=torch.float32)
            t = torch.from_numpy(np.asarray(a, np.float32))
            if rows:
                full[:m] = t
            else:
                full[:, :n] = t
            if mesh is not None:
                full = local_block(full, w_place if rows else h_place, "cpu")
            return to_state(full, config, dev, clamp=False)

        if state is not None:   # resumed factors go in unclamped (docstring)
            w_dev, h_dev = padded(state.w, w_dev, True), padded(state.h, h_dev, False)
        if last_ex is not None:
            last_ex = (padded(last_ex[0], w_dev, True), padded(last_ex[1], h_dev, False))

        def segment(w_dev, h_dev, seg_cfg, last_cost, last_mom, last_ex):
            return _run_tiled(xarg, w_dev, h_dev, seg_cfg, info, last_cost, last_mom, last_ex)
    elif mesh is not None:
        m = n = None
        fused = _fused_for(config, w0, h0, mesh, "sharded")
        x_dev, w_dev, h_dev = _local_problem(x, w0, h0, config, True, mesh)
        if state is not None:   # resumed factors go in unclamped (docstring)
            w_dev = to_state(lay(state.w, w_place), config, dev, clamp=False)
            h_dev = to_state(lay(state.h, h_place), config, dev, clamp=False)
        if last_ex is not None:
            last_ex = (to_state(lay(last_ex[0], w_place), config, dev, clamp=False),
                       to_state(lay(last_ex[1], h_place), config, dev, clamp=False))

        def segment(w_dev, h_dev, seg_cfg, last_cost, last_mom, last_ex):
            return build_sharded_solver(seg_cfg, mesh, fused)(
                x_dev, w_dev, h_dev, last_cost, last_mom, initial_extrap=last_ex)
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

    def host(res):
        """The state's factors (and carry) as f32 NumPy arrays: global and
        cropped, or this rank's blocks under ``sharded_checkpoints``."""
        if mesh is not None and not sharded_checkpoints:
            res = gather_result(res, mesh)
        out = []
        for a, rows in ((res.w, True), (res.h, False), (res.w_ex, True), (res.h_ex, False)):
            if a is not None and not sharded_checkpoints:
                a = a[:m] if rows else a[:, :n]
            out.append(None if a is None else _f32(a))
        return out

    def write(state):
        if sharded_checkpoints:
            save_checkpoint_sharded(directory, state, config, mesh=mesh)
        elif mesh is None:
            save_checkpoint(directory, state, config)
        else:   # the (0, 0) rank writes, and the mesh meets after it
            _step_of_mesh(mesh, directory, lambda: mesh_coordinate(mesh) == (0, 0)
                          and save_checkpoint(directory, state, config))

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
        w_h, h_h, w_ex, h_ex = host(res)
        state = CheckpointState(w_h, h_h, it, cost_history, converged, check_iterations,
                                momentum=last_mom, w_ex=w_ex, h_ex=h_ex)
        write(state)
    if state is None:
        # a resumed run that was already complete: no segment ran
        from ..models.solver import SolveResult

        w_h, h_h, _, _ = host(SolveResult(w=w_dev, h=h_dev, iterations=None, cost=None,
                                          cost_history=None, num_checks=None, converged=None))
        state = CheckpointState(w_h, h_h, it, cost_history, converged, check_iterations,
                                momentum=last_mom)
    return state
