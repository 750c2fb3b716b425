"""The device mesh and the sharding layout of the distributed solves.

Counterpart of ``nmf_tpu.parallel.mesh``.  JAX runs one program over a
``Mesh`` of devices; the port runs PyTorch's SPMD idiom instead: one
process per rank, each driving one device, joined by ``torch.distributed``
(NCCL on the card, gloo on the CPU).  The grid is a
``torch.distributed.device_mesh.DeviceMesh`` with the dimension names
``(ROW_AXIS, COL_AXIS)``; its row and column process groups
(``mesh.get_group(ROW_AXIS)``, ``mesh.get_group(COL_AXIS)``) carry the
K-sized sums of :mod:`nmf_tpu_torch.parallel.sharded`.

Layout (JAX's, ``mesh.py:1-27`` of the JAX package)::

    mesh axes:    ('mr', 'mc')  - rows / columns of X
    X:  ('mr', 'mc')            - 2-D blocks
    W:  ('mr', None)            - row blocks, replicated over 'mc'
    H:  (None, 'mc')            - column blocks, replicated over 'mr'

With K replicated, a rank's ``W_loc @ H_loc`` is exactly its block of
``W @ H``: the reconstruction needs no communication.  A layout here is a
:class:`Placement`: the mesh and a spec, one entry per tensor dimension,
the axis it is split over or None.  :func:`local_block` cuts a rank's
block out of a global array; :func:`gather` puts the blocks of all ranks
back together on every rank.

A spec entry may also be a tuple of axes (JAX's ``P(('mr', 'mc'))``): the
dimension is split over their ranks taken together, row-major (rank
``(i, j)`` of an R x C mesh holds piece ``i * C + j``).  :class:`FlatMesh`
reads a mesh's ranks as one such axis (JAX's ``Mesh(devices.flat,
(name,))``), as the batched and restart solves flatten it.

A rank beyond ``R * C`` of the world has no coordinate on the mesh and
takes no part, as JAX's mesh takes the first ``R * C`` devices.
:func:`shutdown` leaves a process group in order at the end of a run.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.convert import to_tensor
from ..utils.device import resolve_device

__all__ = [
    "ROW_AXIS",
    "COL_AXIS",
    "Placement",
    "FlatMesh",
    "make_mesh",
    "check_mesh",
    "mesh_shape",
    "mesh_device",
    "mesh_coordinate",
    "axis_size",
    "factor_shapes",
    "nmf_shardings",
    "quant_scale_spec",
    "quant_scale_spec_for",
    "local_block",
    "shard_problem",
    "psum",
    "gather",
    "init_distributed",
    "shutdown",
]

ROW_AXIS = "mr"  # shards M (rows of X / rows of W)
COL_AXIS = "mc"  # shards N (cols of X / cols of H)
BOTH = (ROW_AXIS, COL_AXIS)

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


class Placement(NamedTuple):
    """A layout on a mesh: ``spec[d]`` is the axis that splits dimension
    ``d``, a tuple of axes that split it together, or None (replicated) -
    JAX's ``NamedSharding(mesh, P(*spec))``."""

    mesh: DeviceMesh
    spec: Spec


class FlatMesh(NamedTuple):
    """The ranks of a 2-D mesh read as ONE axis named ``name``: JAX's
    ``Mesh(np.asarray(list(mesh.devices.flat)), (name,))``, which its CLI
    and ``NMF`` build for pure data parallelism over members.  Its axis is
    ``BOTH`` in a spec; it makes no process group of its own."""

    mesh: DeviceMesh
    name: str = "members"


def mesh_shape(n: int, shape: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """(R, C) of a mesh over ``n`` ranks: ``shape``, or the most-square
    factorization of ``n`` with more row shards (``mesh.py:62-66`` of the
    JAX package).  ``ValueError`` when ``R * C`` exceeds ``n``."""
    if shape is None:
        r = int(np.sqrt(n))
        while n % r != 0:
            r -= 1
        shape = (max(r, n // r), min(r, n // r))
    shape = (int(shape[0]), int(shape[1]))
    need = shape[0] * shape[1]
    if need > n:
        raise ValueError(f"mesh shape {shape} needs {need} devices, have {n}")
    return shape


def make_mesh(shape: Optional[Tuple[int, int]] = None, device="cuda") -> DeviceMesh:
    """A 2-D ``(ROW_AXIS, COL_AXIS)`` ``DeviceMesh`` over the first ``R * C``
    ranks of the world, on ``device``'s type (``"cuda"`` by default, as
    every entry point of the port; ``"cpu"`` for gloo on the host).

    ``shape=None`` takes :func:`mesh_shape`'s factorization of the world
    size.  Every rank calls it (the mesh's process groups are made
    collectively).  In a process with no process group (a plain script, no
    launcher) the world is this one process: ``make_mesh`` first makes a
    one-rank group over an in-process ``HashStore`` (NCCL for ``"cuda"``,
    gloo for ``"cpu"``), so a 1x1 mesh works anywhere, as JAX's mesh over
    one device does.  Under a launcher call :func:`init_distributed` first.
    """
    dev = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    r, c = mesh_shape(n, shape)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev.index)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    elif dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev.index)
    return DeviceMesh(dev.type, torch.arange(r * c).reshape(r, c), mesh_dim_names=BOTH)


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a 2-D ``DeviceMesh`` with the dimension names
    ``(ROW_AXIS, COL_AXIS)`` (:func:`make_mesh`'s), else ``TypeError``."""
    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != BOTH:
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh with the dimension names "
            f"{BOTH} (nmf_tpu_torch.make_mesh builds one), got {type(mesh).__name__}"
        )
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks live on: its current CUDA device for
    a ``"cuda"`` mesh (``init_distributed`` binds it to ``LOCAL_RANK``)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_coordinate(mesh: DeviceMesh) -> Optional[Tuple[int, int]]:
    """This rank's (row, column) on the mesh, None beyond ``R * C``."""
    coord = mesh.get_coordinate()
    return None if coord is None else (int(coord[0]), int(coord[1]))


def _dim(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def _axes(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: DeviceMesh, axis) -> int:
    """The number of ranks along ``axis`` (a tuple of axes: their product)."""
    return int(np.prod([int(mesh.shape[_dim(mesh, a)]) for a in _axes(axis)]))


def axis_index(mesh: DeviceMesh, axis) -> int:
    """This rank's index along ``axis``; along a tuple of axes, row-major
    (JAX's order of ``P(('mr', 'mc'))``)."""
    coord = mesh.get_coordinate()
    i = 0
    for a in _axes(axis):
        i = i * int(mesh.shape[_dim(mesh, a)]) + int(coord[_dim(mesh, a)])
    return i


def factor_shapes(m: int, k: int, n: int, mesh: DeviceMesh) -> Tuple[Tuple[int, int], ...]:
    """Per-rank local shapes ((m_loc, n_loc), (m_loc, k), (k, n_loc))."""
    r, c = axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS)
    if m % r or n % c:
        raise ValueError(
            f"global dims (M={m}, N={n}) must divide the mesh {{{ROW_AXIS!r}: {r}, "
            f"{COL_AXIS!r}: {c}}}; pad the problem or choose a different mesh shape"
        )
    return ((m // r, n // c), (m // r, k), (k, n // c))


def quant_scale_spec(ndim: int) -> Spec:
    """The one definition of the quantized-X scales' layout: 1-D per-column
    scales split over 'mc' with their columns; a 2-D (row block, column)
    table keeps all its block rows on every 'mr' rank and splits its
    columns over 'mc' (``mesh.py:81-94`` of the JAX package)."""
    if ndim not in (1, 2):
        raise ValueError(f"quantized scales must be 1-D or 2-D, got {ndim}-D")
    return (COL_AXIS,) if ndim == 1 else (None, COL_AXIS)


def quant_scale_spec_for(precision) -> Spec:
    """:func:`quant_scale_spec` of the table a Precision implies (2-D iff
    ``x_quant_rows``)."""
    return quant_scale_spec(2 if precision.x_quant_rows else 1)


def nmf_shardings(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """(x, w, h, replicated) placements of the canonical layout."""
    return (
        Placement(mesh, BOTH),
        Placement(mesh, (ROW_AXIS, None)),
        Placement(mesh, (None, COL_AXIS)),
        Placement(mesh, ()),
    )


def _shape(a) -> Tuple[int, ...]:
    return tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))


def local_block(a, placement: Placement, device=None) -> torch.Tensor:
    """This rank's block of the global ``a`` (NumPy array or tensor) under
    ``placement``, a contiguous tensor on ``device`` (default: the mesh's
    device), dtype kept as :func:`~nmf_tpu_torch.utils.convert.to_tensor`
    keeps it.  A dimension that does not divide raises ``ValueError``."""
    mesh, spec = placement
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the mesh {tuple(mesh.shape)}")
    shape = _shape(a)
    idx = []
    for d, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
            continue
        size = axis_size(mesh, axis)
        if shape[d] % size:
            raise ValueError(
                f"dimension {d} of a {shape} array does not divide the {size} "
                f"ranks of mesh axis {axis!r}; pad the problem or choose a "
                f"different mesh shape"
            )
        step = shape[d] // size
        i = axis_index(mesh, axis)
        idx.append(slice(i * step, (i + 1) * step))
    dev = mesh_device(mesh) if device is None else device
    return to_tensor(a[tuple(idx)], dev).contiguous()


def shard_problem(x, w, h, mesh: DeviceMesh):
    """This rank's blocks of (X, W, H) in the canonical layout, on its
    device.  ``x`` may be a quantized ``(codes, scales)`` pair: the codes
    split like X, the scales by :func:`quant_scale_spec`."""
    xs, ws, hs, _ = nmf_shardings(mesh)
    if isinstance(x, tuple):
        x = (local_block(x[0], xs),
             local_block(x[1], Placement(mesh, quant_scale_spec(np.ndim(x[1])))))
    else:
        x = local_block(x, xs)
    return x, local_block(w, ws), local_block(h, hs)


def psum(t: torch.Tensor, mesh: DeviceMesh, axis) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``axis`` (ROW_AXIS, COL_AXIS,
    or both as a tuple) and return it: JAX's ``lax.psum``.  A sum over one
    rank is the identity and makes no call, as XLA drops a psum over an
    axis of size 1.  Both axes: the row sum, then the column sum."""
    axes = _axes(axis)
    if all(axis_size(mesh, a) == 1 for a in axes):
        return t
    buf = t.view(1) if t.dim() == 0 else t
    for a in axes:
        if axis_size(mesh, a) > 1:
            dist.all_reduce(buf, group=mesh.get_group(a))
    return t


def gather(t: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The global tensor whose blocks the ranks of the mesh hold under
    ``placement``, on every rank (on ``t``'s device, in its dtype).

    Each rank writes its block into zeros and the split axes are summed
    (:func:`psum`): adding zeros is exact, so the result is the blocks'
    bits, and the sum runs on every backend (gloo takes no CUDA
    ``all_gather``)."""
    mesh, spec = placement
    shape, idx, axes = list(t.shape), [], []
    for d, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
            continue
        size, i = axis_size(mesh, axis), axis_index(mesh, axis)
        idx.append(slice(i * t.shape[d], (i + 1) * t.shape[d]))
        shape[d] = t.shape[d] * size
        axes.extend(_axes(axis))
    if all(axis_size(mesh, a) == 1 for a in axes):
        return t
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out[tuple(idx)] = t
    return psum(out, mesh, tuple(axes))


# environment variables that mean "this process is one of a cluster's":
# torchrun's (RANK, WORLD_SIZE, MASTER_ADDR), its agent's run id, and the
# schedulers JAX's init_distributed knows
_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "TORCHELASTIC_RUN_ID",
                "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")
_REQUIRE_ENV = "NMF_TPU_REQUIRE_DISTRIBUTED"


def init_distributed(device="cuda", **kwargs) -> None:
    """Join the launcher's process group before :func:`make_mesh`
    (``mesh.py:148-203`` of the JAX package).

    ``torch.distributed.init_process_group`` from the environment a
    launcher sets (``python -m torch.distributed.run``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), or
    from ``kwargs`` (``init_method``, ``rank``, ``world_size``, ``store``).
    The backend is NCCL for ``device="cuda"``, with this process bound to
    ``cuda:LOCAL_RANK`` (one rank a card; NCCL refuses two ranks on one
    card), and gloo for ``"cpu"``.  Ranks that share a card join a gloo
    group themselves (``torch.distributed.init_process_group("gloo",
    ...)``), then call :func:`make_mesh` with ``device="cuda"``.

    A no-op when a group exists.  Outside any cluster (no launcher or
    scheduler variable, no ``kwargs``) a failed initialization warns
    (``RuntimeWarning``) and returns: the process runs alone.  Inside one
    it raises, and so it does whenever ``NMF_TPU_REQUIRE_DISTRIBUTED`` is
    set to anything but ``""``, ``0``, ``false`` or ``no``.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    try:
        dist.init_process_group(backend="nccl" if dev.type == "cuda" else "gloo", **kwargs)
    except (RuntimeError, ValueError) as e:
        cluster = any(os.environ.get(v) for v in _CLUSTER_ENV)
        if os.environ.get(_REQUIRE_ENV, "").strip().lower() not in ("", "0", "false", "no"):
            cluster = True
        if kwargs or cluster:
            raise
        warnings.warn(
            "torch.distributed.init_process_group failed and no cluster "
            "environment was detected; continuing as a single process.  If "
            f"this IS a distributed job, set {_REQUIRE_ENV}=1 to make this "
            f"fatal.  (initialize error: {e})",
            RuntimeWarning,
            stacklevel=2,
        )


def shutdown(barrier: bool = True) -> None:
    """Leave this process's process groups in order at the end of a run:
    a barrier (no rank tears down while another still sums; ``barrier=False``
    for a rank that failed, whose peers may be inside a collective), then
    every group destroyed and the port's solvers cached for a mesh dropped.
    A group lives on, with its gloo or NCCL threads, while any
    ``DeviceMesh`` over it does: the caller drops its meshes after this
    call, so that the threads end before the interpreter's teardown (a gloo
    group torn down there aborted a rank now and then: "terminate called
    without an active exception").  A no-op without a group."""
    if not dist.is_initialized():
        return
    if barrier:
        dist.barrier()
    dist.destroy_process_group()
    from .sharded import drop_cached_solvers

    drop_cached_solvers()
