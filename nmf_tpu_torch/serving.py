"""Serving artifacts: a learned dictionary W and its H-only solve, in one file.

Counterpart of ``nmf_tpu.serving``.  Production NMF serving scores a stream
of new data blocks against a FIXED dictionary W (the paper's application
refits H for new audio against a trained W).  :func:`save_transform`
packages that inference path; :func:`load_transform` gives a callable that
needs nothing but the artifact's path.

**What the artifact holds.**  The JAX package serializes a lowered program
(``jax.export``, StableHLO).  The port writes no lowered program, and uses
no ``torch.export`` or TorchScript graph either:

* the KL H-only solve runs the hand-written kernels K1 and K3, which are
  loaded through ``ctypes`` (``ops/kernels/_build.py``): no exported graph
  can call them;
* the checked loop's stop (``thresh > 0``) and the accelerated loop's
  accept or reject are host decisions on one read a check block
  (``models/solver.run_checked_loop``; the accelerated block computes the
  test, the momentum and the history on the device and the host reads the
  flag); an exported graph would need them as ``torch.cond``/
  ``while_loop``, or every iteration unrolled.  What the loop does capture
  is each full check block, accelerated or plain, as CUDA graphs made on the
  serving device at run time (not a file format): the program's step and
  cost come from the config alone, so the program keeps its graphs across
  calls in a cache of its own (``solver.GraphCache``, freed with the
  transform), each graph with its own copy of the prepped block: a stream
  runs its first block eagerly and replays from its second;
* a traced graph pins one device, and the artifact must serve on every
  platform it names.

So the program is the port's own H-only solve, rebuilt from the artifact's
config at load.  The zip holds ``meta.json`` and ``w.npy`` (the JAX
artifact's two) and ``program.json`` in place of ``program.bin``: the
program's entry (``h_only``, ``masked_h_only`` or their ``sharded_`` twins)
and its input signature, each input's name, shape and dtype, which
:func:`load_transform` checks against the meta as JAX checks the meta
against the deserialized program's inputs.  ``meta.json`` has JAX's fields,
with ``torch_version`` for ``jax_version`` and the magic
``"nmf_tpu_torch-serving"``: each package's loader refuses the other's
artifact, and :func:`nmf_tpu_torch.utils.convert.serving_from_jax` carries a
JAX artifact's W and config across.

**Backend.**  ``backend="auto"`` is kept in the meta (JAX writes ``'jnp'``
there, as one StableHLO program is lowered for every platform at once) and
resolved once at load on the serving device for the block width
(:func:`~nmf_tpu_torch.utils.autotune.resolve_config`, counted under the
entry ``"serve"``): on the CPU the kernels' plain versions, on the H100 K1
at each iteration and K3 at each check wherever the card's rule keeps the
kernels.  ``'jnp'`` is the plain path everywhere; ``'pallas'`` and
``'autotune'`` are refused at export (an artifact must serve on every
platform it names, a CPU host has no kernels, and autotune measures a live
card), and so is ``live_metrics``.  Masked, per-row-block int8 and mesh
artifacts and the non-KL families take plain ops, as in JAX.

Blocking model (``serving.py:26-39`` of the JAX package): the program
serves a fixed ``(m, n_block)`` X block; :class:`ServingTransform` cuts any
number of columns into ``n_block``-column blocks and pads the tail (X with
zeros, clamped to eps by the prep; H with eps; a mask with zeros).  The H
half-updates are column-separable, so the padding cannot change real
columns; ``thresh > 0`` and ``accelerate=True`` couple a block's columns
through its cost, so exact parity under them needs block-aligned input.
A padded block's cost counts its eps-clamped padding, as JAX's does.

``x_dtype`` int8 and bfloat16 work: the cast or quantization runs in the
program, so the serving input is plain float32.  For int8 configs
``quantized_input=True`` quantizes on the HOST instead
(:func:`~nmf_tpu_torch.ops.quant.quantize_policy_np`, the device
quantizer's bits): the program takes the ``(codes, scales)`` pair, so the
wire carries a quarter of the bytes, with the same results.  It composes
with ``masked`` (the host applies the masked prep's order: clamp, zero the
unobserved entries, quantize; the mask rides as uint8) and with
``mesh_shape``.

Distributed serving: ``mesh_shape=(rows, cols)`` bakes the sharded H-only
solve in (``parallel/sharded.build_sharded_h_solver``); exporting needs no
process group.  Loading takes a port ``DeviceMesh`` of that shape (or makes
one over the world): each rank places only its pieces of a block (X, codes
and mask as (M/r, n_block/c), the scales by ``quant_scale_spec``, W's rows
over 'mr', H's columns over 'mc'), runs the sharded solve, and gathers H
over 'mc', so every rank returns the whole result, as JAX returns global
arrays.  The sharded H step and cost are plain ops on every device, as in
JAX.  In-program int8 X is refused on a mesh; ``quantized_input=True`` is
the int8 path there.

The blocks are pipelined as JAX pipelines them: block j+1 is copied in
while block j solves and block j-1's H is copied out.  On the card the
copies go from two pinned staging sets on a copy stream, ordered by events
(``models/streaming._BlockStream``'s pattern), and H comes back into
pinned memory (``streaming._Fetch``).  ``prefetch=False`` serves strictly
one block at a time, with the same bits.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import warnings
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .models.masked import _masked_prep, masked_h_step_cost
from .models.nmf import _h_only_step_cost
from .models.solver import GraphCache, SolveResult, _prep, run_checked_loop
from .models.streaming import BinColumnSource, _Fetch
from .utils.autotune import resolve_config
from .utils.config import Precision, SolveConfig
from .utils.convert import config_from_dict, to_tensor
from .utils.device import resolve_device

__all__ = [
    "export_transform",
    "save_transform",
    "load_transform",
    "ServingTransform",
    "ServingResult",
    "FORMAT_VERSION",
]

# v1: plain and mesh artifacts.  v2 adds masked artifacts (a 4th program
# input).  v3 adds quantized-input artifacts (codes and scales for f32 X).
# v4 adds masked x quantized-input (5 inputs) and mesh x quantized-input
# with a 2-D row-block scale table.  Each artifact writes the LOWEST version
# that describes it (``serving.py:91-98`` of the JAX package).
FORMAT_VERSION = 4
_MAGIC = "nmf_tpu_torch-serving"
_JAX_MAGIC = "nmf_tpu-serving"
PLATFORMS = ("cuda", "cpu")
_ENTRIES = {(False, False): "h_only", (True, False): "masked_h_only",
            (False, True): "sharded_h_only", (True, True): "sharded_masked_h_only"}


def _config_to_dict(config: SolveConfig) -> dict:
    return dataclasses.asdict(config)


def _known_fields(cls, d: dict, what: str) -> dict:
    """Keep only the fields this version knows, warning about the rest: a
    newer writer may add SolveConfig knobs without changing the format, and
    a deployed reader keeps serving (the dropped knob's default semantics)."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        warnings.warn(
            f"artifact {what} carries fields this nmf_tpu_torch version does "
            f"not know and will ignore: {unknown} (written by a newer library?)",
            stacklevel=3,
        )
    return {k: v for k, v in d.items() if k in names}


def _config_from_dict(d: dict) -> SolveConfig:
    d = dict(d)
    prec = _known_fields(Precision, d.pop("precision"), "Precision")
    return config_from_dict(dict(_known_fields(SolveConfig, d, "SolveConfig"), precision=prec))


def _validate_exportable(config: SolveConfig) -> SolveConfig:
    """Refuse the knobs an artifact cannot carry; ``'auto'`` stays
    ``'auto'`` (resolved at load on the serving device)."""
    config.validate()
    if config.backend in ("pallas", "autotune"):
        raise ValueError(
            "an artifact must serve on every platform it names: backend='pallas' "
            "needs the CUDA kernels, which a CPU host lacks, and autotune measures "
            "a live card — use backend='auto' (resolved on the serving device at "
            "load) or 'jnp'"
        )
    if config.live_metrics:
        raise ValueError(
            "live_metrics streams through a host callback, which cannot be "
            "serialized into an exported program"
        )
    return config


def _validate_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    platforms = tuple(str(p).lower() for p in platforms)
    if not platforms:
        raise ValueError(
            "platforms must name at least one serving target ('cuda', 'cpu'): an "
            "artifact that names none could serve nowhere"
        )
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown serving platform {p!r}: the port serves on "
                             f"{', '.join(repr(q) for q in PLATFORMS)}")
    return platforms


def _validate_w_shape(w, n_block: int, mesh_shape=None) -> np.ndarray:
    w = np.asarray(w, np.float32)
    if w.ndim != 2:
        raise ValueError(f"W must be 2-D, got shape {w.shape}")
    if n_block <= 0:
        raise ValueError("n_block must be >= 1")
    if mesh_shape is not None:
        r, c = (int(v) for v in mesh_shape)
        if r <= 0 or c <= 0:
            raise ValueError(f"mesh_shape must be positive, got {mesh_shape}")
        if w.shape[0] % r or n_block % c:
            raise ValueError(
                f"sharded export needs M divisible by mesh rows and n_block "
                f"by mesh cols: M={w.shape[0]} n_block={n_block} vs "
                f"mesh {r}x{c}"
            )
    return w


def _signature(m: int, k: int, n_block: int, config: SolveConfig, masked: bool,
               quantized: bool) -> Tuple[Tuple[str, Tuple[int, ...], str], ...]:
    """The program's inputs, (name, shape, dtype) each: ``(x, w, h0[,
    mask])`` or ``(codes, scales, w, h0[, mask])`` (``serving.py:346-367``
    of the JAX package); a quantized masked program takes a uint8 mask."""
    if quantized:
        qrows = int(config.precision.x_quant_rows or 0)
        scales = (-(-m // qrows), n_block) if qrows else (n_block,)
        sig = [("codes", (m, n_block), "uint8"), ("scales", scales, "float32")]
    else:
        sig = [("x", (m, n_block), "float32")]
    sig += [("w", (m, k), "float32"), ("h0", (k, n_block), "float32")]
    if masked:
        sig.append(("mask", (m, n_block), "uint8" if quantized else "float32"))
    return tuple((n, tuple(int(d) for d in s), t) for n, s, t in sig)


@dataclasses.dataclass(frozen=True, eq=False)
class ExportedTransform:
    """What :func:`export_transform` returns, the port's ``jax.export.
    Exported``: W, the block width, the validated config, the mesh shape,
    the flags, the platforms, the program's entry and its input signature
    (``(name, shape, dtype)`` each, ``in_avals``' counterpart).
    :func:`save_transform` writes it."""

    w: np.ndarray
    n_block: int
    config: SolveConfig
    mesh_shape: Optional[Tuple[int, int]]
    masked: bool
    quantized_input: bool
    platforms: Tuple[str, ...]
    entry: str
    in_signature: Tuple[Tuple[str, Tuple[int, ...], str], ...]


def _export_validated(w, n_block, config, platforms, mesh_shape=None, masked=False,
                      quantized_input=False) -> ExportedTransform:
    platforms = _validate_platforms(platforms)
    if masked and (config.beta != 1.0 or config.algorithm != "mu"):
        raise ValueError(
            "masked serving implements the KL (beta=1) MU family "
            "(models/masked.py)"
        )
    if quantized_input and config.precision.x_dtype != "int8":
        raise ValueError(
            "quantized_input exports the (codes, scales) calling "
            "convention, which only exists for int8 X storage — set "
            "Precision(x_dtype='int8') (optionally x_quant_rows)"
        )
    if mesh_shape is not None and not quantized_input and config.precision.x_dtype == "int8":
        raise ValueError(
            "sharded export does not take x_dtype='int8': each rank would "
            "have to quantize its own piece of a block, which cannot "
            "reproduce the solver's whole-column scale layout — export "
            "with quantized_input=True instead (the HOST quantizes whole "
            "columns, which shards cleanly), or feed f32/bf16"
        )
    m, k = w.shape
    mesh_shape = None if mesh_shape is None else (int(mesh_shape[0]), int(mesh_shape[1]))
    return ExportedTransform(
        w=w, n_block=int(n_block), config=config, mesh_shape=mesh_shape, masked=bool(masked),
        quantized_input=bool(quantized_input), platforms=platforms,
        entry=_ENTRIES[(bool(masked), mesh_shape is not None)],
        in_signature=_signature(m, k, int(n_block), config, bool(masked),
                                bool(quantized_input)),
    )


def export_transform(
    w,
    n_block: int,
    config: SolveConfig = SolveConfig(),
    platforms: Sequence[str] = PLATFORMS,
    mesh_shape: Optional[Tuple[int, int]] = None,
    masked: bool = False,
    quantized_input: bool = False,
) -> ExportedTransform:
    """The validated H-only transform at fixed shapes: ``(m, n_block)`` X
    blocks against the (m, k) ``w``.

    ``mesh_shape=(rows, cols)``: the sharded solve for an ('mr', 'mc')
    mesh of that shape (exporting needs no process group).  ``masked``: the
    program takes a ``mask`` input and fits the observed entries only.
    ``quantized_input`` (int8 configs): the program takes host-quantized
    ``(codes, scales)`` instead of f32 X.  ``platforms``: the device types
    the artifact may serve on, ``"cuda"`` and ``"cpu"``.  Most callers want
    :func:`save_transform`, which writes the artifact.
    """
    config = _validate_exportable(config)
    w = _validate_w_shape(w, n_block, mesh_shape)
    return _export_validated(w, n_block, config, platforms, mesh_shape, masked,
                             quantized_input)


def _format_version(exported: ExportedTransform) -> int:
    """The lowest version whose loaders serve this artifact correctly
    (``serving.py:422-437`` of the JAX package)."""
    qrows = int(exported.config.precision.x_quant_rows or 0)
    if exported.quantized_input and (exported.masked or (exported.mesh_shape is not None
                                                         and qrows > 0)):
        return 4
    if exported.quantized_input:
        return 3
    return 2 if exported.masked else 1


def save_transform(
    path: str,
    w,
    n_block: int,
    config: SolveConfig = SolveConfig(),
    platforms: Sequence[str] = PLATFORMS,
    mesh_shape: Optional[Tuple[int, int]] = None,
    masked: bool = False,
    quantized_input: bool = False,
) -> None:
    """Write a self-contained serving artifact (zip: ``meta.json``,
    ``program.json``, ``w.npy``); the arguments as :func:`export_transform`'s."""
    _write(path, export_transform(w, n_block, config, platforms, mesh_shape, masked,
                                  quantized_input))


def _write(path: str, exported: ExportedTransform) -> None:
    w = exported.w
    meta = {
        "magic": _MAGIC,
        "format_version": _format_version(exported),
        "m": int(w.shape[0]),
        "k": int(w.shape[1]),
        "n_block": exported.n_block,
        "masked": exported.masked,
        "quantized_input": exported.quantized_input,
        "mesh_shape": list(exported.mesh_shape) if exported.mesh_shape is not None else None,
        "platforms": list(exported.platforms),
        "config": _config_to_dict(exported.config),
        "torch_version": torch.__version__,
    }
    program = {
        "entry": exported.entry,
        "inputs": [{"name": n, "shape": list(s), "dtype": t} for n, s, t in exported.in_signature],
    }
    wbuf = io.BytesIO()
    np.save(wbuf, w)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=1))
        zf.writestr("program.json", json.dumps(program, indent=1))
        zf.writestr("w.npy", wbuf.getvalue())


@dataclasses.dataclass
class ServingResult:
    """Per-block transform results assembled back to the full H.

    Blocks are independent solves (column-separable updates), so iteration
    counts, costs and convergence are reported per block; ``cost`` is the
    sum of the final block costs and ``converged`` their conjunction.
    """

    # (k, n), padding sliced off; None when stream_bin wrote H to disk
    h: Optional[np.ndarray]
    block_iterations: np.ndarray     # (n_blocks,) i32
    block_costs: np.ndarray          # (n_blocks,) f32 final divergence
    block_converged: np.ndarray      # (n_blocks,) bool
    n_block: int

    @property
    def cost(self) -> float:
        return float(np.sum(self.block_costs))

    @property
    def converged(self) -> bool:
        return bool(np.all(self.block_converged))

    @property
    def iterations(self) -> int:
        return int(np.max(self.block_iterations))


def _build_transform_program(config: SolveConfig, masked: bool = False,
                             quantized: bool = False, mesh=None, device=None):
    """Every serving program, built in one place: the 2x2 family (masked?
    x quantized-input?), on one device or on a mesh.

    Signatures, the inputs on the program's device (on a mesh: this rank's
    pieces)::

        plain               program(x, w, h0)
        masked              program(x, w, h0, mask)            (mask f32)
        quantized           program(codes, scales, w, h0)
        masked x quantized  program(codes, scales, w, h0, mask) (mask u8)

    The prep runs in the program (clamp, cast or quantize f32 X; W and H
    cast to the state dtype and clamped; a ``(codes, scales)`` pair passes
    through, and K1/K3 take it themselves), then the H-only loop: the step
    and cost of :func:`~nmf_tpu_torch.solve_h_only` (of
    :func:`~nmf_tpu_torch.solve_masked_h_only` when masked) under
    ``config`` as given (the caller resolves ``auto``), or the sharded
    H-only solve with H gathered over 'mc'.  Returns ``(h, iterations,
    cost, cost_history, num_checks, converged)``.
    """
    if mesh is None:
        dev = device
        step, cost = (masked_h_step_cost if masked else _h_only_step_cost)(config)
        graphs = GraphCache()       # the program's check-block graphs, freed with it

        def solve(data, w, h0):
            return run_checked_loop(data, w, h0, config, step, cost, graphs=graphs)
    else:
        from .parallel.mesh import COL_AXIS, Placement, gather, mesh_device
        from .parallel.sharded import build_sharded_h_solver, build_sharded_masked_h_solver

        dev = mesh_device(mesh)
        fn = (build_sharded_masked_h_solver if masked else build_sharded_h_solver)(config, mesh)

        def solve(data, w, h0):
            res = fn(data, w, h0)
            return dataclasses.replace(res, h=gather(res.h, Placement(mesh, (None, COL_AXIS))))

    def program(*args):
        x, rest = ((args[0], args[1]), args[2:]) if quantized else (args[0], args[1:])
        if masked:
            x, w, h0, mask = _masked_prep(x, rest[0], rest[1], rest[2], config, dev)
            res = solve((x, mask), w, h0)
        else:
            res = solve(*_prep(x, rest[0], rest[1], config, True, dev))
        return res.h, res.iterations, res.cost, res.cost_history, res.num_checks, res.converged

    return program


class _Uploads:
    """A block's wire inputs on their way to the device, double-buffered
    (``models/streaming._BlockStream``'s pattern): two pinned staging sets
    and two device sets (every block has the same shapes), one copy
    stream, and events: a copy into a device set waits for the compute
    that last read it; the host refills a pinned set once its last copy has
    finished.  On the CPU the host arrays are the inputs."""

    def __init__(self, dev: torch.device):
        self.dev, self.cuda = dev, dev.type == "cuda"
        self._next = 0
        self._host = self._dev = None
        self._cpu = [None, None]
        if self.cuda:
            self._stream = torch.cuda.Stream(dev)
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._read = [torch.cuda.Event() for _ in range(2)]

    def put(self, arrays) -> int:
        """Stage the host arrays and start their copies; returns the slot."""
        slot, self._next = self._next, self._next ^ 1
        if not self.cuda:
            self._cpu[slot] = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
            return slot
        if self._host is None:
            self._host = [[torch.from_numpy(np.empty(a.shape, a.dtype)).pin_memory()
                           for a in arrays] for _ in range(2)]
            self._dev = [[torch.empty(t.shape, dtype=t.dtype, device=self.dev)
                          for t in self._host[0]] for _ in range(2)]
        self._copied[slot].synchronize()     # the pinned set's last copies are done
        for buf, a in zip(self._host[slot], arrays):
            np.copyto(buf.numpy(), a)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(self._read[slot])
            for d, h in zip(self._dev[slot], self._host[slot]):
                d.copy_(h, non_blocking=True)
            self._copied[slot].record(self._stream)
        return slot

    def ready(self, slot: int):
        """Compute side: the slot's device inputs once their copies landed."""
        if not self.cuda:
            return self._cpu[slot]
        torch.cuda.current_stream(self.dev).wait_event(self._copied[slot])
        return self._dev[slot]

    def release(self, slot: int) -> None:
        """The work enqueued on the slot's inputs so far is all that reads them."""
        if self.cuda:
            self._read[slot].record(torch.cuda.current_stream(self.dev))


class ServingTransform:
    """A loaded serving artifact: ``t = load_transform(p); h = t(x).h``.

    A call pads X to whole ``n_block``-column blocks (module docstring) and
    runs the program once a block.  Attributes as JAX's: ``w``, ``config``
    (the artifact's, ``backend`` as stored), ``meta``, ``m``, ``k``,
    ``n_block``, ``masked``, ``quantized``, ``platforms``, ``mesh_shape``,
    ``mesh``; and ``device`` (the serving device) and ``backend`` (what
    ``config.backend`` resolved to there, once, at the block width).
    """

    def __init__(self, exported: ExportedTransform, w, config: SolveConfig, meta: dict,
                 mesh=None, device="cuda"):
        self._exported = exported
        self.w = np.asarray(w, np.float32)
        self.config = config
        self.meta = dict(meta)
        self.m = int(meta["m"])
        self.k = int(meta["k"])
        self.n_block = int(meta["n_block"])
        self.masked = bool(meta.get("masked", False))
        self.quantized = bool(meta.get("quantized_input", False))
        self.platforms = tuple(meta["platforms"])
        ms = meta.get("mesh_shape")
        self.mesh_shape = tuple(int(v) for v in ms) if ms else None
        if self.mesh_shape is None:
            self.mesh = None
            self.device = resolve_device(device)
        else:
            from .parallel.mesh import (
                COL_AXIS, ROW_AXIS, axis_size, check_mesh, make_mesh, mesh_coordinate,
                mesh_device,
            )

            if mesh is None:
                mesh = make_mesh(shape=self.mesh_shape, device=device)
            mesh = check_mesh(mesh)
            got = (axis_size(mesh, ROW_AXIS), axis_size(mesh, COL_AXIS))
            if got != self.mesh_shape:
                raise ValueError(
                    f"artifact was exported for a "
                    f"{self.mesh_shape[0]}x{self.mesh_shape[1]} mesh, got "
                    f"{'x'.join(str(s) for s in got)}"
                )
            coord = mesh_coordinate(mesh)
            if coord is None:
                raise ValueError(f"this rank is outside the {got[0]}x{got[1]} mesh")
            self.mesh = mesh
            self.device = mesh_device(mesh)
            ml, cl = self.m // got[0], self.n_block // got[1]
            self._rows = (coord[0] * ml, (coord[0] + 1) * ml)
            self._cols = (coord[1] * cl, (coord[1] + 1) * cl)
        if self.device.type not in self.platforms:
            raise ValueError(
                f"the artifact serves on {', '.join(self.platforms)}, not on "
                f"{self.device.type} (export it with that platform)"
            )
        if self.mesh is None and not self.masked:
            # one width, one choice: every block is n_block columns wide
            run_config = resolve_config(config, self.m, self.k, self.n_block, self.device,
                                        "serve")
        else:   # the masked and sharded H-only programs run plain ops
            run_config = dataclasses.replace(config, backend="jnp")
        self.backend = run_config.backend
        self._program = _build_transform_program(run_config, self.masked, self.quantized,
                                                 self.mesh, self.device)
        self._w_dev = None

    def _pieces(self, names, arrays):
        """This rank's pieces of a block's wire arrays (all of them off a
        mesh): X, codes and mask (M/r, n_block/c); 1-D scales their
        columns, a 2-D table every block row (``quant_scale_spec``); H its
        columns."""
        if self.mesh is None:
            return arrays
        (r0, r1), (c0, c1) = self._rows, self._cols
        out = []
        for name, a in zip(names, arrays):
            if name in ("x", "codes", "mask"):
                a = a[r0:r1, c0:c1]
            elif a.ndim == 2:        # h0, or a 2-D scale table
                a = a[:, c0:c1]
            else:                    # 1-D scales
                a = a[c0:c1]
            out.append(np.ascontiguousarray(a))
        return out

    def __call__(self, x, h0=None, seed: int = 0, prefetch: bool = True,
                 mask=None) -> ServingResult:
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[0] != self.m:
            raise ValueError(
                f"X must be ({self.m}, n), got {x.shape} (artifact W is "
                f"{self.m}x{self.k})"
            )
        n = x.shape[1]
        if n == 0:
            raise ValueError("X has no columns")
        self._check_mask_given(mask is not None, "requires a mask (exported with masked=True)")
        if mask is not None:
            mask = np.asarray(mask, np.float32)
            if mask.shape != x.shape:
                raise ValueError(
                    f"mask shape {mask.shape} != X shape {x.shape}"
                )
        h0 = self._check_h0(h0, n)
        eps = np.float32(self.config.eps)
        bounds = self._bounds(n)
        hs, iters, costs, convs = [], [], [], []

        def _place(idx):
            j0, j1 = bounds[idx]
            return self._place_block(*self._pad_block(
                x[:, j0:j1], self._h0_block(h0, seed, idx, j0, j1, eps), eps,
                mask_blk=None if mask is None else mask[:, j0:j1]))

        def _drain(idx, out):
            h, it, cost, conv = out
            hs.append(h[:, : bounds[idx][1] - bounds[idx][0]])
            iters.append(it)
            costs.append(cost)
            convs.append(conv)

        self._run_pipeline(len(bounds), _place, _drain, prefetch)
        return ServingResult(
            h=np.concatenate(hs, axis=1),
            block_iterations=np.asarray(iters, np.int32),
            block_costs=np.asarray(costs, np.float32),
            block_converged=np.asarray(convs, bool),
            n_block=self.n_block,
        )

    def _check_mask_given(self, given: bool, needs: str) -> None:
        if self.masked != given:
            raise ValueError(
                "this artifact's program "
                + (needs if self.masked else "takes no mask (export with "
                   "masked=True for missing-data scoring)")
            )

    def _check_h0(self, h0, n: int):
        if h0 is None:
            return None
        h0 = np.asarray(h0, np.float32)
        if h0.shape != (self.k, n):
            raise ValueError(f"h0 must be ({self.k}, {n}), got {h0.shape}")
        return h0

    def _bounds(self, n: int):
        nb = self.n_block
        return [(j0, min(j0 + nb, n)) for j0 in range(0, n, nb)]

    def _h0_block(self, h0, seed, idx, j0, j1, eps):
        """Block ``idx``'s initial H at its REAL width (before padding):
        ``h0``'s columns, or ``RandomState((seed + idx) % 2**32)``, clamped
        to eps, so block 0 of a block-aligned call is the CLI transform's
        ``RandomState(seed).rand(k, n)`` (``serving.py:617-628`` of JAX)."""
        if h0 is not None:
            return np.asarray(h0[:, j0:j1], np.float32)
        rng = np.random.RandomState((int(seed) + idx) % (2 ** 32))
        return np.maximum(rng.rand(self.k, j1 - j0).astype(np.float32), eps)

    def _pad_block(self, x_blk, h0_blk, eps, mask_blk=None):
        """X zero-padded (clamped to eps by the prep), H eps-padded to the
        block width; a mask's padding is zero (fully unobserved)."""
        pad = self.n_block - x_blk.shape[1]
        if pad:
            x_blk = np.concatenate([x_blk, np.zeros((self.m, pad), np.float32)], axis=1)
            h0_blk = np.concatenate([h0_blk, np.full((self.k, pad), eps, np.float32)], axis=1)
            if mask_blk is not None:
                mask_blk = np.concatenate(
                    [mask_blk, np.zeros((self.m, pad), np.float32)], axis=1)
        return x_blk, h0_blk, mask_blk

    def _place_block(self, x_blk, h0_blk, mask_blk=None):
        """One block's wire arrays (this rank's pieces on a mesh), in the
        signature's order without W.  Quantized-input artifacts quantize
        here, on the host (``quantize_policy_np``, the in-program
        quantizer's bits), after the masked prep's clamp and zeroing."""
        if self.quantized:
            from .ops.quant import quantize_policy_np

            eps = self.config.eps
            xq = np.maximum(np.asarray(x_blk, np.float32), np.float32(eps))
            if mask_blk is not None:
                mask_blk = np.asarray(mask_blk, np.float32)
                if ((mask_blk != 0) & (mask_blk != 1)).any():
                    raise ValueError(
                        "quantized-input masked artifacts take a BINARY "
                        "observed-entry mask (the uint8 wire form cannot "
                        "carry weights) — serve weighted masks with the "
                        "in-program-quantization masked artifact"
                    )
                # clamp, THEN zero the unobserved entries (NaN must not reach
                # the scales), THEN quantize: the masked prep's order
                xq = np.where(mask_blk > 0, xq, np.float32(0.0))
            codes, scales = quantize_policy_np(xq, eps, self.config.precision.x_quant_rows)
            names = ["codes", "scales", "h0"]
            arrays = [codes, np.asarray(scales, np.float32), h0_blk]
            if mask_blk is not None:
                names.append("mask")
                arrays.append((mask_blk > 0).astype(np.uint8))
        else:
            names, arrays = ["x", "h0"], [x_blk, h0_blk]
            if mask_blk is not None:
                names.append("mask")
                arrays.append(mask_blk)
        return self._pieces(names, arrays)

    def _run_pipeline(self, n_blocks, place, drain, prefetch=True):
        """put -> dispatch -> drain over the blocks (``serving.py:651-673``
        of the JAX package): block j+1's copy rides the link while block j
        solves, and block j-1's H comes back meanwhile.  The same inputs and
        program a block as the serial schedule, so the same bits;
        ``prefetch=False`` serves strictly one block at a time."""
        up = _Uploads(self.device)
        if self._w_dev is None:
            w = self.w if self.mesh is None else self.w[self._rows[0]:self._rows[1]]
            self._w_dev = to_tensor(w, self.device)

        def dispatch(slot):
            out = self._dispatch(up.ready(slot))
            up.release(slot)
            return out

        if not prefetch:
            for idx in range(n_blocks):
                drain(idx, self._fetched(dispatch(up.put(place(idx)))))
            return
        slot = up.put(place(0))
        prev = None
        for idx in range(n_blocks):
            out = dispatch(slot)
            if idx + 1 < n_blocks:
                slot = up.put(place(idx + 1))
            if prev is not None:
                drain(idx - 1, self._fetched(prev))
            prev = out
        drain(n_blocks - 1, self._fetched(prev))

    def _dispatch(self, placed):
        """One program call on a placed block: H and the cost start on their
        way to the host (into pinned memory on the card) without a wait."""
        nx = 2 if self.quantized else 1
        h, it, cost, hist, nchk, conv = self._program(*placed[:nx], self._w_dev, *placed[nx:])
        return _Fetch(SolveResult(w=None, h=h, iterations=it, cost=cost, cost_history=hist,
                                  num_checks=nchk, converged=conv))

    @staticmethod
    def _fetched(fetch):
        """(H as f32 NumPy, iterations, cost, converged) once the copy landed."""
        h, cost, it, conv = fetch.result()
        return np.array(h, np.float32), it, cost, conv

    def stream_bin(
        self,
        x_path: str,
        out_path: Optional[str] = None,
        h0=None,
        seed: int = 0,
        prefetch: bool = True,
        mask_path: Optional[str] = None,
    ) -> ServingResult:
        """Serve a ``.bin`` file in column blocks: neither X nor the default
        init loads whole into host memory (a column block of the
        column-major payload is one contiguous read,
        :class:`~nmf_tpu_torch.models.streaming.BinColumnSource`).

        ``mask_path`` (masked artifacts) names a ``.bin`` of X's shape whose
        column blocks ride with X's.  With ``out_path`` the H columns are
        appended block by block to ``out_path + ".part"``, which replaces
        ``out_path`` on success (a failed stream leaves no file behind);
        the result then has ``h=None``.  On a mesh every rank serves and
        the rank of global rank 0 alone writes ``out_path``.  Block-aligned
        results are bit-equal to :meth:`__call__` on the loaded matrix."""
        from .io.binio import pack_header

        self._check_mask_given(
            mask_path is not None,
            "requires a mask: pass mask_path= (a .bin of X's shape whose column blocks "
            "stream alongside X's)")
        src = BinColumnSource(x_path)
        m, n = src.shape
        if m != self.m:
            raise ValueError(f"{x_path} has {m} rows; artifact W is {self.m}x{self.k}")
        if n == 0:
            raise ValueError(f"{x_path} has no columns")
        msrc = None
        if mask_path is not None:
            msrc = BinColumnSource(mask_path)
            if msrc.shape != (m, n):
                raise ValueError(
                    f"{mask_path} is {msrc.shape[0]}x{msrc.shape[1]}; the "
                    f"mask must match X ({m}x{n})"
                )
        h0 = self._check_h0(h0, n)
        eps = np.float32(self.config.eps)
        bounds = self._bounds(n)
        hs, iters, costs, convs = [], [], [], []
        if out_path is not None and self.mesh is not None:
            import torch.distributed as dist

            if dist.get_rank() != 0:
                out_path = None
        tmp_path = (out_path + ".part") if out_path else None
        fout = open(tmp_path, "wb") if out_path else None

        def _place(idx):
            j0, j1 = bounds[idx]
            return self._place_block(*self._pad_block(
                src.columns(j0, j1), self._h0_block(h0, seed, idx, j0, j1, eps), eps,
                mask_blk=None if msrc is None else msrc.columns(j0, j1)))

        def _drain(idx, out):
            h, it, cost, conv = out
            h = h[:, : bounds[idx][1] - bounds[idx][0]]
            if fout is not None:
                fout.write(h.tobytes(order="F"))   # write_matrix's column-major payload
            else:
                hs.append(h)
            iters.append(it)
            costs.append(cost)
            convs.append(conv)

        try:
            if fout is not None:
                fout.write(pack_header(self.k, n))
            self._run_pipeline(len(bounds), _place, _drain, prefetch)
            if fout is not None:
                fout.close()
                fout = None
                os.replace(tmp_path, out_path)
        except BaseException:
            if fout is not None:
                fout.close()
            if tmp_path is not None and os.path.exists(tmp_path):
                os.unlink(tmp_path)
            raise
        return ServingResult(
            h=np.concatenate(hs, axis=1) if hs else None,
            block_iterations=np.asarray(iters, np.int32),
            block_costs=np.asarray(costs, np.float32),
            block_converged=np.asarray(convs, bool),
            n_block=self.n_block,
        )


def _read_zip(path: str):
    """(meta, program, w) of an artifact, with the checks that need no
    device: the magic (a JAX artifact is named as such), the version, a
    truncated zip, a corrupt ``w.npy``."""
    with zipfile.ZipFile(path, "r") as zf:
        members = set(zf.namelist())
        if "meta.json" not in members:
            raise ValueError(f"{path}: not an nmf_tpu_torch serving artifact")
        meta = json.loads(zf.read("meta.json"))
        if meta.get("magic") == _JAX_MAGIC:
            raise ValueError(
                f"{path}: this is the JAX package's serving artifact (a jax.export "
                f"program, magic {_JAX_MAGIC!r}), which nmf_tpu_torch cannot run — "
                "carry its W and config across with "
                "nmf_tpu_torch.utils.convert.serving_from_jax"
            )
        if meta.get("magic") != _MAGIC:
            raise ValueError(f"{path}: not an nmf_tpu_torch serving artifact")
        _check_version(path, meta)
        missing = {"program.json", "w.npy"} - members
        if missing:
            raise ValueError(f"{path}: truncated artifact (missing {sorted(missing)})")
        program = json.loads(zf.read("program.json"))
        w = _checked_w(path, meta, zf.read("w.npy"))
    return meta, program, w


def _check_version(path: str, meta: dict) -> None:
    """JAX's version gate: a format newer than this library's is refused."""
    if int(meta.get("format_version", -1)) > FORMAT_VERSION:
        raise ValueError(
            f"{path}: format v{meta['format_version']} is newer than "
            f"this library (v{FORMAT_VERSION})"
        )


def _checked_w(path: str, meta: dict, raw: bytes) -> np.ndarray:
    """``w.npy``'s bytes as W, refused unless 2-D of the meta's (m, k): a
    tampered W would otherwise fail deep in the first call."""
    w = np.load(io.BytesIO(raw))
    expect = (int(meta.get("m", -1)), int(meta.get("k", -1)))
    if w.ndim != 2 or w.shape != expect:
        raise ValueError(
            f"{path}: corrupt artifact — w.npy is "
            f"{getattr(w, 'shape', None)}, meta says {expect}"
        )
    return w


def _check_program(path: str, meta: dict, program: dict) -> None:
    """The meta against the program's own signature and entry: a meta
    whose ``n_block``, ``masked``, ``quantized_input`` or ``mesh_shape``
    drifted from ``program.json`` would pad blocks to the wrong width or
    pass the wrong inputs (``serving.py:908-934`` of the JAX package)."""
    inputs = list(program.get("inputs", []))
    quantized = bool(meta.get("quantized_input", False))
    masked = bool(meta.get("masked"))
    want_args = 3 + masked + quantized
    if len(inputs) != want_args:
        raise ValueError(
            f"{path}: corrupt artifact — meta says masked={masked} "
            f"quantized_input={quantized} ({want_args} program inputs) but "
            f"program.json takes {len(inputs)}"
        )
    m, n_block = int(meta.get("m", -1)), int(meta.get("n_block", -1))
    x_shape = tuple(inputs[0].get("shape", ()))
    if len(x_shape) != 2 or x_shape[1] != n_block or x_shape[0] != m:
        raise ValueError(
            f"{path}: corrupt artifact — meta says X blocks are "
            f"{(m, n_block)} but program.json takes {x_shape}"
        )
    if quantized and str(inputs[0].get("dtype")) != "uint8":
        raise ValueError(
            f"{path}: corrupt artifact — meta says quantized_input but "
            f"program.json's first input is {inputs[0].get('dtype')}, not uint8"
        )
    entry = _ENTRIES[(masked, bool(meta.get("mesh_shape")))]
    if program.get("entry") != entry:
        raise ValueError(
            f"{path}: corrupt artifact — meta says masked={masked} "
            f"mesh_shape={meta.get('mesh_shape')} (entry {entry!r}) but "
            f"program.json's entry is {program.get('entry')!r}"
        )


def load_transform(path: str, mesh=None, device="cuda") -> ServingTransform:
    """Load a :func:`save_transform` artifact into a callable on ``device``
    (``"cuda"`` by default; a CUDA request without a card raises), which
    must be one of the artifact's platforms.

    For an artifact exported with ``mesh_shape``, ``mesh`` is the port's
    ``DeviceMesh`` to serve on (its shape must match; its device is used);
    without it :func:`~nmf_tpu_torch.make_mesh` builds one of that shape
    over the world on ``device``.  Every rank of the mesh loads and calls."""
    meta, program, w = _read_zip(path)
    _check_program(path, meta, program)
    config = _config_from_dict(meta["config"])
    ms = meta.get("mesh_shape")
    exported = ExportedTransform(
        w=w, n_block=int(meta["n_block"]), config=config,
        mesh_shape=tuple(int(v) for v in ms) if ms else None,
        masked=bool(meta.get("masked")), quantized_input=bool(meta.get("quantized_input")),
        platforms=tuple(meta["platforms"]), entry=program["entry"],
        in_signature=tuple((i["name"], tuple(i["shape"]), i["dtype"])
                           for i in program["inputs"]),
    )
    return ServingTransform(exported, w, config, meta, mesh=mesh, device=device)
