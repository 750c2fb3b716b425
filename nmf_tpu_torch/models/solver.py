"""The NMF solve loop: check-blocked, the graphed route reading the card only at its end.

Counterpart of ``nmf_tpu.models.solver``.  The JAX package builds one
``jit(lax.while_loop)`` over check blocks, each an inner ``fori_loop`` of
``check_every`` steps.  Here a host loop walks the check blocks and keeps
every device value on the device:

* ``chunk = min(check_every, max_iter - it)`` steps per check block;
* each block is :func:`check_block`: the steps, then the cost into a
  device-side history of ``ceil(max_iter / check_every)`` f32 slots
  (unused ones NaN) at a device index, and the relative change, with no
  read by the host;
* on a CUDA device (and the identity ``all_reduce``: one device) the
  full-length blocks run as CUDA graphs, PyTorch's counterpart of the
  inner ``fori_loop`` under ``jit`` (:class:`_BlockGraph`): the first
  runs eagerly on a side stream (lazy initialisation, and real work); at
  the second, one step and the check's close (cost, history write,
  relative change) are captured there, and every block from then on is
  ``chunk`` replays of the step's graph and one of the close's, over the
  graphs' own buffers.  A solve makes its graphs for the call and frees
  them on return, where the call replays at least :data:`MIN_REPLAYS`
  blocks and a step's work is below :data:`GRAPH_MAX_WORK` (past it the
  device sets the pace and a graph gains nothing: M x N x K for a dense
  step, the occupied tiles' T x bm x bn x K for a tile-sparse one, which
  its caller passes); a served program keeps
  its graphs across calls in a :class:`GraphCache` of its own, freed with
  it, and a streamed transform keeps them across its blocks in a
  :class:`StreamGraphs`, over the stream's device buffers (X read where
  its block lands, a graph a buffer and width).  A replay runs no
  wrapper, so it adds the launches its capture recorded
  (``fused_mu.add_counts``).  The batched loop replays its blocks by the
  same rule over a member axis (:mod:`nmf_tpu_torch.parallel.batched`).
  The tail block, the CPU, the sharded (the tile-sparse one too), the
  streamed solve's and the COO loops run eagerly;
  a failed capture or replay raises;
* with ``thresh == 0`` nothing is read back until the run ends, so exactly
  ``max_iter`` iterations run (nmf.cu:11); with ``thresh > 0`` the graphed
  loop stops on the device, as JAX's ``while_loop`` cond does: the close
  sets a device flag, ``running``, and every block's graphs (a ragged
  tail's too) replay under a CUDA IF conditional node on it
  (:meth:`_CudaGraphs.when`, ``csrc/graph_if.cu``), so the host enqueues
  blocks without reading the card, paces itself on the events of the
  blocks two back (:class:`_Pace`; at most two blocks run as no-ops after
  the stop) and reads the card once, at the end; the eager loop reads one
  scalar a check.  Conditional nodes need CUDA 12.4 or later, in the
  runtime and on the card: without them the capture raises, and no loop
  reads the card instead.

``accelerate=True`` runs the safeguarded Nesterov loop.  JAX decides its
accept or reject on the device (``lax.cond``), and so does the graphed
route (the rule above, one device, CUDA; :class:`_AccelGraph`): the
momentum is a device scalar, the accept test, the momentum's grow or
shrink, the history write, the relative change and the stop run on the
device, and the redo's graphs replay under an IF node on the device's
reject flag, captured with the accelerated part's after the first block;
the host reads the card once, at the end (the redos, counted on the
device, among it).  The eager :func:`_run_accel_loop` (the CPU, a mesh,
``graphs=False``, the streamed loops, below the rule) reads each block's
cost, two on a reject; the two give the same bits.

``live_metrics=True`` calls :func:`~nmf_tpu_torch.utils.metrics.emit_live`
at each check with ``(iteration, cost, rel_change)``, the values of JAX's
loops (``rel_change`` NaN at the first check of a run with no baseline).
The loops read the cost and the relative change back for it, one read a
check, which they do not make otherwise.  No value of the solve changes.

Every precision policy runs: the state in f32 or bf16, X as f32, bf16 or
uint8 codes with scales (quantized at load, or passed in as a pair).

Every family of the JAX package runs: the KL MU (the fused kernels, or
plain ops by :func:`_use_kernels`), and the beta-divergence MU (``beta !=
1``), HALS (``algorithm="hals"``) and the penalized KL MU (L1/L2), which
take plain ops on every device, as in JAX (``solver.py:113-127``).

:func:`solve` resolves ``backend="auto"`` and ``"autotune"`` per shape
before it builds the step, as JAX's ``solve`` does
(:func:`nmf_tpu_torch.utils.autotune.resolve_config`): on CUDA tensors the
card's measured rule, or a measurement cached on disk; on CPU tensors the
kernel wrappers, which take their plain versions there.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.divergence import beta_divergence, kl_divergence
from ..ops.hals import hals_step
from ..ops.kernels import fused_mu
from ..ops.mu import mu_step, mu_step_beta, mu_step_kl_reg
from ..ops.quant import dequantize, quantize_policy
from ..utils.autotune import resolve_config
from ..utils.config import SolveConfig
from ..utils.convert import to_tensor
from ..utils.device import resolve_device
from ..utils.metrics import emit_live

__all__ = ["SolveResult", "solve", "solve_jit", "resolve_step_fn", "run_checked_loop"]

_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
StepFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
CostFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class SolveResult:
    """Factorization result, the fields of ``nmf_tpu``'s ``SolveResult``.

    ``w``, ``h``, ``cost``, ``cost_history`` and ``momentum`` stay on the
    solve's device; ``iterations``, ``num_checks`` and ``converged`` are
    known on the host and are CPU tensors.  ``momentum`` is the accelerated
    loop's final momentum coefficient, NaN for a plain solve.  ``w_ex`` and
    ``h_ex`` are the accelerated loop's extrapolation carry, set only when
    the solve was given ``initial_extrap`` (a segment of a longer run): a
    segment fed ``momentum`` and ``(w_ex, h_ex)`` back as
    ``initial_momentum`` and ``initial_extrap`` continues the run exactly.
    """

    w: torch.Tensor
    h: torch.Tensor
    iterations: torch.Tensor     # i32 scalar: MU iterations actually run
    cost: torch.Tensor           # f32 scalar: final divergence (NaN if none)
    cost_history: torch.Tensor   # f32 [num_check_slots]
    num_checks: torch.Tensor     # i32 scalar: populated history entries
    converged: torch.Tensor      # bool scalar: stopped via threshold
    momentum: torch.Tensor = None   # f32 scalar: final accel momentum (NaN if none)
    w_ex: torch.Tensor = None
    h_ex: torch.Tensor = None


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _use_kernels(config: SolveConfig) -> bool:
    """Whether the step and cost go to the fused kernels.

    ``"jnp"`` means plain torch ops; ``"pallas"`` the kernels, and so do
    ``"auto"`` and ``"autotune"`` where nothing resolved them by shape
    (:func:`nmf_tpu_torch.utils.autotune.resolve_config` does, at every
    entry point).  Per-row-block int8 scales are not in
    the kernels: ``"pallas"`` raises, ``"auto"`` takes the plain ops on
    dequantized X (``nmf_tpu/models/solver.py:137-151``).  The JAX rule that
    ``auto`` sends int8 X to jnp is a TPU rule (Mosaic's slow uint8 path)
    and is not carried over: per-column int8 X goes to the kernels here.
    """
    if config.backend == "jnp":
        return False
    if config.precision.x_dtype == "int8" and config.precision.x_quant_rows:
        if config.backend == "pallas":
            raise NotImplementedError(
                "per-row-block int8 scales take the jnp path (the fused "
                "kernels' scales operand is per-column); drop "
                "backend='pallas' or x_quant_rows"
            )
        return False
    return True


def _dequant_wrap_step(step_fn: StepFn) -> StepFn:
    """A step on dense X as a step on ``(codes, scales)``: the plain ops on
    dequantized X."""
    return lambda w, h, x: step_fn(w, h, dequantize(*x))


def _dequant_wrap_cost(cost_fn: CostFn) -> CostFn:
    return lambda x, w, h: cost_fn(dequantize(*x), w, h)


def _family_step(config: SolveConfig) -> Optional[StepFn]:
    """The plain step of the beta, HALS and penalized families (every
    device, ``nmf_tpu/models/solver.py:113-127``), or None for KL MU."""
    eps, prec = config.eps, config.precision
    if config.algorithm == "hals":
        return functools.partial(hals_step, eps=eps, precision=prec)
    if config.beta != 1.0:
        return functools.partial(mu_step_beta, beta=config.beta, eps=eps, precision=prec)
    if config.regularized:
        return functools.partial(
            mu_step_kl_reg, eps=eps, precision=prec,
            l1_w=config.l1_w, l1_h=config.l1_h, l2_w=config.l2_w, l2_h=config.l2_h,
        )
    return None


def resolve_step_fn(config: SolveConfig) -> StepFn:
    """The per-iteration update for this config.

    The beta, HALS and penalized families take plain torch ops; KL MU the
    fused kernels (which take their plain version for CPU tensors and
    dequantize int8 X themselves) or plain torch ops, by :func:`_use_kernels`.
    """
    config.validate()
    fn = _family_step(config)
    if fn is None:
        if _use_kernels(config):
            return functools.partial(
                fused_mu.mu_step_fused, eps=config.eps, precision=config.precision
            )
        fn = functools.partial(mu_step, eps=config.eps, precision=config.precision)
    return _dequant_wrap_step(fn) if config.precision.x_dtype == "int8" else fn


def _cost_fn(config: SolveConfig) -> CostFn:
    eps = config.eps
    if config.beta != 1.0:
        fn = functools.partial(beta_divergence, beta=config.beta, eps=eps)
    elif config.regularized:
        def fn(x, w, h):
            # KL + l1 ||.||_1 + (l2 / 2) ||.||_F^2 (``solver.py:159-172`` of JAX)
            wf, hf = w.to(_F32), h.to(_F32)
            pen = (config.l1_w * torch.sum(torch.abs(wf)) + config.l1_h * torch.sum(torch.abs(hf))
                   + 0.5 * config.l2_w * torch.sum(wf * wf)
                   + 0.5 * config.l2_h * torch.sum(hf * hf))
            return kl_divergence(x, w, h, eps) + pen
    elif _use_kernels(config):
        return functools.partial(fused_mu.kl_cost_fused, eps=eps, precision=config.precision)
    else:
        fn = functools.partial(kl_divergence, eps=eps)
    return _dequant_wrap_cost(fn) if config.precision.x_dtype == "int8" else fn


def close_check(x, w, h, cost, hist, idx, cost_fn: CostFn):
    """A check's close on device tensors alone: the cost, its write into
    ``hist`` at the device index ``idx`` (one int64, advanced in place) and
    the relative change against the baseline ``cost``, in f32 as the JAX
    loop computes it (NaN against a NaN baseline).  Returns ``(cost, rel)``."""
    new = cost_fn(x, w, h).to(_F32)
    hist.index_copy_(0, idx, new.reshape(1))
    idx.add_(1)
    return new, torch.abs(cost - new) / torch.abs(new)


def check_block(x, w, h, cost, hist, idx, step_fn: StepFn, cost_fn: CostFn, chunk: int,
                need_cost: bool):
    """One check block on device tensors alone: ``chunk`` steps, then (with
    ``need_cost``) :func:`close_check`.  Returns ``(w, h, cost, rel)``
    (``cost`` passed through and ``rel`` None without ``need_cost``).
    Nothing is read back to the host: the eager loop runs it, and the
    captured loop its two parts, the step and the close."""
    for _ in range(chunk):
        w, h = step_fn(w, h, x)
    if not need_cost:
        return w, h, cost, None
    return (w, h) + close_check(x, w, h, cost, hist, idx, cost_fn)


# The captured loop's bookkeeping since the last reset: full blocks run
# eagerly before a capture, parts captured, check blocks replayed, blocks
# enqueued after the loop stopped on the device (their IF nodes ran
# nothing), the host's waits on a block's event (the stop's lookahead,
# :class:`_Pace`), and the host seconds the captures took (chip_smoke.py
# and probe_timings.py read them).
GRAPH_COUNTS: Dict[str, float] = {"warm_ups": 0, "captures": 0, "replays": 0, "skipped": 0,
                                  "waits": 0, "capture_s": 0.0}
# The accelerated loops' rejected blocks, redone by the eager loops (the
# host decides) and replayed by the graphed ones (under the device's
# reject flag, counted on the device), and every read of the card by a
# check-blocked loop (``_host_read``).
ACCEL_COUNTS: Dict[str, int] = {"redo_eager": 0, "redo_replays": 0, "reads": 0}
# The IF node's kernel (``csrc/graph_if.cu``'s ``set_if``): one launch a
# replay of a graph under a flag, counted where :class:`_IfGraph` launches
# it, whether the flag then runs the graph's work or not.
IF_LAUNCHES: Dict[str, int] = {"set_if": 0}

# A graph made for one call is made only where it will replay at least this
# many of the call's full blocks (its first runs eagerly): below that its
# capture costs more host time than the replays save.  And no graph where
# a step's work (M x N x K; T x bm x bn x K over a tile-sparse X's T
# occupied tiles) reaches GRAPH_MAX_WORK: the device, not the
# host, sets the pace there, so a graph gains nothing, and its memory pool
# would hold a second set of a step's temporaries while it lives
# (``probe_timings.py graph``; PERF.md section 6, PR 22).
MIN_REPLAYS = 3
GRAPH_MAX_WORK = 2 ** 32


def reset_graph_counts() -> None:
    """Set every count of :data:`GRAPH_COUNTS`, :data:`ACCEL_COUNTS` and
    :data:`IF_LAUNCHES` to 0."""
    for counts in (GRAPH_COUNTS, ACCEL_COUNTS, IF_LAUNCHES):
        for key in counts:
            counts[key] = 0


class _CudaGraphs:
    """What the captured loop asks of ``torch.cuda``, in one object: a CPU
    test puts a stand-in here to run the captured route on CPU tensors."""

    def __init__(self):
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def applies(self, dev: torch.device) -> bool:
        return dev.type == "cuda"

    def stream(self, dev: torch.device):
        """The device's side stream, on which every warm-up and capture runs
        (cuBLAS keeps its workspace per stream)."""
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def run_on(self, stream, fn: Callable[[], None]) -> None:
        """``fn()`` on ``stream``, after the current stream's work so far and
        before its next."""
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            fn()
        cur.wait_stream(stream)

    def capture(self, stream, fn: Callable[[], None], pool=None, pred=None):
        """``fn``'s work captured as a CUDA graph on ``stream`` (nothing runs),
        its memory in ``pool`` (another graph's) or a pool of its own; with
        ``pred`` that graph under :meth:`when`."""
        graph = torch.cuda.CUDAGraph(keep_graph=pred is not None)
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                fn()
            finally:
                graph.capture_end()
        return graph if pred is None else self.when(pred, graph)

    def when(self, pred: torch.Tensor, graph):
        """A graph whose replay runs ``graph``'s work only where ``pred`` (a
        device bool at a fixed address) holds when the replay reaches it:
        an IF conditional node, the one place that reaches CUDA's
        conditional nodes (:class:`_IfGraph`)."""
        return _IfGraph(graph, pred)

    def event(self):
        """An event to record on the current stream and wait on."""
        return torch.cuda.Event()


class _IfGraph:
    """A captured graph under an IF conditional node: ``csrc/graph_if.cu``'s
    graph of two nodes (one thread sets the node's handle from ``pred``,
    then the IF node runs a copy of ``graph``), instantiated once and
    launched by :meth:`replay` on the current stream.  It keeps ``graph``
    (captured with ``keep_graph=True``: its memory pool) and ``pred`` (the
    address the launch reads) alive, and frees its own graph with itself.
    Conditional nodes need CUDA 12.4 or later, in the runtime and on
    the card: without them the capture raises, and no loop reads the card
    instead."""

    def __init__(self, graph, pred: torch.Tensor):
        lib = fused_mu._lib()
        self.graph, self.pred = graph, pred
        self.exec, own = ctypes.c_void_p(), ctypes.c_void_p()
        fused_mu._raise_on(
            lib, lib.nmf_if_graph(graph.raw_cuda_graph(), pred.data_ptr(), fused_mu._index(pred),
                                  ctypes.byref(self.exec), ctypes.byref(own)),
            "an IF conditional node around a captured graph (CUDA 12.4 or later, in the "
            "runtime and on the card)")
        weakref.finalize(self, lib.nmf_if_graph_destroy, self.exec, own)

    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        lib = fused_mu._lib()
        fused_mu._raise_on(lib, lib.nmf_graph_launch(self.exec, fused_mu._stream(self.pred)),
                           "a conditional graph's launch")
        IF_LAUNCHES["set_if"] += 1


_GRAPHS = _CudaGraphs()
_EAGER = False


@contextlib.contextmanager
def eager_loop():
    """Run the plain, the accelerated and the batched loops' check blocks
    eagerly on the card too, inside this context: the comparison that
    holds the captured loops to the eager ones (``chip_smoke.py``,
    ``probe_timings.py graph``, ``accel``, ``batched`` and ``stop``).  No
    solve enters it by itself."""
    global _EAGER
    _EAGER = True
    try:
        yield
    finally:
        _EAGER = False


def _graph_rule(dev: torch.device, work: int) -> bool:
    """Whether a loop on ``dev`` whose step does ``work`` (M x N x K, or T x
    bm x bn x K over T occupied tiles, times the members on a member axis)
    may replay graphs: a CUDA device (or the
    tests' stand-in), outside :func:`eager_loop`, below
    :data:`GRAPH_MAX_WORK`.  The caller adds its own block count rule."""
    return not _EAGER and _GRAPHS.applies(dev) and work < GRAPH_MAX_WORK


def _layout(t) -> tuple:
    """A tensor's (or a nest of tuples') shape, strides, dtype and device."""
    if isinstance(t, tuple):
        return tuple(_layout(a) for a in t)
    return tuple(t.shape), t.stride(), t.dtype, t.device


def _addresses(t) -> tuple:
    """A tensor's (or a nest of tuples') data addresses."""
    if isinstance(t, tuple):
        return tuple(_addresses(a) for a in t)
    return t.data_ptr()


def _empty_like(t):
    """A nest of tuples of tensors like ``t``'s, uninitialised."""
    return tuple(_empty_like(a) for a in t) if isinstance(t, tuple) else torch.empty_like(t)


def _copy_into(dst, src) -> None:
    """Each tensor of the nest ``src`` into its place in ``dst``."""
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)


class _SharedPool:
    """The memory pool that several graphs capture into (None until the
    first capture makes it)."""

    pool = None


class _PartGraphs:
    """Parts of a loop run as CUDA graphs on the device's side stream, all
    in one memory pool: a part runs eagerly there until the owner is warm
    (its first run does the lazy initialisation a capture cannot do: the
    kernel library's load, cuBLAS's handle and workspace, lazy module
    loading), then is captured at its first replay and replayed from then
    on.  A part is ``chunk`` runs of a step and one of a close.  A replay
    adds the launches its capture recorded to the counts
    (``fused_mu.add_counts``): no wrapper runs at a replay.  A part may
    replay under a device flag (``pred``, :meth:`_CudaGraphs.when`): then
    only the device knows whether its launches ran, and the loop adds them
    after its read at the end (:meth:`_launched`).  Subclasses hold the
    graphs' buffers and name them in ``state()``."""

    def __init__(self, dev: torch.device, chunk: int):
        self.dev, self.chunk = dev, chunk
        self.warm = False
        # the memory pool of every graph this object captures (a streamed
        # call's graphs share the call's)
        self.shared = _SharedPool()
        # name -> (graphs, the launches of a step's replay, of a close's)
        self.parts: Dict[str, tuple] = {}

    def _captured(self, fn, pred):
        """(``fn`` captured as a graph, under ``pred`` where given, the
        launches its capture counted, taken back: a capture launches
        nothing)."""
        before = fused_mu.count_snapshot()
        graph = _GRAPHS.capture(_GRAPHS.stream(self.dev), fn, self.shared.pool, pred)
        if self.shared.pool is None:
            self.shared.pool = graph.pool()
        counts = fused_mu.count_delta(before)
        fused_mu.add_counts(counts, -1)
        return graph, counts

    def _capture(self, name: str, step, close, pred) -> None:
        """Part ``name``'s graphs: a step's and, where ``close`` is not
        None, the close's."""
        t0 = time.perf_counter()
        graph, per_step = self._captured(step, pred)
        graphs, per_close = [graph], {}
        if close is not None:
            graph, per_close = self._captured(close, pred)
            graphs.append(graph)
        self.parts[name] = graphs, per_step, per_close
        GRAPH_COUNTS["captures"] += 1
        GRAPH_COUNTS["capture_s"] += time.perf_counter() - t0

    def _part(self, name: str, step, close, chunk: int, replay: bool, pred=None) -> None:
        """``chunk`` steps, then the close (None: none): a full block eagerly
        on the side stream, or replayed from the graphs of part ``name``,
        captured at its first replay, under the flag ``pred`` where given."""
        if not replay:
            def run():
                for _ in range(chunk):
                    step()
                if close is not None:
                    close()

            _GRAPHS.run_on(_GRAPHS.stream(self.dev), run)
            return
        if name not in self.parts:
            self._capture(name, step, close, pred)
        graphs = self.parts[name][0]
        for _ in range(chunk):
            graphs[0].replay()
        for graph in graphs[1:]:
            graph.replay()
        if pred is None:
            self._launched(name, chunk, 1)

    def _launched(self, name: str, steps: int, closes: int) -> None:
        """The launches of ``steps`` replayed steps and ``closes`` closes of
        part ``name``, into the counts."""
        _, per_step, per_close = self.parts[name]
        fused_mu.add_counts(per_step, steps)
        fused_mu.add_counts(per_close, closes)


class _BlockGraph(_PartGraphs):
    """Full check blocks over static state, the counterpart of the JAX
    loop's inner ``fori_loop`` under ``jit``: the first block runs eagerly
    on the side stream; at the second, one step and the check's close are
    each captured there as a CUDA graph (one memory pool), and every block
    from then on is ``chunk`` replays of the step's graph and one of the
    close's.  A step's capture costs a step's host time, where a whole
    block's would cost a block's (PERF.md section 6).

    ``w``, ``h``, ``cost`` (the baseline), ``rel``, ``hist`` and ``idx`` are
    the graphs' own buffers, each graph copying its results back into
    them, and so is X when ``own_x`` (a graph kept across calls: each
    call's X is copied in, so no address of a tensor its caller frees is
    baked in); else X is read where the call holds it.

    With ``stop`` (a threshold above 0) the loop stops on the device, as
    JAX's ``while_loop`` cond does: the close also counts the check in
    ``chk`` and sets ``running`` to ``not rel < stop`` (an f32 compare, as
    JAX's; NaN never stops), and both graphs replay under an IF node on
    ``running``, so a block enqueued after the stop runs nothing, its
    ragged tail too (:func:`_enqueue_blocks`)."""

    def __init__(self, x, w, h, n_slots: int, step_fn: StepFn, cost_fn: CostFn, chunk: int,
                 need_cost: bool, own_x: bool, stop: float = 0.0):
        super().__init__(w.device, chunk)
        f32 = dict(dtype=_F32, device=w.device)
        self.w, self.h = torch.empty_like(w), torch.empty_like(h)
        self.cost = torch.empty((), **f32)
        self.rel = torch.full((), float("nan"), **f32)
        self.hist = torch.empty((n_slots,), **f32)
        self.idx = torch.zeros((1,), dtype=torch.int64, device=w.device)
        self.running = torch.ones((), dtype=torch.bool, device=w.device)
        self.chk = torch.zeros((), dtype=torch.int64, device=w.device)
        self.x = _empty_like(x) if own_x else None
        self.own_x = own_x
        self.step_fn, self.cost_fn, self.need_cost = step_fn, cost_fn, need_cost
        self.stop = float(stop)
        # this call's blocks run eagerly, and replays enqueued under a flag
        self.eager_blocks = self.queued = 0

    def state(self) -> Tuple[torch.Tensor, ...]:
        return self.w, self.h, self.cost, self.rel, self.hist, self.idx, self.running, self.chk

    def load(self, x, w, h, c0: float) -> None:
        """A call's X and start: its W, H and baseline into the buffers."""
        if self.own_x:
            _copy_into(self.x, x)
        else:
            self.x = x
        self.w.copy_(w)
        self.h.copy_(h)
        self.cost.fill_(c0)
        self.hist.fill_(float("nan"))
        self.idx.zero_()
        self._new_call()

    def _new_call(self) -> None:
        """A call's start of the loop's device flags and counts."""
        self.running.fill_(True)
        self.chk.zero_()
        self.eager_blocks = self.queued = 0

    def _step(self) -> None:
        w, h = self.step_fn(self.w, self.h, self.x)
        self.w.copy_(w)
        self.h.copy_(h)

    def _check(self) -> torch.Tensor:
        """:func:`close_check` on the buffers; returns the relative change."""
        cost, rel = close_check(self.x, self.w, self.h, self.cost, self.hist, self.idx,
                                self.cost_fn)
        self.cost.copy_(cost)
        self.rel.copy_(rel)
        return rel

    def _close(self) -> None:
        rel = self._check()
        if self.stop:
            self.chk.add_(1)
            self.running.copy_(~(rel < self.stop))

    def _flag(self) -> Optional[torch.Tensor]:
        """The flag the blocks replay under: ``running`` with the stop."""
        return self.running if self.stop else None

    def _counted(self, pred) -> None:
        """Count a block: the first eagerly, a replay (under ``pred``: one
        enqueued, settled by :meth:`_settle`)."""
        if not self.warm:
            GRAPH_COUNTS["warm_ups"] += 1
            self.eager_blocks += 1
            self.warm = True
        elif pred is None:
            GRAPH_COUNTS["replays"] += 1
        else:
            self.queued += 1

    def block(self, chunk: int) -> None:
        """Run one block of ``chunk`` steps: the first (a full one) eagerly
        on the side stream (the kernel library's load, cuBLAS's handle and
        workspace, lazy module loading: what a capture cannot do, and real
        work), the later ones as replays, captured at the second."""
        self._part("block", self._step, self._close if self.need_cost else None, chunk,
                   self.warm, self._flag())
        self._counted(self._flag())

    def _settle(self, name: str, checks: int, steps: int) -> None:
        """The counts and launches of part ``name``'s replays under a flag,
        after the call's read of the device: ``checks`` blocks and
        ``steps`` steps ran in all, the eager block's among them."""
        ran = checks - self.eager_blocks
        self._launched(name, steps - self.eager_blocks * self.chunk, ran)
        GRAPH_COUNTS["replays"] += ran
        GRAPH_COUNTS["skipped"] += self.queued - ran

    def end(self, max_iter: int) -> Tuple[int, int, bool]:
        """The call's one read of the device, at its end: (iterations,
        checks, whether the loop runs on), its replays settled."""
        checks, running = _host_read(torch.stack((self.chk, self.running.long())))
        its = min(checks * self.chunk, max_iter)
        self._settle("block", checks, its)
        return its, checks, bool(running)


class _AccelGraph(_BlockGraph):
    """Check blocks of the accelerated loop over static state, the
    counterpart of the JAX loop's body (``solver.py:561-596``): the
    momentum ``m``, the accept test, the momentum's grow or shrink, the
    history write, the relative change and the stop stay on the device,
    and the host reads nothing until the call ends.  The parts, each
    ``_BlockGraph._part``'s step and close:

    * ``"accel"``: :meth:`_accel_step` (a step from ``(we, he)``, then both
      extrapolations against the last iterate, which
      ``fused_mu.extrapolate_into`` writes with the new iterate in one
      launch) ``chunk`` times, and :meth:`_accel_close` (the iterate's
      cost, the test, which sets ``reject``, and where it passes the
      block's close; where it fails ``(w, h)`` back to the block's start
      ``(w0, h0)``), under ``running`` where the loop stops on the device;
    * ``"redo"``, under an IF node on ``reject`` (JAX's ``lax.cond``): the
      plain step ``chunk`` times from ``(w, h)`` and :meth:`_redo_close`
      (its cost and close, the carry restarted at ``(w, h)``, ``m``
      shrunk, ``reject`` cleared, the redo counted in ``redos``).

    The first block's accelerated part runs eagerly on the side stream;
    both parts are captured right after it, so the first block's redo
    replays too and no reject waits for a capture.  The baseline seed cost
    is taken on the device at :meth:`load`.  Every value is computed by
    the ops and in the order of :func:`_run_accel_loop`, so the two give
    the same bits."""

    def __init__(self, x, w, h, n_slots: int, step_fn: StepFn, cost_fn: CostFn, chunk: int,
                 config: SolveConfig, own_x: bool):
        super().__init__(x, w, h, n_slots, step_fn, cost_fn, chunk, True, own_x, config.thresh)
        f32 = dict(dtype=_F32, device=w.device)
        self.we, self.he, self.w0, self.h0 = (torch.empty_like(t) for t in (w, h, w, h))
        self.m = torch.empty((), **f32)
        self.reject = torch.zeros((), dtype=torch.bool, device=w.device)
        # redone blocks and their steps, and what a redo adds to them
        self.redos = torch.zeros((2,), dtype=torch.int64, device=w.device)
        self.redo_add = torch.ones((2,), dtype=torch.int64, device=w.device)
        self.grow, self.shrink, self.m_max = (
            torch.tensor(v, **f32)
            for v in (config.accel_grow, config.accel_shrink, config.accel_momentum_max))
        self.eps = float(config.eps)

    def state(self) -> Tuple[torch.Tensor, ...]:
        return super().state() + (self.we, self.he, self.w0, self.h0, self.m, self.reject,
                                  self.redos, self.redo_add)

    def load(self, x, w, h, c0: Optional[float], m0: float, extrap) -> None:
        """A call's X and start, its baseline (None: the seed cost, taken
        here), momentum and carry (None: the iterate)."""
        super().load(x, w, h, float("nan") if c0 is None else c0)
        if c0 is None:
            self.cost.copy_(self.cost_fn(self.x, self.w, self.h).to(_F32))
        self.m.fill_(m0)
        we, he = (w, h) if extrap is None else extrap
        for buf, t in ((self.we, we), (self.he, he), (self.w0, w), (self.h0, h)):
            buf.copy_(t)

    def _new_call(self) -> None:
        super()._new_call()
        self.reject.fill_(False)
        self.redos.zero_()
        self.redo_add[1:].fill_(self.chunk)

    def _accel_step(self) -> None:
        wn, hn = self.step_fn(self.we, self.he, self.x)
        fused_mu.extrapolate_into(((wn, self.w, self.we), (hn, self.h, self.he)), self.m,
                                  self.eps)

    def _accel_close(self) -> None:
        c1 = self.cost_fn(self.x, self.w, self.h).to(_F32)
        ok = c1 <= self.cost                  # false for NaN
        rel = torch.abs(self.cost - c1) / torch.abs(c1)
        self.reject.copy_(~ok)
        self.chk.add_(1)
        self.running.copy_(~(ok & (rel < self.stop)))
        self.m.copy_(torch.where(ok, torch.minimum(self.m * self.grow, self.m_max), self.m))
        self.hist.index_copy_(0, self.idx,
                              torch.where(ok, c1, self.hist.index_select(0, self.idx)))
        self.idx.add_(ok.to(torch.int64))
        self.rel.copy_(torch.where(ok, rel, self.rel))
        self.cost.copy_(torch.where(ok, c1, self.cost))
        for t, t0 in ((self.w, self.w0), (self.h, self.h0)):
            t.copy_(torch.where(ok, t, t0))
            t0.copy_(t)

    def _redo_close(self) -> None:
        rel = self._check()
        self.running.copy_(~(rel < self.stop))
        self.m.mul_(self.shrink)
        for t, ex, t0 in ((self.w, self.we, self.w0), (self.h, self.he, self.h0)):
            ex.copy_(t)
            t0.copy_(t)
        self.redos.add_(self.redo_add)
        self.reject.fill_(False)

    def block(self, chunk: int) -> None:
        """One check block of ``chunk`` steps: the accelerated part (the
        first block's eagerly), then the redo under ``reject``."""
        flag, replay = self._flag(), self.warm
        self._part("accel", self._accel_step, self._accel_close, chunk, replay, flag)
        if not replay:
            self._capture("accel", self._accel_step, self._accel_close, flag)
        if chunk != self.chunk:         # a ragged tail's redo counts its own steps
            self.redo_add[1:].fill_(chunk)
        self._part("redo", self._step, self._redo_close, chunk, True, self.reject)
        self._counted(flag)

    def end(self, max_iter: int) -> Tuple[int, int, bool]:
        checks, running, redos, redo_steps = _host_read(
            torch.cat((torch.stack((self.chk, self.running.long())), self.redos)))
        its = min(checks * self.chunk, max_iter)
        if self.stop:
            self._settle("accel", checks, its)
        self._launched("redo", redo_steps, redos)
        ACCEL_COUNTS["redo_replays"] += redos
        return its, checks, bool(running)


def _host_read(t: torch.Tensor) -> list:
    """A check-blocked loop's read of the card: ``t``'s values as host
    numbers, counted in ``ACCEL_COUNTS["reads"]``."""
    ACCEL_COUNTS["reads"] += 1
    return t.tolist()


class _Pace:
    """The host's lookahead over a loop that stops on the device: after
    each block the device copies the loop's ``flag`` into pinned host
    memory and an event is recorded; once block k is enqueued the host
    waits for block k - DEPTH's event (never on a value: no read of the
    card, and the device never waits on the host before the stop) and
    reads that copy.  So the host runs at most DEPTH blocks ahead of the
    last one it knows has ended, and at most DEPTH blocks are enqueued
    after the stop (their IF nodes run nothing)."""

    DEPTH = 2

    def __init__(self, flag: torch.Tensor):
        self.flag = flag
        self.copies = torch.empty((self.DEPTH + 1,), dtype=torch.bool, pin_memory=flag.is_cuda)
        self.marks = collections.deque()
        self.blocks = 0

    def stopped(self) -> bool:
        """After a block is enqueued: whether the host knows the stop."""
        slot = self.blocks % len(self.copies)
        self.blocks += 1
        self.copies[slot].copy_(self.flag, non_blocking=True)
        event = _GRAPHS.event()
        event.record()
        self.marks.append((event, slot))
        if len(self.marks) <= self.DEPTH:
            return False
        event, slot = self.marks.popleft()
        event.synchronize()
        GRAPH_COUNTS["waits"] += 1
        return not self.copies.numpy()[slot]


def _enqueue_blocks(runner: _BlockGraph, max_iter: int, check_every: int, stop: bool,
                    live: Optional[Callable[[int], bool]] = None) -> None:
    """A call's check blocks on a graph runner, the last one ragged where
    ``max_iter`` asks, with no read of the card: where the loop ``stop``s
    on the device the host paces itself on the blocks' events
    (:class:`_Pace`) and stops enqueueing once it sees the stop.
    ``live(it)``, where given, reads the card after each block (live
    metrics) and says whether the loop runs on."""
    pace = _Pace(runner.running) if stop and live is None else None
    it = 0
    while it < max_iter:
        chunk = min(check_every, max_iter - it)
        runner.block(chunk)
        it += chunk
        if live is not None and not live(it):
            return
        if pace is not None and pace.stopped():
            return


class GraphCache:
    """Check-block graphs kept across calls by the object that holds this
    cache, and freed with it: a served program holds one (its blocks share
    one layout, so one graph), and a stream of one-block calls replays from
    its second block on.  Keyed by all that a capture bakes in: the step
    and cost, the config, the layouts of X, W and H (X is the graph's own
    buffer, so no address).  Only for a step and cost that close over no
    tensor of a call."""

    own_x = True

    def __init__(self):
        self.graphs: Dict[tuple, _PartGraphs] = {}

    def x_key(self, x) -> tuple:
        """What a graph over X bakes in of it."""
        return _layout(x)

    def allows(self, width: int) -> bool:
        """Whether a call whose blocks are ``width`` columns wide graphs."""
        return True

    def get(self, key, make: Callable[[], _PartGraphs]) -> _PartGraphs:
        if key not in self.graphs:
            self.graphs[key] = make()
        return self.graphs[key]


class StreamGraphs(GraphCache):
    """Graphs kept for the length of one streamed call, over the stream's
    device buffers, which stay at fixed addresses for the whole call and
    outlive this cache (``streaming._BlockStream``: two for X, two for a
    mask, two for int8 scales).  X is read where the block lands, with no
    copy (one more block of X would break the streamed paths' bound of a
    third of X in device memory), so the key holds X's addresses beside the
    layouts: a graph a stream slot and width.

    ``full_blocks`` maps a block width to the full blocks the call runs at
    it, over all its blocks and passes (check blocks for the transform, one
    a block for the online learner): a width graphs only where they number
    more than :data:`MIN_REPLAYS`, as a call's own graph must replay at
    least that many after its warm one.

    Every graph of the call captures into one memory pool: each capture's
    temporaries are dead when it ends (its results are copied into its
    graph's own buffers), so a capture reuses the pool that an earlier
    one grew, and replays in any order never meet a live tensor there
    (the online learner's block-sized temporaries made a second pool cost
    a second capture's allocations: PERF.md section 6)."""

    own_x = False

    def __init__(self, full_blocks: Dict[int, int]):
        super().__init__()
        self.full_blocks = dict(full_blocks)
        self.shared = _SharedPool()

    def get(self, key, make: Callable[[], _PartGraphs]) -> _PartGraphs:
        if key not in self.graphs:
            runner = make()
            runner.shared = self.shared
            self.graphs[key] = runner
        return self.graphs[key]

    def x_key(self, x) -> tuple:
        return _layout(x), _addresses(x)

    def allows(self, width: int) -> bool:
        return self.full_blocks.get(width, 0) > MIN_REPLAYS


def run_checked_loop(
    x: torch.Tensor,
    w: torch.Tensor,
    h: torch.Tensor,
    config: SolveConfig,
    step_fn: StepFn,
    cost_fn: CostFn,
    initial_cost: Optional[float] = None,
    initial_momentum: Optional[float] = None,
    initial_extrap: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    all_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    live_emit: Optional[Callable] = None,
    graphs=True,
    work: Optional[int] = None,
) -> SolveResult:
    """The check-blocked loop (``solver.py:402-498`` of the JAX package).

    ``initial_cost`` seeds the convergence baseline (None/NaN: the first
    check never converges).  ``config.accelerate`` runs the accelerated
    loop, with ``initial_momentum`` and ``initial_extrap``.
    ``config.live_metrics`` emits each check (module docstring) through
    ``live_emit`` (default :func:`emit_live`).

    ``all_reduce`` sums a cost partial over the ranks of a mesh (the
    sharded solves; default: the identity): it runs before the check's
    host read, so every rank reads the same cost and takes the same stop,
    and the loop stays uniform across ranks.

    Each block is :func:`check_block`.  On CUDA tensors with the identity
    ``all_reduce``, the full-length blocks run as a CUDA graph
    (:class:`_BlockGraph`; module docstring) where a step's ``work`` is
    below :data:`GRAPH_MAX_WORK` (None: M x N x K, the dense step's; the
    tile-sparse solve passes its occupied tiles' T x bm x bn x K):
    ``graphs=True`` makes one for this call where it replays at least
    :data:`MIN_REPLAYS` blocks, and frees it on return; a
    :class:`GraphCache` keeps its graph across calls (only for a step and
    cost that close over no tensor of the call), a :class:`StreamGraphs`
    across one streamed call's blocks (X read in the stream's buffer, a
    graph a buffer and width, a width only where its rule allows);
    ``False`` runs every block eagerly (the streamed solve's and COO loops,
    a sharded tile-sparse one).  Under ``thresh > 0`` (without live
    metrics) a graphed loop stops on the device (:func:`_run_stop_graphed`).
    Under ``config.accelerate`` the same rule takes the accelerated loop's
    blocks to an :class:`_AccelGraph` (:func:`_run_accel_graphed`).  A
    failed capture or replay raises.
    """
    emit = emit_live if live_emit is None else live_emit
    max_iter = int(config.max_iter)
    check_every = int(config.check_every)
    thresh = float(config.thresh)
    # with thresh == 0 and no tracking the cost GEMM is skipped entirely
    need_cost = config.track_cost or thresh > 0.0
    live = bool(config.live_metrics)
    # the plain loop's stop on the device (live metrics read every check)
    stop = thresh if thresh > 0.0 and not live else 0.0
    dev = w.device
    runner = None
    n_full = max_iter // check_every
    n_slots = max(config.num_checks, 1)
    if work is None:
        work = w.shape[0] * w.shape[1] * h.shape[1]
    if graphs is not False and all_reduce is None and _graph_rule(dev, work):
        def make(own_x):
            if config.accelerate:
                return _AccelGraph(x, w, h, n_slots, step_fn, cost_fn, check_every, config, own_x)
            return _BlockGraph(x, w, h, n_slots, step_fn, cost_fn, check_every, need_cost, own_x,
                               stop)

        if isinstance(graphs, GraphCache):
            if n_full and graphs.allows(h.shape[-1]):
                key = (step_fn, cost_fn, config, graphs.x_key(x), _layout(w), _layout(h))
                runner = graphs.get(key, lambda: make(graphs.own_x))
        elif n_full > MIN_REPLAYS:
            runner = make(False)
    if config.accelerate:
        if runner is not None:
            return _run_accel_graphed(runner, x, w, h, config, initial_cost, initial_momentum,
                                      initial_extrap, emit)
        return _run_accel_loop(x, w, h, config, step_fn, cost_fn, initial_cost,
                               initial_momentum, initial_extrap,
                               _identity if all_reduce is None else all_reduce, emit)
    c0 = float("nan") if initial_cost is None else float(initial_cost)
    if runner is not None and stop:
        return _run_stop_graphed(runner, x, w, h, config, c0)
    if all_reduce is not None:
        def cost_fn(x_, w_, h_, _cost=cost_fn):
            return all_reduce(_cost(x_, w_, h_))
    if runner is not None:
        runner.load(x, w, h, c0)
        w, h, cost, rel, hist, idx = runner.state()[:6]
    else:
        hist = torch.full((n_slots,), float("nan"), dtype=_F32, device=dev)
        idx = torch.zeros((1,), dtype=torch.int64, device=dev)
        cost = torch.full((), c0, dtype=_F32, device=dev)
    it, chk, done = 0, 0, False
    while it < max_iter and not done:
        chunk = min(check_every, max_iter - it)
        if runner is not None and chunk == check_every:
            runner.block(chunk)
            w, h, cost, rel = runner.w, runner.h, runner.cost, runner.rel
        else:
            w, h, cost, rel = check_block(x, w, h, cost, hist, idx, step_fn, cost_fn, chunk,
                                          need_cost)
        it += chunk
        if need_cost:
            if thresh > 0.0 or live:
                # the one host read per check, compared in f32 as the JAX
                # loop compares; NaN (the first check) never stops
                cost_h, rel_h = _host_read(torch.stack((cost, rel)))
                if live:
                    emit(it, cost_h, rel_h)
                if thresh > 0.0:
                    done = bool(np.float32(rel_h) < np.float32(thresh))
            chk += 1
    if runner is not None:
        # nothing returned aliases a buffer that a later replay writes
        w, h, cost, hist = (t.clone() if any(t is b for b in runner.state()) else t
                            for t in (w, h, cost, hist))
    return SolveResult(
        w=w,
        h=h,
        iterations=torch.tensor(it, dtype=torch.int32),
        cost=cost,
        cost_history=hist,
        num_checks=torch.tensor(chk, dtype=torch.int32),
        converged=torch.tensor(done, dtype=torch.bool),
        momentum=torch.full((), float("nan"), dtype=_F32, device=dev),
    )


def _run_stop_graphed(runner: _BlockGraph, x, w, h, config: SolveConfig,
                      c0: float) -> SolveResult:
    """The plain loop under ``thresh > 0`` through a :class:`_BlockGraph`
    that stops on the device: every block enqueued with no read of the
    card (:func:`_enqueue_blocks`), and one read at the end (the device's
    check count and flag).  The eager loop's bits; nothing returned
    aliases a buffer of the runner."""
    runner.load(x, w, h, c0)
    _enqueue_blocks(runner, int(config.max_iter), int(config.check_every), stop=True)
    its, checks, running = runner.end(int(config.max_iter))
    return SolveResult(
        w=runner.w.clone(),
        h=runner.h.clone(),
        iterations=torch.tensor(its, dtype=torch.int32),
        cost=runner.cost.clone(),
        cost_history=runner.hist.clone(),
        num_checks=torch.tensor(checks, dtype=torch.int32),
        converged=torch.tensor(not running, dtype=torch.bool),
        momentum=torch.full((), float("nan"), dtype=_F32, device=w.device),
    )


def extrapolate(new: torch.Tensor, old: torch.Tensor, m: float, eps: float) -> torch.Tensor:
    """``max(f32(new) + m (f32(new) - f32(old)), f32(eps))`` in the dtype of
    ``new`` (bf16: rounded to nearest even), with ``m`` and ``eps`` rounded
    to f32: the JAX loops' ``_extrap``, whose multiply-add XLA fuses into
    one FMA, as ``torch.add(..., alpha=m)`` computes it.  Plain torch ops,
    three elementwise passes on f32 state; the inputs are not written."""
    n32 = new.to(_F32)
    e = torch.add(n32, torch.sub(n32, old.to(_F32)), alpha=float(m)).clamp_min_(float(eps))
    return e.to(new.dtype)


def _momentum0(config: SolveConfig, initial_momentum: Optional[float]) -> np.float32:
    """The accelerated loop's first momentum: ``initial_momentum`` (a
    resumed segment's) unless None or NaN, else ``accel_momentum``."""
    if initial_momentum is not None and not np.isnan(initial_momentum):
        return np.float32(initial_momentum)
    return np.float32(config.accel_momentum)


def _run_accel_loop(
    x, w, h, config: SolveConfig, step_fn: StepFn, cost_fn: CostFn,
    initial_cost: Optional[float] = None,
    initial_momentum: Optional[float] = None,
    initial_extrap: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    all_reduce: Callable[[torch.Tensor], torch.Tensor] = _identity,
    emit: Callable = emit_live,
) -> SolveResult:
    """Safeguarded Nesterov-extrapolated loop (``config.accelerate``;
    ``solver.py:501-649`` of the JAX package).

    Each step runs from the extrapolated point ``(we, he)``
    (:func:`extrapolate` of the new iterate against the last one); the
    recorded iterate is the step's output.  At each block end the cost of
    the iterate decides: kept if it did not rise (the momentum grows by
    ``accel_grow`` up to ``accel_momentum_max``), else the block is redone
    with plain steps from its start, the extrapolation carry restarts at the
    new iterate and the momentum shrinks by ``accel_shrink``.  A NaN cost
    rejects.  So the recorded history never rises.

    The momentum is an f32 scalar, multiplied and capped in f32 as the JAX
    loop does on the device, so the final ``momentum`` is JAX's bit for bit
    wherever the accept/reject sequence is.  JAX decides on the device
    (``lax.cond``); this eager loop reads each block's cost back to decide,
    so it syncs the host once a block (twice on a reject).  The costs live
    on the host as f32, the history goes to the device at the end.  It is
    the route on the CPU, on a mesh and for ``graphs=False``, and the
    reference that the graphed route (:func:`_run_accel_graphed`, one read
    a block, the momentum and the decision's arithmetic on the device) is
    held to bit for bit.

    ``all_reduce`` and ``emit`` are :func:`run_checked_loop`'s: every cost
    read is summed over the mesh first, so each rank accepts or rejects
    alike.  The seed cost is taken up front unless ``initial_cost`` is
    given (not NaN); the carry starts at the iterate unless ``initial_extrap`` (in the
    state dtype, on the device) is given, and then comes back in
    ``w_ex``/``h_ex``.
    """
    max_iter = int(config.max_iter)
    check_every = int(config.check_every)
    thresh = np.float32(config.thresh)
    eps = config.eps
    n_slots = max(config.num_checks, 1)
    m = _momentum0(config, initial_momentum)
    m_max = np.float32(config.accel_momentum_max)
    grow = np.float32(config.accel_grow)
    shrink = np.float32(config.accel_shrink)

    def cost_of(w, h):
        # the host read: the accept test and the stop test are f32 compares
        return np.float32(all_reduce(cost_fn(x, w, h)).to(_F32).item())

    if initial_cost is None or np.isnan(initial_cost):
        cost = cost_of(w, h)
    else:
        cost = np.float32(initial_cost)
    we, he = (w, h) if initial_extrap is None else initial_extrap
    hist = np.full((n_slots,), np.nan, np.float32)
    it, chk, done = 0, 0, False
    while it < max_iter and not done:
        chunk = min(check_every, max_iter - it)
        w0, h0 = w, h           # the wrappers return fresh tensors: no copy
        for _ in range(chunk):
            wn, hn = step_fn(we, he, x)
            we, he = extrapolate(wn, w, m, eps), extrapolate(hn, h, m, eps)
            w, h = wn, hn
        c = cost_of(w, h)
        if c <= cost:
            m = min(np.float32(m * grow), m_max)
        else:                   # rejected (NaN too): redo the block plain
            ACCEL_COUNTS["redo_eager"] += 1
            w, h = w0, h0
            for _ in range(chunk):
                w, h = step_fn(w, h, x)
            c = cost_of(w, h)
            we, he = w, h
            m = np.float32(m * shrink)
        it += chunk
        prev, cost = cost, c
        hist[chk] = cost
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.abs(prev - cost) / np.abs(cost)   # f32, as on JAX's device
        if config.live_metrics:
            emit(it, cost, rel)
        if thresh > 0:
            done = bool(rel < thresh)
        chk += 1
    dev = w.device
    return SolveResult(
        w=w,
        h=h,
        iterations=torch.tensor(it, dtype=torch.int32),
        cost=torch.tensor(cost, dtype=_F32).to(dev),
        cost_history=torch.from_numpy(hist).to(dev),
        num_checks=torch.tensor(chk, dtype=torch.int32),
        converged=torch.tensor(done, dtype=torch.bool),
        momentum=torch.tensor(m, dtype=_F32).to(dev),
        w_ex=we if initial_extrap is not None else None,
        h_ex=he if initial_extrap is not None else None,
    )


def _run_accel_graphed(
    runner: _AccelGraph, x, w, h, config: SolveConfig,
    initial_cost: Optional[float], initial_momentum: Optional[float],
    initial_extrap: Optional[Tuple[torch.Tensor, torch.Tensor]], emit: Callable,
) -> SolveResult:
    """:func:`_run_accel_loop` on the card through an :class:`_AccelGraph`:
    the same start (seed cost, momentum, carry), decisions and bits.  The
    accept test and the stop are decided on the device, so the host reads
    the card once, at the end (and once a check for ``live_metrics``).
    Nothing returned aliases a buffer of the runner."""
    max_iter = int(config.max_iter)
    seeded = initial_cost is None or np.isnan(initial_cost)
    runner.load(x, w, h, None if seeded else float(np.float32(initial_cost)),
                float(_momentum0(config, initial_momentum)), initial_extrap)

    def live(it: int) -> bool:
        cost, rel, running = _host_read(
            torch.stack((runner.cost, runner.rel, runner.running.to(_F32))))
        emit(it, np.float32(cost), np.float32(rel))
        return bool(running)

    _enqueue_blocks(runner, max_iter, int(config.check_every), stop=config.thresh > 0,
                    live=live if config.live_metrics else None)
    its, checks, running = runner.end(max_iter)
    extrap = initial_extrap is not None
    return SolveResult(
        w=runner.w.clone(),
        h=runner.h.clone(),
        iterations=torch.tensor(its, dtype=torch.int32),
        cost=runner.cost.clone(),
        cost_history=runner.hist.clone(),
        num_checks=torch.tensor(checks, dtype=torch.int32),
        converged=torch.tensor(not running, dtype=torch.bool),
        momentum=runner.m.clone(),
        w_ex=runner.we.clone() if extrap else None,
        h_ex=runner.he.clone() if extrap else None,
    )


@functools.lru_cache(maxsize=32)
def solve_jit(config: SolveConfig, platform: Optional[str] = None):
    """The solver of a config, built once and cached (``solve_jit`` of
    ``nmf_tpu.models.solver``): ``_solve(x, w, h, initial_cost,
    initial_momentum=None, initial_extrap=None)`` runs
    :func:`run_checked_loop` with the config's step and cost on tensors
    already prepared (clamped, cast or quantized, on their device, as
    :func:`solve` prepares them).

    ``platform`` names the device type the tensors lie on, ``"cuda"`` or
    ``"cpu"`` (None: either); it keys the cache, as JAX's platform does,
    and the step is the same, because the kernel wrappers take their plain
    version for CPU tensors.  A config with ``backend="auto"`` or
    ``"autotune"`` takes the kernels here; :func:`solve` resolves the
    backend by the shape's rule before it builds the solver.

    JAX donates W and H to the jitted call.  Nothing here writes into the
    caller's ``w`` and ``h``: every step returns new tensors, so they keep
    their values, and the result's factors are new tensors.  ``initial_cost``
    (NaN or None: no baseline) and ``initial_momentum`` are host numbers or
    0-d tensors.
    """
    if platform not in (None, "cuda", "cpu"):
        raise ValueError(f"unsupported platform {platform!r}: use 'cuda' or 'cpu'")
    step_fn = resolve_step_fn(config)
    cost_fn = _cost_fn(config)

    def _solve(x, w, h, initial_cost, initial_momentum=None, initial_extrap=None):
        c0 = None if initial_cost is None else float(initial_cost)
        m0 = None if initial_momentum is None else float(initial_momentum)
        return run_checked_loop(x, w, h, config, step_fn, cost_fn,
                                None if c0 is None or np.isnan(c0) else c0, m0, initial_extrap)

    return _solve


def _shape(a) -> Tuple[int, ...]:
    return tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))


def check_inputs(x, w0, h0, config: SolveConfig) -> None:
    """The boundary checks of a solve: a ``(codes, scales)`` pair only
    under ``x_dtype="int8"`` with scales of the policy's rank, and the
    shapes of X, W and H."""
    if isinstance(x, tuple):
        if config.precision.x_dtype != "int8":
            raise ValueError(
                "X is a pre-quantized (codes, scales) pair but "
                f"Precision(x_dtype={config.precision.x_dtype!r}) — pre-quantized "
                "input requires x_dtype='int8' (quantize with "
                "ops.quant.quantize_policy on the same Precision)"
            )
        want = 2 if config.precision.x_quant_rows else 1
        if np.ndim(x[1]) != want:
            raise ValueError(
                f"pre-quantized scales are {np.ndim(x[1])}-D but "
                f"Precision(x_quant_rows={config.precision.x_quant_rows}) "
                f"expects {want}-D — quantize with ops.quant.quantize_policy "
                f"on the same Precision"
            )
    shape_x = _shape(x[0]) if isinstance(x, tuple) else _shape(x)
    shape_w, shape_h = _shape(w0), _shape(h0)
    if shape_x != (shape_w[0], shape_h[1]) or shape_w[1] != shape_h[0]:
        raise ValueError(
            f"shape mismatch: X{shape_x} vs W{shape_w} @ H{shape_h}"
        )


def solve(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    clamp_inputs: bool = True,
    initial_cost: float = float("nan"),
    device="cuda",
    initial_momentum: float = float("nan"),
    initial_extrap=None,
) -> SolveResult:
    """Factorize ``x ~= w @ h`` (the reference's ``run_async``, nmf.cu:76-116).

    ``x``, ``w0`` and ``h0`` are NumPy arrays or tensors, ``x`` also a
    pre-quantized ``(codes, scales)`` pair under ``x_dtype="int8"``; they are
    copied to ``device`` (``"cuda"`` by default; a CUDA request without a
    card raises).  The load-time prep is ``_prep_jit_cached``'s
    (``nmf_tpu/models/solver.py:688-709``): with ``clamp_inputs`` (the
    reference's ``set_epsilon``, nmf.cu:211) W and H are cast to the state
    dtype and clamped there, X is clamped in f32 and then cast to
    ``x_dtype`` or quantized; without it they are cast or quantized
    directly.  A pair passes through untouched.  The prep writes fresh
    tensors, so the caller's arrays are never modified.

    ``initial_cost`` seeds the convergence baseline of a resumed run;
    ``initial_momentum`` seeds the accelerated loop's momentum (NaN: start
    at ``config.accel_momentum``), and ``initial_extrap``, a ``(w_ex,
    h_ex)`` pair cast to the state dtype, its extrapolation carry; then the
    result's ``w_ex``/``h_ex`` hold the carry for the next segment
    (``utils.convert.accel_state_from`` reads both from a result of either
    package).
    """
    config.validate()
    check_inputs(x, w0, h0, config)
    dev = resolve_device(device)
    (m, k), n = _shape(w0), _shape(h0)[1]
    config = resolve_config(config, m, k, n, dev, "solve")
    step_fn = resolve_step_fn(config)
    cost_fn = _cost_fn(config)
    x, w0, h0 = _prep(x, w0, h0, config, clamp_inputs, dev)
    if initial_extrap is not None:
        initial_extrap = tuple(to_state(a, config, dev, clamp=False) for a in initial_extrap)
    c0 = None if np.isnan(initial_cost) else initial_cost
    return run_checked_loop(x, w0, h0, config, step_fn, cost_fn, c0,
                            float(initial_momentum), initial_extrap)


def to_state(a, config: SolveConfig, dev: torch.device, clamp: bool = True) -> torch.Tensor:
    """A factor as a row-major tensor on ``dev`` in the state dtype, clamped
    there (``max(w.astype(sd), sd(eps))``, the reference's load-time clamp)."""
    sd = _DTYPES[config.precision.state_dtype]
    a = to_tensor(a, dev).to(sd)
    if clamp:
        a = torch.maximum(a, torch.full((), float(config.eps), dtype=sd, device=dev))
    return a.contiguous()


def _prep(x, w0, h0, config: SolveConfig, clamp_inputs: bool, dev: torch.device):
    """The load-time clamp, casts and quantization, as row-major tensors on
    ``dev``."""
    prec, eps = config.precision, float(config.eps)
    w0, h0 = (to_state(a, config, dev, clamp_inputs) for a in (w0, h0))
    if isinstance(x, tuple):   # clamped when it was quantized
        return tuple(to_tensor(a, dev) for a in x), w0, h0
    x = to_tensor(x, dev).to(_F32)
    if clamp_inputs:
        x = torch.clamp_min(x, eps)
    if prec.x_dtype == "int8":
        x = quantize_policy(x, eps, prec.x_quant_rows)
        return tuple(t.contiguous() for t in x), w0, h0
    return x.to(_DTYPES[prec.x_dtype]).contiguous(), w0, h0
