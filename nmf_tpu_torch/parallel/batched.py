"""Batched NMF: many independent factorizations in one solve.

Counterpart of ``nmf_tpu.parallel.batched``, where the batched solve is
``jax.vmap`` of the single-problem ``while_loop``.  Here the loop runs once
for all members on stacked state (W ``[B, M, K]``, H ``[B, K, N]``), and
the fused kernels K1-K3 take the member axis themselves
(:mod:`nmf_tpu_torch.ops.kernels.fused_mu`): one K1 and one K2 launch an
iteration and one K3 launch a check serve every member, and member i gives
the bits of the 2-D solve of member i.

The semantics are those of the vmapped ``while_loop``: with ``thresh > 0``
each member stops changing at its own check (a finished member's W and H
are held by ``torch.where`` under a device mask while the others run on),
and ``iterations``, ``num_checks``, ``converged``, ``cost`` and
``cost_history`` come back per member; the stop test runs on the device
(the eager loop reads one scalar a check, whether any member runs on).
With ``thresh == 0`` nothing is read back, and every member runs exactly
``max_iter`` iterations.  ``accelerate`` decides acceptance per member; a
block any member rejects is redone plain for all members and kept for the
rejecting ones, as the vmapped ``lax.cond`` selects.

On the card, ``jit(vmap(run_checked_loop))``'s one program becomes CUDA
graphs over the member axis (:class:`_BatchGraph`, :class:`_BatchAccelGraph`,
on ``models/solver.py``'s ``_BlockGraph`` and ``_AccelGraph``): a call's
full check blocks after the first replay a step's graph and the close's,
where ``solver.MIN_REPLAYS`` blocks replay and B x M x N x K (the
tile-sparse batch: B x T x bm x bn x K over its padded tile count T) is
below ``solver.GRAPH_MAX_WORK``.  Under ``thresh > 0`` the blocks replay
under a CUDA IF conditional node on whether any member runs on (the
vmapped ``while_loop``'s cond), so the host reads the card once, at the
end.  Under ``accelerate`` each member's momentum, the accept test, the
grow or shrink and the kept carry stay on the device (the extrapolation
kernel takes a ``[B]`` momentum), and the redo replays under an IF node on
whether any member rejected; the host reads the card once, at the end.
The eager loop (the CPU, ``solver.eager_loop()``, below the rule) gives
the same bits; its accelerated form reads the B costs a block.

``backend="auto"`` and ``"autotune"`` resolve by the card's rule for a
member axis (:func:`nmf_tpu_torch.utils.autotune.rule_pick` with
``members``; JAX sends every batched solve to ``jnp`` on a TPU,
``batched.py:202-211``): CUDA tensors at small K take cuBLAS's batched
GEMMs, where the member-axis kernels measured slower.

**On a mesh** (``batched.py:212-228`` of the JAX package) the member axis
is split over ALL the mesh's ranks, row-major (rank (i, j) of an R x C
mesh holds members ``[(i*C + j) * B/(R*C), ...)``; a
:class:`~nmf_tpu_torch.parallel.mesh.FlatMesh` is the same split).  Each
rank copies only its members to its device and runs them through the
same loop, and the same kernels (K1-K3 over its members, the rule
resolving at its member count); members are independent, so no value
crosses ranks while they run.  **Result contract:** ``w`` and ``h`` are
this rank's members; ``iterations``, ``cost``, ``cost_history``,
``num_checks``, ``converged`` and ``momentum`` are every member's, on
every rank (gathered once at the end), so any rank can pick a member;
``gather_result(res, mesh, w_spec=(BOTH, None, None), h_spec=(BOTH,
None, None))`` gives every member's factors.  The selection solves
(:mod:`nmf_tpu_torch.models.selection`) split their members over the
mesh's first axis instead, as JAX does.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import torch

from ..models import solver
from ..models.masked import masked_kl, mu_step_masked
from ..models.solver import (
    _DTYPES,
    SolveResult,
    _cost_fn,
    _family_step,
    _use_kernels,
    extrapolate,
)
from ..ops.divergence import kl_divergence
from ..ops.kernels import fused_mu
from ..ops.mu import mu_step
from ..ops.quant import dequantize, quantize_policy
from ..utils.autotune import resolve_config
from ..utils.config import SolveConfig
from ..utils.convert import to_tensor
from ..utils.device import resolve_device
from .mesh import (
    BOTH,
    FlatMesh,
    Placement,
    axis_index,
    axis_size,
    check_mesh,
    gather,
    mesh_coordinate,
    mesh_device,
)

__all__ = ["solve_batched", "run_batched_loop", "batched_step_cost", "gather_members"]

_F32 = torch.float32


def _member(x, i: int):
    """Member i of a stacked X as the kernel wrappers take it apart (a
    tensor or a tuple of them, 2-D: shared), of a tuple whose first item
    is such a pair (each item taken apart), or of a list (one operand a
    member)."""
    if isinstance(x, list):
        return x[i]
    if isinstance(x, tuple) and isinstance(x[0], tuple):
        return tuple(_member(a, i) for a in x)
    return fused_mu._member_x(x, i)


def per_member_step(fn):
    """A 2-D step ``fn(w, h, x)`` run member by member on stacks."""

    def step(w, h, x):
        outs = [fn(w[i], h[i], _member(x, i)) for i in range(w.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    return step


def per_member_cost(fn):
    """A 2-D cost ``fn(x, w, h)`` run member by member: ``[B]`` f32."""
    return lambda x, w, h: torch.stack(
        [fn(_member(x, i), w[i], h[i]).to(_F32) for i in range(w.shape[0])])


def _dequant_members(x):
    """Stacked int8 X as f32 values, member by member (2-D codes: shared)."""
    codes, scales = x
    if codes.dim() == 2:
        return dequantize(codes, scales)
    return torch.stack([dequantize(codes[i], scales[i]) for i in range(codes.shape[0])])


def batched_step_cost(config: SolveConfig):
    """(step, cost) of a batched solve on stacked state.

    The KL MU takes the fused kernels over the member axis (their plain
    version member by member on CPU tensors) or, under ``backend="jnp"``,
    the plain ops on the whole stack (batched GEMMs), int8 X dequantized
    each step.  The beta, HALS and penalized families take their plain 2-D
    step and cost member by member, as JAX vmaps them.
    """
    eps, prec = config.eps, config.precision
    quant = prec.x_dtype == "int8"
    fam = _family_step(config)
    cost2d = _cost_fn(config)
    if fam is not None:
        if quant:
            fam = (lambda f: lambda w, h, x: f(w, h, dequantize(*x)))(fam)
        return per_member_step(fam), per_member_cost(cost2d)
    if _use_kernels(config):
        return (functools.partial(fused_mu.mu_step_fused, eps=eps, precision=prec),
                functools.partial(fused_mu.kl_cost_fused, eps=eps, precision=prec))
    step = functools.partial(mu_step, eps=eps, precision=prec)
    if quant:
        step = (lambda f: lambda w, h, x: f(w, h, _dequant_members(x)))(step)
        cost = per_member_cost(lambda x, w, h: kl_divergence(dequantize(*x), w, h, eps))
    else:
        cost = per_member_cost(lambda x, w, h: kl_divergence(x, w, h, eps))
    return step, cost


def _hold(keep: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` where a member runs on, ``old`` where it has stopped: ``keep``
    is the device's ``[B]`` mask (an all-true mask gives ``new``'s bits)."""
    return torch.where(keep.view(-1, *([1] * (new.dim() - 1))), new, old)


def _member_state(g, b: int, n_slots: int, dev: torch.device) -> None:
    """The member axis's bookkeeping on the device, as attributes of ``g``
    (a batch graph, or the eager loop's namespace): each member's cost
    ``[B]`` f32 (NaN: no baseline) and history ``[B, n_slots]`` (NaN:
    unused), written at the check index ``idx`` the members share, and
    whether each runs on (``active``), its checks and whether it stopped
    at ``thresh`` (``done``)."""
    f32 = dict(dtype=_F32, device=dev)
    g.cost = torch.empty((b,), **f32)
    g.hist = torch.empty((b, n_slots), **f32)
    g.idx = torch.empty((1,), dtype=torch.int64, device=dev)
    g.active = torch.empty((b,), dtype=torch.bool, device=dev)
    g.checks = torch.empty((b,), dtype=torch.int64, device=dev)
    g.done = torch.empty((b,), dtype=torch.bool, device=dev)
    _reset_members(g)


def _reset_members(g) -> None:
    """:func:`_member_state`'s start, in place."""
    g.cost.fill_(float("nan"))
    g.hist.fill_(float("nan"))
    g.idx.zero_()
    g.active.fill_(True)
    g.checks.zero_()
    g.done.fill_(False)


def _commit(g, sel: torch.Tensor, cost: torch.Tensor, col: torch.Tensor, thresh: float) -> None:
    """A check's close for the members ``sel`` of the bookkeeping ``g``
    (:func:`_member_state`), on the device: their new ``cost`` into the
    history at column ``col`` (a one-element int64 tensor), their check
    count ``col + 1``, and under ``thresh > 0`` their stop, the relative
    change compared in f32 as the 2-D loop compares it (NaN, a first
    check, never stops).  The others keep every value.  ``sel`` may be
    ``g.active`` itself: it is read before the stop writes it."""
    new = _hold(sel, cost, g.cost)
    g.hist.index_copy_(1, col, _hold(sel, new[:, None], g.hist.index_select(1, col)))
    g.checks.copy_(torch.where(sel, col + 1, g.checks))
    if thresh > 0.0:
        stop = (torch.abs(g.cost - new) / torch.abs(new) < thresh) & sel
        g.done.logical_or_(stop)
        g.active.logical_and_(~stop)
    g.cost.copy_(new)


def member_close(g, x, w, h, w0, h0, cost_fn, need_cost: bool, thresh: float):
    """A check block's close over the member axis on device tensors alone,
    the body of the vmapped ``while_loop`` after its steps: under ``thresh
    > 0`` the members that stopped keep their block-start state ``(w0,
    h0)`` (the vmapped select); with ``need_cost`` the running members'
    costs, history, checks and stops (:func:`_commit`).  Nothing is read
    back to the host: the eager loop runs it, and the captured loop as its
    close's graph.  Returns ``(w, h)``."""
    if thresh > 0.0:
        w, h = _hold(g.active, w, w0), _hold(g.active, h, h0)
    if need_cost:
        _commit(g, g.active, cost_fn(x, w, h).to(_F32), g.idx, thresh)
        g.idx.add_(1)
    return w, h


def _member_result(w, h, g, it: int, check_every: int, checked: bool, momentum,
                   copy: bool = False, read=None) -> SolveResult:
    """The result from the device bookkeeping ``g`` after ``it`` iterations
    of a loop that ran ``it // check_every`` full blocks or a ragged tail:
    where every block ``checked``, a member that stopped at check c ran
    ``min(c * check_every, it)`` iterations; else every member ran ``it``.
    ``read`` is the host's read of each member's checks and stop (None:
    under ``thresh == 0`` the host knows them, every member running every
    check).  ``copy`` (``g`` a graph's): nothing returned aliases its
    buffers."""
    b = g.checks.shape[0]
    if read is None:
        blocks = -(-it // check_every) if checked else 0
        checks, done = np.full(b, blocks, np.int64), np.zeros(b, bool)
    else:
        checks, done = np.asarray(read[:b], np.int64), np.asarray(read[b:2 * b], bool)
    iters = np.minimum(checks * check_every, it) if checked else np.full(b, it, np.int64)
    if copy:
        w, h = w.clone(), h.clone()
    return _result(w, h, iters, g.cost.clone() if copy else g.cost,
                   g.hist.clone() if copy else g.hist, checks, done, momentum)


def _member_read(g, *more) -> list:
    """The host's one read of each member's checks and stop (and
    ``more``)."""
    return solver._host_read(torch.cat((g.checks, g.done.long(), *more)))


def _graphed(w: torch.Tensor, h: torch.Tensor, n_full: int, work=None) -> bool:
    """Whether a batched loop replays graphs: more than ``MIN_REPLAYS``
    full blocks and the run's rule for a step's ``work``, which on a member
    axis is B x M x N x K where not given (``solver._graph_rule``)."""
    if work is None:
        b, m, k = w.shape
        work = b * m * k * h.shape[-1]
    return n_full > solver.MIN_REPLAYS and solver._graph_rule(w.device, work)


class _BatchGraph(solver._BlockGraph):
    """The batched loop's full check blocks over static state, the
    counterpart of ``jit(vmap(run_checked_loop))``: ``_BlockGraph``'s step
    (the stacked step, ``chunk`` replays) and a close of
    :func:`member_close` on the graph's own buffers: W and H, the
    block-start stacks ``w0``/``h0`` (under ``thresh > 0``) and the member
    bookkeeping (:func:`_member_state`).  Under ``thresh > 0`` the loop
    stops on the device, as the vmapped ``while_loop``'s cond: the close
    sets ``running`` to whether any member runs on, and the blocks replay
    under an IF node on it; the host reads the card once, at the end."""

    def __init__(self, x, w, h, n_slots: int, step_fn, cost_fn, chunk: int, need_cost: bool,
                 thresh: float):
        super().__init__(x, w, h, n_slots, step_fn, cost_fn, chunk, need_cost, own_x=False,
                         stop=thresh)
        _member_state(self, w.shape[0], n_slots, w.device)
        self.starts = (torch.empty_like(w), torch.empty_like(h)) if thresh > 0.0 else ()

    def state(self):
        return (self.w, self.h, *self.starts, self.cost, self.hist, self.idx, self.active,
                self.checks, self.done, self.running)

    def load(self, x, w, h) -> None:
        self.x = x
        for buf, t in zip((self.w, self.h) + self.starts, (w, h, w, h)):
            buf.copy_(t)
        _reset_members(self)
        self._new_call()

    def _close(self) -> None:
        w, h = member_close(self, self.x, self.w, self.h, *(self.starts or (None, None)),
                            self.cost_fn, self.need_cost, self.stop)
        for buf, t in zip(self.starts, (w, h)):
            buf.copy_(t)
        for buf, t in zip((self.w, self.h), (w, h)):
            if t is not buf:
                buf.copy_(t)
        if self.stop:
            self.running.copy_(self.active.any())

    def end(self, max_iter: int):
        """The call's one read of the device (each member's checks and
        stop), its replays settled: (the loop's iterations, the read)."""
        read = _member_read(self)
        checks = max(read[:self.checks.shape[0]])   # the last block ran for a running member
        its = min(checks * self.chunk, max_iter)
        self._settle("block", checks, its)
        return its, read


def run_batched_loop(x, w, h, config: SolveConfig, step_fn, cost_fn,
                     work=None) -> SolveResult:
    """The check-blocked loop over a member axis: ``jax.vmap`` of
    ``run_checked_loop`` (module docstring).  ``step_fn`` and ``cost_fn``
    take and give stacks (the cost ``[B]`` f32).  On the card, where
    :func:`_graphed` allows it (a step's ``work``: None for B x M x N x K),
    the full blocks after the first replay CUDA graphs
    (:class:`_BatchGraph`; under ``accelerate`` :class:`_BatchAccelGraph`)."""
    if config.accelerate:
        return _run_batched_accel(x, w, h, config, step_fn, cost_fn, work)
    b, dev = w.shape[0], w.device
    max_iter, check_every = int(config.max_iter), int(config.check_every)
    thresh = float(config.thresh)
    need_cost = config.track_cost or thresh > 0.0
    n_slots = max(config.num_checks, 1)
    nan = torch.full((b,), float("nan"), dtype=_F32, device=dev)
    runner = None
    if _graphed(w, h, max_iter // check_every, work):
        runner = g = _BatchGraph(x, w, h, n_slots, step_fn, cost_fn, check_every, need_cost,
                                 thresh)
        runner.load(x, w, h)
        if thresh > 0.0:
            solver._enqueue_blocks(runner, max_iter, check_every, stop=True)
            its, read = runner.end(max_iter)
            return _member_result(runner.w, runner.h, runner, its, check_every, True, nan,
                                  copy=True, read=read)
    else:
        g = types.SimpleNamespace()
        _member_state(g, b, n_slots, dev)
    it, running = 0, True
    while it < max_iter and running:
        chunk = min(check_every, max_iter - it)
        if runner is not None and chunk == check_every:
            runner.block(chunk)
            w, h = runner.w, runner.h
        else:
            w0, h0 = w, h
            for _ in range(chunk):
                w, h = step_fn(w, h, x)
            w, h = member_close(g, x, w, h, w0, h0, cost_fn, need_cost, thresh)
        it += chunk
        if thresh > 0.0:
            # the eager loop's one host read a check: whether any member runs on
            running = bool(solver._host_read(g.active.any()))
    read = _member_read(g) if thresh > 0.0 else None
    return _member_result(w, h, g, it, check_every, need_cost, nan, copy=runner is not None,
                          read=read)


class _BatchAccelGraph(solver._AccelGraph):
    """The accelerated batched loop's check blocks over static state,
    ``_AccelGraph``'s parts over a member axis: each member's momentum in
    ``m`` ``[B]`` (one launch of the extrapolation kernel for both factors
    of all members), the bookkeeping of :func:`_member_state`, and the
    block-start carry ``we0``/``he0`` for the members that stopped.

    * ``"accel"``: the accelerated steps, then :meth:`_accel_close`: the
      costs, the accept test ``c <= cost`` per running member (NaN
      rejects), the accepting members' momentum grown and their check
      closed; a rejecting member's W and H back to the block start, a
      stopped member's whole state held; ``reject`` set where any running
      member rejected, ``running`` where any member runs on;
    * ``"redo"`` under an IF node on ``reject``: the plain step from there
      for all members, kept for the rejecting ones (the vmapped
      ``lax.cond``'s select), and :meth:`_redo_close`: their costs,
      closes, momentum shrunk and carry restarted at the redo's iterate.

    The host reads nothing until the call ends.  The values are
    :func:`_run_batched_accel`'s eager loop's, bit for bit."""

    def __init__(self, x, w, h, n_slots: int, step_fn, cost_fn, chunk: int,
                 config: SolveConfig):
        super().__init__(x, w, h, n_slots, step_fn, cost_fn, chunk, config, own_x=False)
        b, dev = w.shape[0], w.device
        _member_state(self, b, n_slots, dev)
        self.we0, self.he0 = torch.empty_like(w), torch.empty_like(h)
        self.m = torch.empty((b,), dtype=_F32, device=dev)
        self.rej = torch.empty((b,), dtype=torch.bool, device=dev)

    def state(self):
        return (self.w, self.h, self.we, self.he, self.w0, self.h0, self.we0, self.he0, self.m,
                self.rej, self.reject, self.running, self.redos, self.redo_add, self.cost,
                self.hist, self.idx, self.active, self.checks, self.done)

    def load(self, x, w, h, m0: float) -> None:
        """A call's X and start: W and H into every stack, the seed costs
        taken on the device, each member's momentum ``m0``."""
        self.x = x
        for bufs, t in (((self.w, self.we, self.w0, self.we0), w),
                        ((self.h, self.he, self.h0, self.he0), h)):
            for buf in bufs:
                buf.copy_(t)
        _reset_members(self)
        self.cost.copy_(self.cost_fn(self.x, self.w, self.h).to(_F32))
        self.m.fill_(m0)
        self._new_call()

    def _accel_close(self) -> None:
        c1 = self.cost_fn(self.x, self.w, self.h).to(_F32)
        run = self.active.clone()            # the members running this block
        accept = c1 <= self.cost             # false for NaN
        ok, rej = accept & run, ~accept & run
        self.rej.copy_(rej)
        self.reject.copy_(rej.any())
        self.m.copy_(torch.where(ok, torch.minimum(self.m * self.grow, self.m_max), self.m))
        _commit(self, ok, c1, self.idx, self.stop)
        self.idx.add_(1)
        for t, t0, ex, ex0 in ((self.w, self.w0, self.we, self.we0),
                               (self.h, self.h0, self.he, self.he0)):
            t.copy_(_hold(ok, t, t0))
            t0.copy_(t)
            ex.copy_(_hold(run, ex, ex0))
            ex0.copy_(ex)
        self.running.copy_(self.active.any())

    def _redo_close(self) -> None:
        c2 = self.cost_fn(self.x, self.w, self.h).to(_F32)
        rej = self.rej
        self.m.copy_(torch.where(rej, self.m * self.shrink, self.m))
        _commit(self, rej, c2, self.idx - 1, self.stop)
        for t, t0, ex, ex0 in ((self.w, self.w0, self.we, self.we0),
                               (self.h, self.h0, self.he, self.he0)):
            t.copy_(_hold(rej, t, t0))
            t0.copy_(t)
            ex.copy_(_hold(rej, t, ex))
            ex0.copy_(ex)
        self.running.copy_(self.active.any())
        self.redos.add_(self.redo_add)
        self.reject.fill_(False)

    def end(self, max_iter: int):
        """The call's one read of the device (each member's checks and
        stop, the redos), its replays settled: (the loop's iterations,
        the read)."""
        read = _member_read(self, self.redos)
        b = self.checks.shape[0]
        checks, (redos, redo_steps) = max(read[:b]), read[2 * b:]
        its = min(checks * self.chunk, max_iter)
        if self.stop:
            self._settle("accel", checks, its)
        self._launched("redo", redo_steps, redos)
        solver.ACCEL_COUNTS["redo_replays"] += redos
        return its, read


def _run_batched_accel_graphed(runner: _BatchAccelGraph, x, w, h,
                               config: SolveConfig) -> SolveResult:
    """:func:`_run_batched_accel` on the card through a
    :class:`_BatchAccelGraph`: the same start, decisions and bits, the
    blocks enqueued with no read of the card (the stop's under
    ``thresh > 0``), and one read at the end.  Nothing returned aliases a
    buffer of the runner."""
    max_iter, check_every = int(config.max_iter), int(config.check_every)
    runner.load(x, w, h, float(np.float32(config.accel_momentum)))
    solver._enqueue_blocks(runner, max_iter, check_every, stop=config.thresh > 0.0)
    its, read = runner.end(max_iter)
    return _member_result(runner.w, runner.h, runner, its, check_every, True, runner.m.clone(),
                          copy=True, read=read)


def _extrapolate_members(new, old, m: np.ndarray, eps: float) -> torch.Tensor:
    """:func:`extrapolate` with member i's momentum ``m[i]``: one pass a
    distinct momentum, each member taking its own, so every member has the
    bits of the 2-D extrapolation (the eager loop's; the graphed loop
    launches the extrapolation kernel once for all members)."""
    vals = np.unique(m)
    out = extrapolate(new, old, float(vals[0]), eps)
    for v in vals[1:]:
        sel = torch.from_numpy(m == v).to(new.device)
        out = _hold(sel, extrapolate(new, old, float(v), eps), out)
    return out


def _result(w, h, iters, cost, hist, checks, done, momentum) -> SolveResult:
    return SolveResult(
        w=w,
        h=h,
        iterations=torch.from_numpy(iters.astype(np.int32)),
        cost=cost,
        cost_history=hist,
        num_checks=torch.from_numpy(checks.astype(np.int32)),
        converged=torch.from_numpy(done.copy()),
        momentum=momentum,
    )


def _run_batched_accel(x, w, h, config: SolveConfig, step_fn, cost_fn,
                       work=None) -> SolveResult:
    """``_run_accel_loop`` over a member axis: per-member momentum, costs
    and accept/reject.  On the card, by :func:`_graphed`, through a
    :class:`_BatchAccelGraph`; else this eager loop, the graphed loop's
    reference, decides on the host from one read of the B costs a check
    block (two when a member rejects)."""
    b, dev = w.shape[0], w.device
    max_iter, check_every = int(config.max_iter), int(config.check_every)
    if _graphed(w, h, max_iter // check_every, work):
        runner = _BatchAccelGraph(x, w, h, max(config.num_checks, 1), step_fn, cost_fn,
                                  check_every, config)
        return _run_batched_accel_graphed(runner, x, w, h, config)
    thresh = np.float32(config.thresh)
    eps = config.eps
    m = np.full(b, np.float32(config.accel_momentum), np.float32)
    m_max = np.float32(config.accel_momentum_max)
    grow, shrink = np.float32(config.accel_grow), np.float32(config.accel_shrink)

    def costs(w_, h_):
        return cost_fn(x, w_, h_).to(_F32).cpu().numpy()

    cost = costs(w, h)
    we, he = w, h
    hist = np.full((b, max(config.num_checks, 1)), np.nan, np.float32)
    active = np.ones(b, bool)
    iters, checks, done = np.zeros(b, np.int64), np.zeros(b, np.int64), np.zeros(b, bool)
    it = chk = 0
    while it < max_iter and active.any():
        chunk = min(check_every, max_iter - it)
        w0, h0, we0, he0 = w, h, we, he
        for _ in range(chunk):
            wn, hn = step_fn(we, he, x)
            we, he = _extrapolate_members(wn, w, m, eps), _extrapolate_members(hn, h, m, eps)
            w, h = wn, hn
        c = costs(w, h)
        with np.errstate(invalid="ignore"):
            accept = c <= cost          # NaN rejects
        reject = ~accept & active
        if reject.any():                # redo the block plain; keep it where rejected
            solver.ACCEL_COUNTS["redo_eager"] += 1
            w2, h2 = w0, h0
            for _ in range(chunk):
                w2, h2 = step_fn(w2, h2, x)
            c2 = costs(w2, h2)
            rj = torch.from_numpy(reject).to(dev)
            w, h = _hold(rj, w2, w), _hold(rj, h2, h)
            we, he = _hold(rj, w2, we), _hold(rj, h2, he)
            c = np.where(reject, c2, c)
        m_new = np.where(accept, np.minimum((m * grow).astype(np.float32), m_max),
                         (m * shrink).astype(np.float32)).astype(np.float32)
        if not active.all():
            keep = torch.from_numpy(active).to(dev)
            w, h = _hold(keep, w, w0), _hold(keep, h, h0)
            we, he = _hold(keep, we, we0), _hold(keep, he, he0)
        m = np.where(active, m_new, m).astype(np.float32)
        it += chunk
        prev = cost
        cost = np.where(active, c, cost).astype(np.float32)
        hist[active, chk] = cost[active]
        chk += 1
        iters[active], checks[active] = it, chk
        if thresh > 0:
            with np.errstate(divide="ignore", invalid="ignore"):
                stop = (np.abs(prev - cost) / np.abs(cost) < thresh) & active
            done |= stop
            active &= ~stop
    return _result(w, h, iters, torch.from_numpy(cost).to(dev), torch.from_numpy(hist).to(dev),
                   checks, done, torch.from_numpy(m).to(dev))


def _shape(a):
    return tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))


def member_split(mesh, axes, b: int):
    """This rank's span of ``b`` members split along ``axes`` of ``mesh``."""
    size = axis_size(mesh, axes)
    i, per = axis_index(mesh, axes), b // size
    return slice(i * per, (i + 1) * per)


def gather_members(res: SolveResult, mesh, axes, factors: bool = False) -> SolveResult:
    """``res`` (this rank's members, split along ``axes``) with every
    member's scalars on every rank, and with ``factors`` every member's W
    and H too: a zero-padded sum over the axes, exact."""
    dev = mesh_device(mesh)

    def full(t):
        if t is None:
            return None
        spec = (axes,) + (None,) * (t.dim() - 1)
        dt, home = t.dtype, t.device
        v = t.to(dev).to(torch.int32) if dt == torch.bool else t.to(dev)
        return gather(v.contiguous(), Placement(mesh, spec)).to(dt).to(home)

    names = ["iterations", "cost", "cost_history", "num_checks", "converged", "momentum"]
    if factors:
        names += ["w", "h", "w_ex", "h_ex"]
    return dataclasses.replace(res, **{f: full(getattr(res, f)) for f in names})


def _prep_members(x, w0, h0, config: SolveConfig, clamp_inputs: bool, mask, dev):
    """``_batched_prep_jit_cached`` (``nmf_tpu/parallel/batched.py:47-76``):
    clamp and casts, the unobserved entries zeroed, and int8 X quantized
    member by member (codes ``[B, M, N]``, scales ``[B, N]``, or
    ``[B, R, N]`` per row block)."""
    prec, eps = config.precision, float(config.eps)
    sd = _DTYPES[prec.state_dtype]
    fill = torch.full((), eps, dtype=sd, device=dev)
    w0, h0 = (to_tensor(a, dev).to(sd) for a in (w0, h0))
    x = to_tensor(x, dev).to(_F32)
    if clamp_inputs:
        w0, h0 = torch.maximum(w0, fill), torch.maximum(h0, fill)
        x = torch.clamp_min(x, eps)
    if mask is not None:
        # unobserved entries may hold anything (NaN/Inf holes): zeroed for
        # every storage dtype, before the scales see them
        mask = to_tensor(mask, dev).to(_F32).contiguous()
        x = torch.where(mask > 0, x, 0.0)
    if prec.x_dtype == "int8":
        pairs = [quantize_policy(x[i], eps, prec.x_quant_rows) for i in range(x.shape[0])]
        x = tuple(torch.stack([p[j] for p in pairs]).contiguous() for j in range(2))
    else:
        x = x.to(_DTYPES[prec.x_dtype]).contiguous()
    return x, w0.contiguous(), h0.contiguous(), mask


def solve_batched(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    mesh=None,
    clamp_inputs: bool = True,
    mask=None,
    device="cuda",
) -> SolveResult:
    """Solve a batch: x ``[B, M, N]``, w0 ``[B, M, K]``, h0 ``[B, K, N]``
    -> a :class:`SolveResult` with the member axis first
    (``nmf_tpu/parallel/batched.py:121-230``).

    ``mask`` (``[B, M, N]``) runs the masked KL MU per member on plain ops,
    each member seeing only its own ``mask != 0`` entries (unobserved X may
    be NaN or Inf).  ``live_metrics`` is turned off, as in JAX.  The inputs
    go to ``device`` (``"cuda"`` by default; a CUDA request without a card
    raises), or with ``mesh`` (a ``DeviceMesh`` or ``FlatMesh``) to the
    mesh's devices, each rank its members (module docstring).  Per-member
    convergence: module docstring.
    """
    config.validate()
    if config.live_metrics:
        # a per-member-per-check stream is noise (nmf_tpu batched.py:80-86)
        config = dataclasses.replace(config, live_metrics=False)
    if isinstance(x, tuple):
        raise ValueError(
            "solve_batched takes the dense [B, M, N] stack and quantizes "
            "each member internally (codes [B,M,N] + per-member scales); "
            "pre-quantized (codes, scales) pairs are accepted by "
            "solve/solve_sharded/solve_h_only"
        )
    if mask is not None and (config.beta != 1.0 or config.algorithm != "mu"):
        raise NotImplementedError("masked solve implements the KL (beta=1) MU family")
    sx, sw, sh = _shape(x), _shape(w0), _shape(h0)
    if len(sx) != 3 or len(sw) != 3 or len(sh) != 3:
        raise ValueError("solve_batched expects 3-D [batch, rows, cols] arrays")
    if not (sx[0] == sw[0] == sh[0]):
        raise ValueError(f"batch sizes disagree: X{sx[0]} W{sw[0]} H{sh[0]}")
    if sx[1:] != (sw[1], sh[2]) or sw[2] != sh[1]:
        raise ValueError(f"shape mismatch: X{sx} vs W{sw} @ H{sh}")
    if mask is not None and _shape(mask) != sx:
        raise ValueError(f"mask shape {_shape(mask)} != X shape {sx}")
    b = sw[0]
    if mesh is not None:
        mesh = mesh.mesh if isinstance(mesh, FlatMesh) else check_mesh(mesh)
        n_dev = axis_size(mesh, BOTH)
        if b % n_dev:
            raise ValueError(
                f"batch {b} must divide the mesh's {n_dev} devices "
                f"(the batch axis shards over ALL mesh axes)"
            )
        if mesh_coordinate(mesh) is None:
            return None
        # this rank's members only reach its device
        span = member_split(mesh, BOTH, b)
        x, w0, h0 = x[span], w0[span], h0[span]
        mask = None if mask is None else mask[span]
        b, dev = b // n_dev, mesh_device(mesh)
    else:
        dev = resolve_device(device)
    res = _solve_members(x, w0, h0, config, clamp_inputs, mask, dev, b)
    return res if mesh is None else gather_members(res, mesh, BOTH)


def _solve_members(x, w0, h0, config: SolveConfig, clamp_inputs: bool, mask, dev, b: int):
    """The batched solve of ``b`` members on ``dev`` (checks done)."""
    sw, sh = _shape(w0), _shape(h0)
    if mask is None:
        config = resolve_config(config, sw[1], sw[2], sh[2], dev, "batched", members=b)
    x, w0, h0, mask = _prep_members(x, w0, h0, config, clamp_inputs, mask, dev)
    if mask is not None:
        eps, prec = config.eps, config.precision
        pens = dict(l1_w=config.l1_w, l1_h=config.l1_h, l2_w=config.l2_w, l2_h=config.l2_h)
        dense = (lambda a: dequantize(*a)) if isinstance(x, tuple) else (lambda a: a)
        step = per_member_step(
            lambda w, h, xm: mu_step_masked(w, h, dense(xm[0]), xm[1], eps, prec, **pens))
        cost = per_member_cost(
            lambda xm, w, h: masked_kl(dense(xm[0]), w, h, xm[1], eps, **pens))
        return run_batched_loop((x, mask), w0, h0, config, step, cost)
    step, cost = batched_step_cost(config)
    return run_batched_loop(x, w0, h0, config, step, cost)
