"""Mesh-sharded NMF solves: one process a rank, K-sized all-reduces.

Counterpart of ``nmf_tpu.parallel.sharded``.  JAX runs the whole solve
inside one ``shard_map`` and sums with ``lax.psum``; here every rank runs
the eager loop of :func:`~nmf_tpu_torch.models.solver.run_checked_loop`
on its own blocks (layout: :mod:`nmf_tpu_torch.parallel.mesh`) and sums
with ``torch.distributed.all_reduce`` over the mesh's row or column
process group (:func:`~nmf_tpu_torch.parallel.mesh.psum`).  Per KL
iteration only K-sized values cross ranks::

    W^T Z numerator -> sum over 'mr'   (K x N/c)     colsum(W) -> 'mr' (K)
    Z H^T numerator -> sum over 'mc'   (M/r x K)     rowsum(H) -> 'mc' (K)
    cost partial    -> sum over both   (1 value, each check)

Every clamp comes after its sum, as on one device.  On the card the KL
numerators are the kernels K1 and K2 in ``numerator_only`` mode on the
rank's block (``backend="pallas"``, or ``"auto"`` where
:func:`~nmf_tpu_torch.utils.autotune.rule_pick` keeps the kernels for the
LOCAL shape); CPU tensors and ``backend="jnp"`` take the plain numerators.
The other families (beta, penalized, HALS, masked) take plain ops on
every device, as in JAX.  int8 X is dequantized block-locally into the
plain ops (``backend="pallas"`` with int8 X raises, as in JAX).

Uniform loops: the cost partial is summed over the mesh before the loop's
one host read a check, so the stop, the accelerated loop's accept or
reject and ``num_checks`` are the same decision on every rank, and no rank
waits in a collective the others skipped.  With ``live_metrics`` only the
rank at mesh coordinate (0, 0) emits: one line a check, not one a rank.

**Result contract.**  Inputs are global arrays (NumPy or tensors, the
same on every rank); each rank cuts and preps its blocks on its device
(int8 X is quantized whole on the host first, a column's scale reading
all its rows, and then cut, so a device holds only its block of X).
A solve returns this rank's blocks: ``res.w`` is its (M/r, K) rows of W,
``res.h`` its (K, N/c) columns of H; ``iterations``, ``cost``,
``cost_history``, ``num_checks``, ``converged`` and ``momentum`` are the
same on every rank.  :func:`gather_result` puts the global W and H on
every rank.  A rank beyond the mesh's ``R * C`` takes no part and gets
None.  The collectives run on the state's stream under NCCL; gloo (the
CPU, or several ranks sharing one card) stages CUDA tensors through the
host and so waits for each sum on the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..models.masked import _masked_prep
from ..models.solver import SolveResult, _prep, _shape, check_inputs, run_checked_loop, to_state
from ..ops import mu
from ..ops.divergence import beta_partial, kl_divergence
from ..ops.elementwise import eps_clamp
from ..ops.hals import cd_sweep_h, cd_sweep_w
from ..ops.kernels import fused_mu
from ..ops.mu import matmul
from ..ops.quant import dequantize_rows, quantize_policy_np
from ..utils.config import Precision, SolveConfig
from ..utils.convert import to_tensor
from ..utils.metrics import emit_live
from .mesh import (
    BOTH,
    COL_AXIS,
    ROW_AXIS,
    Placement,
    axis_size,
    check_mesh,
    factor_shapes,
    gather,
    local_block,
    make_mesh,
    mesh_coordinate,
    mesh_device,
    nmf_shardings,
    psum,
    shard_problem,
)

__all__ = [
    "update_h_sharded",
    "update_h_sharded_beta",
    "update_h_sharded_reg",
    "update_h_sharded_masked",
    "hals_update_h_sharded",
    "update_w_sharded",
    "mu_step_sharded",
    "mu_step_sharded_reg",
    "mu_step_sharded_masked",
    "mu_step_sharded_beta",
    "hals_step_sharded",
    "kl_partial",
    "beta_partial",
    "reg_cost_partial",
    "masked_kl_partial",
    "solve_sharded",
    "solve_h_only_sharded",
    "solve_semi_sharded",
    "gather_result",
    "build_sharded_solver",
    "build_sharded_masked_solver",
    "build_sharded_h_solver",
    "build_sharded_semi_solver",
    "build_sharded_masked_h_solver",
]

_F32 = torch.float32


def _use_fused(config: SolveConfig, local_m: int, k: int, local_n: int, device: torch.device,
               quant: bool = False, entry: str = "sharded") -> bool:
    """Whether the KL step takes K1/K2 ``numerator_only`` on the rank's
    block (``sharded.py:55-96`` of the JAX package, with the port's rule).

    ``"pallas"`` takes the kernels (which run their plain version on CPU
    tensors); ``"jnp"`` and CPU tensors the plain numerators; ``"auto"``
    and ``"autotune"`` on the card the H100 rule at the LOCAL shape
    (:func:`~nmf_tpu_torch.utils.autotune.rule_pick`, counted in
    ``autotune.CHOICES[(entry, choice)]``; the mesh never measures, as in
    JAX).  int8 X is dequantized block-locally into the plain step, so
    ``"pallas"`` with int8 X raises."""
    if quant:
        if config.backend == "pallas":
            raise NotImplementedError(
                "backend='pallas' with int8 X is not supported on a mesh: the "
                "mesh int8 path dequantizes block-locally into the plain step "
                "(as the JAX package's does) - use backend='auto'"
            )
        return False
    if config.backend == "pallas":
        return True
    if config.backend == "jnp" or device.type != "cuda":
        return False
    from ..utils import autotune

    prec = config.precision
    choice = autotune.rule_pick(local_m, k, local_n, prec.matmul_dtype, prec.x_dtype,
                                prec.state_dtype)
    autotune.CHOICES[(entry, choice)] += 1
    return choice == "pallas"


def _emit_live_origin(mesh):
    """The live emitter of a mesh solve: :func:`emit_live` on the rank at
    coordinate (0, 0), nothing elsewhere (``sharded.py:99-112`` of JAX)."""
    origin = mesh_coordinate(mesh) == (0, 0)

    def emit(it, cost, rel):
        if origin:
            emit_live(it, cost, rel)

    return emit


def _loop_kw(mesh) -> dict:
    """The mesh arguments of :func:`run_checked_loop`: the cost summed
    over both axes, the live line from the origin."""
    return dict(all_reduce=lambda c: psum(c, mesh, BOTH), live_emit=_emit_live_origin(mesh))


def _dequant_local(xx, mesh):
    """Dequantize this rank's ``(codes, scales)`` block: 1-D scales are the
    block's columns; a 2-D table holds every block row, and the rank's rows
    start at global row ``coord_r * m_loc`` of ``m_loc * r``
    (``sharded.py:138-152`` of JAX; ``ops.quant.dequantize_rows``)."""
    q, s = xx
    m_loc = q.shape[0]
    r = axis_size(mesh, ROW_AXIS)
    off = mesh_coordinate(mesh)[0] * m_loc if s.dim() == 2 else 0
    return dequantize_rows(q, s, off, m_loc * r)


def _dq_local_or_id(quant: bool, mesh):
    """Identity for dense X, block-local dequantization for a pair."""
    if quant:
        return lambda xx: _dequant_local(xx, mesh)
    return lambda xx: xx


def _wrap_dequant_local(step_fn, cost_fn, mesh):
    """A (step, cost) pair on dense X as one on the rank's ``(codes,
    scales)`` block."""
    return (
        lambda w, h, x: step_fn(w, h, _dequant_local(x, mesh)),
        lambda x, w, h: cost_fn(_dequant_local(x, mesh), w, h),
    )


def update_h_sharded(w, h, x, eps: float, precision: Precision, fused: bool = False, *, mesh):
    """H half-update on this rank's blocks (w: M/r x K, h: K x N/c, x:
    M/r x N/c): the numerator and colsum(W) summed over 'mr', clamped after
    the sum (nmf.cu:118-146).  ``fused``: the numerator is K1's
    ``numerator_only`` mode."""
    if fused:
        numer = fused_mu.update_h_fused(w, h, x, eps, precision, numerator_only=True)
    else:
        numer = mu.numerator_h(w, h, x, eps, precision)                   # (K, N/c)
    psum(numer, mesh, ROW_AXIS)
    sum_w = eps_clamp(psum(torch.sum(w, dim=0, dtype=_F32), mesh, ROW_AXIS), eps)
    return (h * (numer / sum_w[:, None])).to(h.dtype)


def update_w_sharded(w, h, x, eps: float, precision: Precision, fused: bool = False, *, mesh):
    """W half-update on this rank's blocks; the sums ride 'mc'.  ``fused``:
    K2's ``numerator_only`` mode."""
    if fused:
        numer = fused_mu.update_w_fused(w, h, x, eps, precision, numerator_only=True)
    else:
        numer = mu.numerator_w(w, h, x, eps, precision)                   # (M/r, K)
    psum(numer, mesh, COL_AXIS)
    sum_h = eps_clamp(psum(torch.sum(h, dim=1, dtype=_F32), mesh, COL_AXIS), eps)
    return (w * (numer / sum_h[None, :])).to(w.dtype)


def mu_step_sharded(w, h, x, eps, precision, fused=False, *, mesh):
    """One sharded KL MU iteration: four all-reduces (two K-sized sums a
    half)."""
    h = update_h_sharded(w, h, x, eps, precision, fused, mesh=mesh)
    w = update_w_sharded(w, h, x, eps, precision, fused, mesh=mesh)
    return w, h


def update_h_sharded_beta(w, h, x, beta, eps, precision, *, mesh):
    """H half of the sharded beta-MU step: numerator and denominator are
    both GEMMs summed over 'mr'."""
    num, den = mu._beta_ratios(w, h, x, beta, eps, precision)
    h_num = psum(matmul(w, num, precision, transpose_a=True), mesh, ROW_AXIS)
    h_den = eps_clamp(psum(matmul(w, den, precision, transpose_a=True), mesh, ROW_AXIS), eps)
    return (h * (h_num / h_den)).to(h.dtype)


def update_h_sharded_reg(w, h, x, eps, precision, l1_h=0.0, l2_h=0.0, *, mesh):
    """H half of the sharded penalized KL step: the penalty gradient reads
    only the local H block; the sums are the plain KL's."""
    numer = psum(mu.numerator_h(w, h, x, eps, precision), mesh, ROW_AXIS)
    sum_w = eps_clamp(psum(torch.sum(w, dim=0, dtype=_F32), mesh, ROW_AXIS), eps)
    denom = sum_w[:, None] + l1_h + l2_h * h.to(_F32)
    return (h * (numer / denom)).to(h.dtype)


def update_h_sharded_masked(w, h, x, mask, eps, precision, l1_h=0.0, l2_h=0.0, *, mesh):
    """H half of the sharded masked KL step: numerator and mask-GEMM
    denominator summed over 'mr', clamped after the sum; the penalties join
    after the clamp."""
    z = mask * (x / eps_clamp(matmul(w, h, precision), eps))
    numer = psum(matmul(w, z, precision, transpose_a=True), mesh, ROW_AXIS)
    denom = eps_clamp(psum(matmul(w, mask, precision, transpose_a=True), mesh, ROW_AXIS),
                      eps) + l1_h + l2_h * h.to(_F32)
    return (h * (numer / denom)).to(h.dtype)


def hals_update_h_sharded(w, h, x, eps, precision, *, mesh):
    """H half of the sharded HALS iteration: W^T X and W^T W summed over
    'mr', then the local column sweep with no communication."""
    wtx = psum(matmul(w, x, precision, transpose_a=True), mesh, ROW_AXIS)
    wtw = psum(matmul(w, w, precision, transpose_a=True), mesh, ROW_AXIS)
    return cd_sweep_h(h, wtx, wtw, eps)


def mu_step_sharded_beta(w, h, x, beta, eps, precision, *, mesh):
    """Sharded beta-divergence MU step (beta = 1 takes mu_step_sharded)."""
    h = update_h_sharded_beta(w, h, x, beta, eps, precision, mesh=mesh)
    num, den = mu._beta_ratios(w, h, x, beta, eps, precision)
    w_num = psum(matmul(num, h, precision, transpose_b=True), mesh, COL_AXIS)
    w_den = eps_clamp(psum(matmul(den, h, precision, transpose_b=True), mesh, COL_AXIS), eps)
    return (w * (w_num / w_den)).to(w.dtype), h


def hals_step_sharded(w, h, x, eps, precision, *, mesh):
    """Sharded HALS iteration: the Gram and cross products summed (W^T X,
    W^T W over 'mr'; X H^T, H H^T over 'mc'), the sweeps local; W's sweep
    reads the swept H, as on one device."""
    h = hals_update_h_sharded(w, h, x, eps, precision, mesh=mesh)
    xht = psum(matmul(x, h, precision, transpose_b=True), mesh, COL_AXIS)
    hht = psum(matmul(h, h, precision, transpose_b=True), mesh, COL_AXIS)
    return cd_sweep_w(w, xht, hht, eps), h


def mu_step_sharded_reg(w, h, x, eps, precision, l1_w=0.0, l1_h=0.0, l2_w=0.0, l2_h=0.0, *,
                        mesh):
    """Sharded L1/L2-penalized KL MU step: the plain KL step's sums, the
    penalty gradients local."""
    h = update_h_sharded_reg(w, h, x, eps, precision, l1_h, l2_h, mesh=mesh)
    numer = psum(mu.numerator_w(w, h, x, eps, precision), mesh, COL_AXIS)
    sum_h = eps_clamp(psum(torch.sum(h, dim=1, dtype=_F32), mesh, COL_AXIS), eps)
    denom = sum_h[None, :] + l1_w + l2_w * w.to(_F32)
    return (w * (numer / denom)).to(w.dtype), h


def mu_step_sharded_masked(w, h, x, mask, eps, precision, l1_w=0.0, l1_h=0.0, l2_w=0.0,
                           l2_h=0.0, *, mesh):
    """Sharded masked KL MU step: the mask splits like X, and both
    denominators are mask GEMMs summed with their numerators."""
    h = update_h_sharded_masked(w, h, x, mask, eps, precision, l1_h, l2_h, mesh=mesh)
    z = mask * (x / eps_clamp(matmul(w, h, precision), eps))
    numer = psum(matmul(z, h, precision, transpose_b=True), mesh, COL_AXIS)
    denom = eps_clamp(psum(matmul(mask, h, precision, transpose_b=True), mesh, COL_AXIS),
                      eps) + l1_w + l2_w * w.to(_F32)
    return (w * (numer / denom)).to(w.dtype), h


def kl_partial(x, w, h, eps: float):
    """This block's KL partial (true-f32 recon); X blocks are disjoint, so
    the sum over both axes is the global divergence (matrix.cu:592)."""
    return kl_divergence(x, w, h, eps)


def _pen(l1, l2, a) -> torch.Tensor:
    af = a.to(_F32)
    return l1 * torch.sum(torch.abs(af)) + 0.5 * l2 * torch.sum(af * af)


def reg_cost_partial(x, w, h, eps, l1_w, l1_h, l2_w, l2_h, n_row, n_col):
    """This block's penalized KL partial: W is held by the n_col ranks of
    its row and H by the n_row ranks of its column, so each penalty is
    divided by its copies and the global sum counts it once."""
    return kl_partial(x, w, h, eps) + _pen(l1_w, l2_w, w) / n_col + _pen(l1_h, l2_h, h) / n_row


def masked_kl_partial(x, w, h, mask, eps: float, l1_w=0.0, l1_h=0.0, l2_w=0.0, l2_h=0.0,
                      n_row=1, n_col=1):
    """This block's masked KL partial, the penalties divided by their
    copies as in :func:`reg_cost_partial`."""
    y = eps_clamp(matmul(w, h, Precision()), eps)
    xf = x.to(_F32)
    xlog = torch.where(xf > 0, xf * (torch.log(xf) - torch.log(y)), 0.0)
    total = torch.sum(mask * (xlog - xf + y))
    if l1_w or l1_h or l2_w or l2_h:
        total = total + _pen(l1_w, l2_w, w) / n_col + _pen(l1_h, l2_h, h) / n_row
    return total


def _host_quantized(x, config: SolveConfig, clamp: bool, mask=None):
    """The global X as the ``(codes, scales)`` pair the prep makes on one
    device, made on the host by :func:`~nmf_tpu_torch.ops.quant.
    quantize_policy_np` (the device quantizer's bits), so that no rank puts
    the whole X on its device: f32, clamped to eps when ``clamp``, the
    entries the mask leaves out zeroed before the scales read them."""
    eps = float(config.eps)
    xf = to_tensor(x, "cpu").to(_F32).numpy()
    if clamp:
        xf = np.maximum(xf, np.float32(eps))
    if mask is not None:
        keep = to_tensor(mask, "cpu").to(_F32).numpy() > 0
        xf = np.where(keep, xf, np.float32(0.0))
    return quantize_policy_np(xf, eps, config.precision.x_quant_rows)


def _local_problem(x, w0, h0, config: SolveConfig, clamp_inputs: bool, mesh, mask=None):
    """This rank's prepped blocks of (X, W, H), and of the mask (split like
    X) when one is given: the prep of ``solve``, or of ``solve_masked``
    with a mask.  int8 X that is not a pair yet is quantized whole on the
    host first (a column's or row block's scale reads all its rows) and
    then cut; every other X is cut first and its block prepped alone, which
    gives the same bits (the prep is elementwise).  No rank holds more of X
    on its device than its block."""
    dev = mesh_device(mesh)
    if config.precision.x_dtype == "int8" and not isinstance(x, tuple):
        x = _host_quantized(x, config, clamp_inputs or mask is not None, mask)
    x, w0, h0 = shard_problem(x, w0, h0, mesh)
    if mask is None:
        return _prep(x, w0, h0, config, clamp_inputs, dev)
    return _masked_prep(x, w0, h0, local_block(mask, nmf_shardings(mesh)[0]), config, dev)


def _local_extrap(initial_extrap, config: SolveConfig, mesh):
    if initial_extrap is None:
        return None
    dev = mesh_device(mesh)
    return tuple(to_state(a, config, dev, clamp=False) for a in initial_extrap)


def _nan_none(v) -> Optional[float]:
    v = float(v)
    return None if np.isnan(v) else v


def solve_sharded(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    mesh=None,
    clamp_inputs: bool = True,
    initial_cost: float = float("nan"),
    initial_momentum: float = float("nan"),
    initial_extrap=None,
) -> Optional[SolveResult]:
    """Distributed ``solve``: its semantics, sharded over ``mesh``
    (default: :func:`~nmf_tpu_torch.parallel.mesh.make_mesh` over the
    world, on the card).  Every rank calls it with the same global inputs
    and gets its blocks and the replicated scalars (module docstring;
    :func:`gather_result` for the global factors).  ``initial_cost`` and
    ``initial_momentum`` resume a run as in ``solve``; ``initial_extrap``
    is this rank's carry blocks (a previous segment's ``w_ex``/``h_ex``).
    """
    config.validate()
    mesh = check_mesh(mesh) if mesh is not None else make_mesh()
    check_inputs(x, w0, h0, config)
    if mesh_coordinate(mesh) is None:
        return None
    fused = _fused_for(config, w0, h0, mesh, "sharded")
    x, w0, h0 = _local_problem(x, w0, h0, config, clamp_inputs, mesh)
    fn = build_sharded_solver(config, mesh, fused=fused)
    return fn(x, w0, h0, initial_cost, initial_momentum,
              initial_extrap=_local_extrap(initial_extrap, config, mesh))


def _fused_for(config: SolveConfig, w0, h0, mesh, entry: str) -> bool:
    """:func:`_use_fused` at this problem's local shape (``factor_shapes``
    raises first when the mesh does not divide it)."""
    (m, k), n = _shape(w0), _shape(h0)[1]
    (m_loc, n_loc), _, _ = factor_shapes(m, k, n, mesh)
    return config.algorithm == "mu" and _use_fused(
        config, m_loc, k, n_loc, mesh_device(mesh), config.precision.x_dtype == "int8", entry)


def solve_h_only_sharded(x, w, h0, config: SolveConfig, mesh) -> Optional[SolveResult]:
    """``solve_h_only(mesh=)``: this rank's blocks through
    :func:`build_sharded_h_solver` (inputs checked by the caller)."""
    mesh = check_mesh(mesh)
    if mesh_coordinate(mesh) is None:
        return None
    x, w, h0 = _local_problem(x, w, h0, config, True, mesh)
    return build_sharded_h_solver(config, mesh)(x, w, h0)


def solve_semi_sharded(x, w0, h0, config: SolveConfig, n_frozen: int, mesh
                       ) -> Optional[SolveResult]:
    """``solve_semi(mesh=)`` (``semi.py:125-140`` of the JAX package): the
    first ``n_frozen`` columns of each rank's W block keep their prepped
    values; ``fused`` as :func:`solve_sharded` decides it."""
    mesh = check_mesh(mesh)
    if mesh_coordinate(mesh) is None:
        return None
    fused = _fused_for(config, w0, h0, mesh, "sharded_semi")
    x, w0, h0 = _local_problem(x, w0, h0, config, True, mesh)
    mk = torch.arange(w0.shape[1], device=w0.device) < int(n_frozen)
    return build_sharded_semi_solver(config, mesh, fused)(x, w0, h0, mk)


def gather_result(res: Optional[SolveResult], mesh, w_spec=(ROW_AXIS, None),
                  h_spec=(None, COL_AXIS)) -> Optional[SolveResult]:
    """``res`` with the global W and H (and the carry, when set) on every
    rank, from the blocks each rank holds (``w_spec``/``h_spec``: the
    layout of the blocks, the canonical one by default).  Every rank of the
    mesh calls it; None (a rank outside the mesh) passes through."""
    if res is None:
        return None

    def full(t, spec):
        return None if t is None else gather(t, Placement(mesh, spec))

    return dataclasses.replace(res, w=full(res.w, w_spec), h=full(res.h, h_spec),
                               w_ex=full(res.w_ex, w_spec), h_ex=full(res.h_ex, h_spec))


def build_sharded_solver(config: SolveConfig, mesh, fused: bool = False):
    """The sharded solve of a config on a mesh, built once and cached:
    ``fn(x, w, h, initial_cost, initial_momentum, initial_extrap=None)`` on
    this rank's prepped blocks."""
    return _build_sharded_solver_cached(config, mesh, bool(fused))


def _sharded_family_fns(config: SolveConfig, mesh, fused: bool):
    """(step_fn, cost_fn) of each family on the canonical layout, shared by
    the full solver and the semi-adaptive one."""
    eps, precision = config.eps, config.precision
    if config.algorithm == "hals":
        step_fn = functools.partial(hals_step_sharded, eps=eps, precision=precision, mesh=mesh)
        cost_fn = functools.partial(beta_partial, beta=2.0, eps=eps)
    elif config.beta == 1.0 and config.regularized:
        step_fn = functools.partial(
            mu_step_sharded_reg, eps=eps, precision=precision, l1_w=config.l1_w,
            l1_h=config.l1_h, l2_w=config.l2_w, l2_h=config.l2_h, mesh=mesh,
        )
        cost_fn = functools.partial(
            reg_cost_partial, eps=eps, l1_w=config.l1_w, l1_h=config.l1_h, l2_w=config.l2_w,
            l2_h=config.l2_h, n_row=axis_size(mesh, ROW_AXIS), n_col=axis_size(mesh, COL_AXIS),
        )
    elif config.beta == 1.0:
        step_fn = functools.partial(mu_step_sharded, eps=eps, precision=precision, fused=fused,
                                    mesh=mesh)
        cost_fn = functools.partial(kl_partial, eps=eps)
    else:
        step_fn = functools.partial(mu_step_sharded_beta, beta=config.beta, eps=eps,
                                    precision=precision, mesh=mesh)
        cost_fn = functools.partial(beta_partial, beta=config.beta, eps=eps)
    if precision.x_dtype == "int8":
        step_fn, cost_fn = _wrap_dequant_local(step_fn, cost_fn, mesh)
    return step_fn, cost_fn


def _segment(step, cost, config: SolveConfig, mesh):
    """The per-rank solve over a (step, cost) pair: the checked loop with
    the mesh's cost sum and live emitter."""
    kw = _loop_kw(mesh)

    def local_solve(x, w, h, initial_cost=float("nan"), initial_momentum=float("nan"),
                    initial_extrap=None):
        return run_checked_loop(x, w, h, config, step, cost, _nan_none(initial_cost),
                                _nan_none(initial_momentum), initial_extrap, **kw)

    return local_solve


@functools.lru_cache(maxsize=32)
def _build_sharded_solver_cached(config: SolveConfig, mesh, fused: bool):
    step_fn, cost_fn = _sharded_family_fns(config, mesh, fused)
    return _segment(step_fn, cost_fn, config, mesh)


@functools.lru_cache(maxsize=8)
def build_sharded_masked_solver(config: SolveConfig, mesh):
    """The sharded masked KL MU solve: ``fn(x, w, h, mask, initial_cost,
    initial_momentum, initial_extrap=None)``, the mask block split like X."""
    eps, precision = config.eps, config.precision
    pens = dict(l1_w=config.l1_w, l1_h=config.l1_h, l2_w=config.l2_w, l2_h=config.l2_h)
    repl = dict(n_row=axis_size(mesh, ROW_AXIS), n_col=axis_size(mesh, COL_AXIS))
    dq = _dq_local_or_id(precision.x_dtype == "int8", mesh)
    kw = _loop_kw(mesh)

    def local_solve(x, w, h, mask, initial_cost=float("nan"), initial_momentum=float("nan"),
                    initial_extrap=None):
        def step(w_, h_, xx):
            return mu_step_sharded_masked(w_, h_, dq(xx), mask, eps, precision, **pens,
                                          mesh=mesh)

        def cost(xx, w_, h_):
            return masked_kl_partial(dq(xx), w_, h_, mask, eps, **pens, **repl)

        return run_checked_loop(x, w, h, config, step, cost, _nan_none(initial_cost),
                                _nan_none(initial_momentum), initial_extrap, **kw)

    return local_solve


@functools.lru_cache(maxsize=8)
def build_sharded_h_solver(config: SolveConfig, mesh):
    """The sharded H-only solve (W fixed, its row blocks replicated over
    'mc'): the MU families and HALS, only K-sized products summed over 'mr'.
    The KL step takes the plain numerator, as JAX's (``sharded.py:
    722-816``)."""
    eps, precision = config.eps, config.precision
    r = axis_size(mesh, ROW_AXIS)
    if config.algorithm == "hals":
        def step(w, h, x):
            return w, hals_update_h_sharded(w, h, x, eps, precision, mesh=mesh)

        cost = functools.partial(beta_partial, beta=2.0, eps=eps)
    elif config.beta == 1.0 and config.regularized:
        def step(w, h, x):
            return w, update_h_sharded_reg(w, h, x, eps, precision, config.l1_h, config.l2_h,
                                           mesh=mesh)

        def cost(x, w, h):
            # the H penalties only; H is held by the r ranks of its column
            return kl_partial(x, w, h, eps) + _pen(config.l1_h, config.l2_h, h) / r
    elif config.beta == 1.0:
        def step(w, h, x):
            return w, update_h_sharded(w, h, x, eps, precision, mesh=mesh)

        cost = functools.partial(kl_partial, eps=eps)
    else:
        def step(w, h, x):
            return w, update_h_sharded_beta(w, h, x, config.beta, eps, precision, mesh=mesh)

        cost = functools.partial(beta_partial, beta=config.beta, eps=eps)
    if precision.x_dtype == "int8":
        step, cost = _wrap_dequant_local(step, cost, mesh)
    return _segment(step, cost, config, mesh)


@functools.lru_cache(maxsize=8)
def build_sharded_semi_solver(config: SolveConfig, mesh, fused: bool = False):
    """The sharded semi-adaptive solve: ``fn(x, w, h, mk, initial_cost,
    initial_momentum, initial_extrap=None)``; the columns of W where the
    (K,) bool ``mk`` holds keep their values in the initial local W block
    (put back by ``torch.where`` after each step).  ``fused`` as the full
    solver's."""
    if config.algorithm == "hals":
        raise NotImplementedError(
            "HALS's in-place W sweep reads columns mid-update; frozen columns need the "
            "MU families"
        )
    step_fn, cost_fn = _sharded_family_fns(config, mesh, fused)
    kw = _loop_kw(mesh)

    def local_solve(x, w, h, mk, initial_cost=float("nan"), initial_momentum=float("nan"),
                    initial_extrap=None):
        w_frz = w       # no step writes into its input

        def step(w_, h_, x_):
            w2, h2 = step_fn(w_, h_, x_)
            return torch.where(mk[None, :], w_frz, w2).to(w2.dtype), h2

        return run_checked_loop(x, w, h, config, step, cost_fn, _nan_none(initial_cost),
                                _nan_none(initial_momentum), initial_extrap, **kw)

    return local_solve


@functools.lru_cache(maxsize=8)
def build_sharded_masked_h_solver(config: SolveConfig, mesh):
    """The sharded masked H-only solve over a packed ``(x, mask)`` block:
    both mask GEMMs summed over 'mr', the H penalties divided by the r
    copies of H."""
    eps, prec = config.eps, config.precision
    l1_h, l2_h = config.l1_h, config.l2_h
    r = axis_size(mesh, ROW_AXIS)
    dq = _dq_local_or_id(prec.x_dtype == "int8", mesh)

    def step(w, h, xm):
        return w, update_h_sharded_masked(w, h, dq(xm[0]), xm[1], eps, prec, l1_h, l2_h,
                                          mesh=mesh)

    def cost(xm, w, h):
        return masked_kl_partial(dq(xm[0]), w, h, xm[1], eps) + _pen(l1_h, l2_h, h) / r

    return _segment(step, cost, config, mesh)


def drop_cached_solvers() -> None:
    """Empty the solver caches keyed by a mesh: each cached solver holds its
    ``DeviceMesh``, and so the mesh's process groups and their threads, for
    the life of the process.  :func:`~nmf_tpu_torch.parallel.mesh.shutdown`
    calls it, so that the groups end when the caller drops its mesh and not
    in the interpreter's teardown."""
    for builder in (_build_sharded_solver_cached, build_sharded_masked_solver,
                    build_sharded_h_solver, build_sharded_semi_solver,
                    build_sharded_masked_h_solver):
        builder.cache_clear()
