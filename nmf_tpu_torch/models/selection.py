"""Model selection: multi-restart and rank-sweep NMF in one batched solve.

Counterpart of ``nmf_tpu.models.selection``.  NMF's objective is
non-convex, and the rank K is a model-order choice: standard practice
re-solves from several seeded initializations and keeps the lowest cost
(restarts), and sweeps K (rank sweep).  Both run here as one batched solve
(:func:`nmf_tpu_torch.parallel.batched.run_batched_loop`) whose members
share one copy of X: X goes to the member-axis kernels 2-D, as JAX vmaps
with ``in_axes=None``.

* **Restarts**: R members at one rank; member i of the kernels gives the
  bits of the 2-D solve from the same init.
* **Rank sweep**: every member is embedded at the widest rank ``Kmax``, its
  unused columns of W and rows of H pinned at exact zeros (the embedding
  mask goes on after the load clamp and again after every step).
  Multiplicative updates keep exact zeros: a zero column of W gives a zero
  numerator row for H, and the kernels' epilogue ``h * acc / sum`` takes
  ``0 * 0 / eps = 0``; symmetrically for W.  So each member is the
  lower-rank problem, run at Kmax's chunk width (its sums in another
  order): equal within rounding, not bit for bit.  HALS keeps the zeros
  too (a masked rank's coordinate gradient is exactly zero).
* **Frozen columns** (``n_frozen``): each member's first columns of W are
  put back from its own initial W after every step (``solve_semi``'s
  semantics); MU families only.

The selection signal is the final cost, so ``track_cost`` is forced on.
Per-member convergence is the batched solver's.  ``backend="auto"`` takes
the card's rule for a member axis (``utils.autotune.rule_pick`` with
``members``): at K <= 32 on the H100 cuBLAS's batched GEMMs, where the
member-axis kernels measured slower; ``backend="pallas"`` keeps the
kernels and their member-i-equals-2-D bits.

**On a mesh** (``selection.py:252-262`` of the JAX package) the members
are split over the mesh's FIRST axis ('mr') and replicated over the
second: the ranks of a mesh row run the same members, as JAX replicates
them, and X is whole on every rank.  A
:class:`~nmf_tpu_torch.parallel.mesh.FlatMesh` (the CLI's ``select``
and ``--restarts``, ``NMF(n_restarts > 1)``) splits them over all the
ranks instead.  Each rank runs its members through the batched kernels
(the rule resolving at its member count); then every member's factors
and scalars are gathered onto every rank, so the :class:`SelectionResult`
is the same everywhere and the best member is chosen from all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.quant import quantize_policy
from ..parallel.batched import batched_step_cost, run_batched_loop
from ..utils.autotune import resolve_config
from ..utils.config import SolveConfig
from ..utils.convert import to_tensor
from ..utils.device import resolve_device
from .init import nndsvd_init, random_init, scaled_random_init
from ..parallel.batched import gather_members, member_split
from ..parallel.mesh import (
    BOTH,
    ROW_AXIS,
    FlatMesh,
    axis_size,
    check_mesh,
    mesh_coordinate,
    mesh_device,
)
from .solver import _DTYPES, SolveResult

__all__ = ["SelectionResult", "solve_restarts", "solve_rank_sweep"]

_F32 = torch.float32


@dataclasses.dataclass
class SelectionResult:
    """Batched selection outcome.

    ``results`` is the batched :class:`SolveResult` (member axis first;
    factors embedded at the widest rank, on the solve's device).
    ``ranks[i]`` is member i's rank; :meth:`factors` crops the embedding.
    """

    results: SolveResult
    ranks: np.ndarray

    @property
    def n_members(self) -> int:
        return int(self.ranks.shape[0])

    @property
    def costs(self) -> np.ndarray:
        return self.results.cost.cpu().numpy()

    @property
    def iterations(self) -> np.ndarray:
        return self.results.iterations.cpu().numpy()

    @property
    def converged(self) -> np.ndarray:
        return self.results.converged.cpu().numpy()

    @property
    def best_index(self) -> int:
        """Member with the lowest final cost: meaningful for restarts; a
        rank sweep's costs form a curve over ``ranks`` (wider fits better),
        to be read by elbow or stability, not argmin."""
        return int(np.argmin(self.costs))

    def factors(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Member i's (W, H) cropped to its rank."""
        k = int(self.ranks[i])
        return self.results.w[i, :, :k], self.results.h[i, :k, :]

    @property
    def best(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.factors(self.best_index)

    @property
    def best_cost(self) -> float:
        return float(self.costs[self.best_index])

    def best_solve_result(self) -> SolveResult:
        """The lowest-cost member as a single-problem :class:`SolveResult`
        (factors at the embedding width; :attr:`best` crops them)."""
        b = self.best_index
        return SolveResult(**{
            f.name: None if getattr(self.results, f.name) is None
            else getattr(self.results, f.name)[b]
            for f in dataclasses.fields(SolveResult)
        })


def _prep_selection(x, w0s, h0s, mks, config: SolveConfig, clamp_inputs: bool,
                    masked: bool, dev: torch.device):
    """``_selection_prep_jit`` (``nmf_tpu/models/selection.py:157-184``):
    clamp and casts, the rank-embedding mask after the clamp, and X cast or
    quantized once for every member."""
    prec, eps = config.precision, float(config.eps)
    sd = _DTYPES[prec.state_dtype]
    x = to_tensor(x, dev).to(_F32)
    w0s, h0s = (to_tensor(a, dev).to(sd) for a in (w0s, h0s))
    if clamp_inputs:
        x = torch.clamp_min(x, eps)
        fill = torch.full((), eps, dtype=sd, device=dev)
        w0s, h0s = torch.maximum(w0s, fill), torch.maximum(h0s, fill)
    mks = torch.from_numpy(mks).to(dev).to(sd)
    if masked:
        w0s, h0s = _mask_factors(w0s, h0s, mks)
    if prec.x_dtype == "int8":
        x = tuple(t.contiguous() for t in quantize_policy(x, eps, prec.x_quant_rows))
    else:
        x = x.to(_DTYPES[prec.x_dtype]).contiguous()
    return x, w0s.contiguous(), h0s.contiguous(), mks


def _mask_factors(w, h, mk):
    """Zero each member's unused rank slots: mk ``[R, Kmax]`` {0, 1} in the
    state dtype."""
    return w * mk[:, None, :], h * mk[:, :, None]


def _solve_selection(x, w0s, h0s, ranks: np.ndarray, config: SolveConfig, mesh,
                     clamp_inputs: bool, n_frozen: int, device) -> SelectionResult:
    config.validate()
    # final costs are the selection signal: always track them
    if not config.track_cost and config.thresh == 0.0:
        config = dataclasses.replace(config, track_cost=True)
    if config.live_metrics:
        config = dataclasses.replace(config, live_metrics=False)
    r, kmax = int(np.shape(w0s)[0]), int(np.shape(w0s)[2])
    masked = bool(np.any(ranks < kmax))
    if n_frozen:
        if config.algorithm == "hals":
            raise NotImplementedError(
                "HALS's in-place W sweep reads columns mid-update; frozen "
                "columns need the MU families"
            )
        if not (0 < n_frozen <= int(np.min(ranks))):
            raise ValueError(
                f"n_frozen must be in [1, min(ranks)={int(np.min(ranks))}], got {n_frozen}"
            )
    m, n = np.shape(x)
    if tuple(np.shape(w0s)) != (r, m, kmax) or tuple(np.shape(h0s)) != (r, kmax, n):
        raise ValueError(
            f"member shapes disagree: X{tuple(np.shape(x))} vs W{tuple(np.shape(w0s))} "
            f"@ H{tuple(np.shape(h0s))}"
        )
    mks = (np.arange(kmax)[None, :] < np.asarray(ranks)[:, None]).astype(np.float32)
    axes = None
    if mesh is not None:
        # members over the first axis, or over every rank of a FlatMesh
        if isinstance(mesh, FlatMesh):
            mesh, axes, label = mesh.mesh, BOTH, mesh.name
        else:
            mesh = check_mesh(mesh)
            axes = label = ROW_AXIS
        size = axis_size(mesh, axes)
        if r % size:
            raise ValueError(f"members {r} must be a multiple of mesh axis {label}={size}")
        if mesh_coordinate(mesh) is None:
            return None
        span = member_split(mesh, axes, r)
        w0s, h0s, mks = w0s[span], h0s[span], mks[span]
        r, dev = r // size, mesh_device(mesh)
    else:
        dev = resolve_device(device)
    config = resolve_config(config, m, kmax, n, dev, "selection", members=r)
    x, w0s, h0s, mks = _prep_selection(x, w0s, h0s, mks, config, clamp_inputs, masked, dev)
    step_fn, cost_fn = batched_step_cost(config)
    step = step_fn
    if masked or n_frozen:
        # the frozen source is each member's initial W (nothing writes it)
        w_frz = w0s
        fz = (torch.arange(kmax, device=dev) < int(n_frozen))[None, None, :]

        def step(w, h, x_):
            w2, h2 = step_fn(w, h, x_)
            if masked:
                w2, h2 = _mask_factors(w2, h2, mks)
            if n_frozen:
                w2 = torch.where(fz, w_frz, w2)
            return w2, h2

    res = run_batched_loop(x, w0s, h0s, config, step, cost_fn)
    if mesh is not None:
        res = gather_members(res, mesh, axes, factors=True)
    return SelectionResult(results=res, ranks=np.asarray(ranks, np.int64))


def _member_inits(x_np: np.ndarray, ranks: Sequence[int], init: str,
                  seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Member i's init at its rank with seed ``seed + i``, embedded at
    ``max(ranks)`` (``nmf_tpu/models/selection.py:279-304``): the SVD-based
    inits share one SVD of X."""
    m, n = x_np.shape
    r, kmax = len(ranks), int(max(ranks))
    w0s = np.zeros((r, m, kmax), np.float32)
    h0s = np.zeros((r, kmax, n), np.float32)
    svd = None
    if init not in ("random", "scaled"):
        svd = np.linalg.svd(np.asarray(x_np, np.float64), full_matrices=False)
    for i, k in enumerate(ranks):
        if init == "random":
            wi, hi = random_init(m, int(k), n, seed=seed + i)
        elif init == "scaled":
            wi, hi = scaled_random_init(x_np, int(k), seed=seed + i)
        else:
            wi, hi = nndsvd_init(x_np, int(k), variant=init, seed=seed + i, svd=svd)
        w0s[i, :, : int(k)] = wi
        h0s[i, : int(k), :] = hi
    return w0s, h0s


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def solve_restarts(
    x,
    rank: Optional[int] = None,
    n_restarts: Optional[int] = None,
    config: SolveConfig = SolveConfig(),
    *,
    seed: int = 0,
    init: str = "scaled",
    w0s=None,
    h0s=None,
    mesh=None,
    clamp_inputs: bool = True,
    n_frozen: int = 0,
    device="cuda",
) -> SelectionResult:
    """Solve one problem from ``n_restarts`` initializations in one batched
    solve sharing one copy of X; ``result.best`` is the lowest-cost (W, H).

    Give either ``rank`` (inits made with ``init`` and seeds ``seed + i``;
    ``n_restarts`` defaults to 8; the deterministic 'nndsvd'/'nndsvda'
    would make identical members) or explicit ``w0s``/``h0s`` stacks
    ``[R, M, K]`` / ``[R, K, N]``, which define the rank and member count.
    ``n_frozen`` keeps each member's first columns of W at their initial
    values (:func:`solve_semi` semantics).  The inputs go to ``device``
    (``"cuda"`` by default; a CUDA request without a card raises), or with
    ``mesh`` to the mesh's devices (module docstring).
    """
    if (w0s is None) != (h0s is None):
        raise ValueError("provide both w0s and h0s, or neither")
    if w0s is not None:
        if rank is not None or n_restarts is not None:
            raise ValueError(
                "explicit w0s/h0s stacks define the rank and member count — "
                "do not also pass rank or n_restarts (seed/init are likewise "
                "unused with explicit stacks)"
            )
        if not hasattr(w0s, "ndim"):
            w0s = np.asarray(w0s, np.float32)
        if not hasattr(h0s, "ndim"):
            h0s = np.asarray(h0s, np.float32)
        if w0s.ndim != 3 or h0s.ndim != 3:
            raise ValueError("w0s/h0s must be [R, M, K] / [R, K, N] stacks")
        ranks = np.full((w0s.shape[0],), w0s.shape[2], np.int64)
    else:
        if rank is None:
            raise ValueError("provide rank (for generated inits) or w0s/h0s")
        n_restarts = 8 if n_restarts is None else n_restarts
        if n_restarts < 1:
            raise ValueError("n_restarts must be >= 1")
        ranks = np.full((n_restarts,), int(rank), np.int64)
        w0s, h0s = _member_inits(_host(x).astype(np.float32), ranks, init, seed)
    return _solve_selection(x, w0s, h0s, ranks, config, mesh, clamp_inputs,
                            int(n_frozen), device)


def solve_rank_sweep(
    x,
    ranks: Sequence[int],
    config: SolveConfig = SolveConfig(),
    *,
    seed: int = 0,
    init: str = "scaled",
    mesh=None,
    clamp_inputs: bool = True,
    device="cuda",
) -> SelectionResult:
    """Solve one problem at several ranks in one batched solve.

    Each entry of ``ranks`` is a member embedded at ``max(ranks)`` with its
    unused slots pinned at exact zeros (module docstring); repeat a rank to
    add restarts (members get seeds ``seed + i``).  ``result.costs`` over
    ``result.ranks`` is the model-selection curve; ``result.factors(i)``
    crops member i.  Every family: MU (KL, beta, penalized) and HALS.
    """
    ranks = np.asarray(list(ranks), np.int64)
    if ranks.size == 0:
        raise ValueError("ranks must be non-empty")
    if np.any(ranks < 1):
        raise ValueError("ranks must be >= 1")
    w0s, h0s = _member_inits(_host(x).astype(np.float32), ranks, init, seed)
    return _solve_selection(x, w0s, h0s, ranks, config, mesh, clamp_inputs, 0, device)
