"""Semi-adaptive NMF: factorize with the first dictionary columns frozen.

Counterpart of ``nmf_tpu.models.semi``.  The reference paper's application
is template-based drum extraction: drum templates learned offline from solo
recordings stay fixed while the other columns of W adapt to the rest of the
mix.  :func:`solve_semi` spans the range between :func:`~nmf_tpu_torch.solve`
(nothing frozen) and :func:`~nmf_tpu_torch.solve_h_only` (all of W frozen).

The step is :func:`~nmf_tpu_torch.models.solver.resolve_step_fn`'s and the
cost ``_cost_fn``'s, so the KL family runs through the kernels K1, K2 and K3
on the card.  After every step the first ``n_frozen`` columns of W are put
back to their values after the load-time prep (clamped), by
``torch.where``: each W column's MU update reads only pre-update values, so
``n_frozen == K`` gives the H of ``solve_h_only`` and ``n_frozen == 0`` the
solve itself, bit for bit.  HALS is refused: its W sweep reads columns
mid-update, so restoring after the sweep would leak into the free columns.

The frozen source is the prepped W itself: no step writes into its input
(the kernel wrappers and the plain ops return new tensors, and so does the
accelerated loop's ``extrapolate``), so it needs no copy.  Under
``accelerate`` a frozen column's extrapolation is ``new + m (new - old)``
with ``new == old``, which leaves it bit-equal.

The frozen columns are the FIRST ``n_frozen`` of ``w0``: order the template
columns first.  ``backend="auto"`` and ``"autotune"`` resolve per shape as
:func:`~nmf_tpu_torch.solve`'s do (JAX's ``semi.py:143-158``), so that
``n_frozen=0`` stays the solve's kernels and bits.  ``mesh=`` runs the
solve sharded (:func:`~nmf_tpu_torch.parallel.sharded.solve_semi_sharded`:
K1/K2 ``numerator_only`` on each rank's block where the kernels apply, the
frozen columns those of each rank's prepped W block).
"""

from __future__ import annotations

import torch

from ..utils.autotune import resolve_config
from ..utils.config import SolveConfig
from ..utils.device import resolve_device
from .solver import (
    SolveResult,
    _cost_fn,
    _prep,
    _shape,
    resolve_step_fn,
    run_checked_loop,
)

__all__ = ["solve_semi"]


def solve_semi(
    x,
    w0,
    h0,
    config: SolveConfig = SolveConfig(),
    n_frozen: int = 0,
    mesh=None,
    device="cuda",
) -> SolveResult:
    """Factorize ``x ~= w @ h`` with the first ``n_frozen`` columns of W fixed.

    The MU families (KL, beta, penalized; HALS raises) and every precision
    policy; ``x`` is the float X (a ``(codes, scales)`` pair raises: the
    prep quantizes X itself).  ``device`` as in :func:`~nmf_tpu_torch.solve`;
    with ``mesh`` each rank gets its blocks on the mesh's device (the
    result contract of :mod:`nmf_tpu_torch.parallel.sharded`).
    """
    config.validate()
    if config.algorithm == "hals":
        raise NotImplementedError(
            "HALS's in-place W sweep reads columns mid-update; frozen "
            "columns need the MU families"
        )
    if isinstance(x, tuple):
        raise NotImplementedError(
            "solve_semi quantizes X itself (its prep clamps the frozen "
            "template columns too); pass the float X — pre-quantized "
            "(codes, scales) pairs are accepted by solve/solve_sharded/"
            "solve_h_only"
        )
    sx, sw, sh = _shape(x), _shape(w0), _shape(h0)
    if sx != (sw[0], sh[1]) or sw[1] != sh[0]:
        raise ValueError(f"shape mismatch: X{sx} vs W{sw} @ H{sh}")
    k = sw[1]
    if not (0 <= int(n_frozen) <= k):
        raise ValueError(f"n_frozen must be in [0, {k}], got {n_frozen}")
    if mesh is not None:
        from ..parallel.sharded import solve_semi_sharded

        return solve_semi_sharded(x, w0, h0, config, n_frozen, mesh)
    dev = resolve_device(device)
    config = resolve_config(config, sw[0], k, sh[1], dev, "semi")
    step_fn = resolve_step_fn(config)
    cost_fn = _cost_fn(config)
    # the frozen values are the clamped initial columns (nmf.cu:211)
    x, w0, h0 = _prep(x, w0, h0, config, True, dev)
    mk = (torch.arange(k, device=dev) < int(n_frozen))[None, :]
    w_frz = w0

    def step(w, h, x_):
        w2, h2 = step_fn(w, h, x_)
        return torch.where(mk, w_frz, w2).to(w2.dtype), h2

    return run_checked_loop(x, w0, h0, config, step, cost_fn)
