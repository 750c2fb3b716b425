"""Strict reference-replication mode: the padded-EPS numerics, exactly.

Counterpart of ``nmf_tpu.models.strict``.  The default solver improves on
the reference's numerics (exact zero padding, reductions over the logical
extents).  The reference itself computes over buffers padded to
``PAD_MULT = 32`` multiples (matrix.cuh:7), where:

* ``set_epsilon`` clamps the PADDED buffer (matrix.cu:191), so the padding
  becomes >= EPS at load (nmf.cu:211);
* the GEMMs run over the padded extents, and ``sum_cols``/``sum_rows``
  reduce over the padded dims (matrix.cu:277-278, 396-397): the padding of
  H evolves under the updates and adds O(pad * EPS) terms to ``sum_rows(H)``.

This module replays that: X, W and H zero-padded to 32-multiples, the load
clamp over the padded buffers, the plain torch step (``backend="jnp"``,
true f32 GEMMs) on the padded shapes, and the factors de-padded at the end
as ``write_matrix`` does (nmf.cu:227-232).  With ``thresh=0`` the iteration
count is exact and every op is deterministic, so reruns on one stack give
the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.config import Precision, SolveConfig
from .solver import SolveResult, solve

__all__ = ["PAD_MULT", "pad_to_mult", "solve_strict"]

PAD_MULT = 32  # cuda/matrix.cuh:7


def pad_to_mult(a: np.ndarray, mult: int = PAD_MULT) -> np.ndarray:
    """Zero-pad both dims up to the next multiple (the reference's
    add_padding, matrix.cu:42-95, on zero-initialized allocations)."""
    m, n = a.shape
    mp = -(-m // mult) * mult
    np_ = -(-n // mult) * mult
    if (mp, np_) == (m, n):
        return np.asarray(a, np.float32)
    out = np.zeros((mp, np_), np.float32)
    out[:m, :n] = a
    return out


def solve_strict(x, w0, h0, config: SolveConfig = SolveConfig(), device="cuda") -> SolveResult:
    """Factorize with the reference's padded-EPS numerics.

    Forces the reference-parity policy: all-f32 ``Precision``, the plain
    torch step (``backend="jnp"``, whose op order mirrors nmf.cu:118-176),
    and padded-extent reductions over real padded buffers.  The factors of
    the result are de-padded to the logical shapes; the cost history (if
    tracked) is taken over the padded buffers.  ``device`` as in
    :func:`~nmf_tpu_torch.models.solver.solve`.
    """
    config.validate()
    # strict mode replays the reference's ONE algorithm, plain KL MU: a
    # config that changes the update rule raises instead of producing
    # output under a reference-replication label
    offending = [
        flag
        for flag, on in (
            ("accelerate=True", config.accelerate),
            (f"algorithm={config.algorithm!r}", config.algorithm != "mu"),
            (f"beta={config.beta}", config.beta != 1.0),
            ("l1/l2 penalties", config.regularized),
        )
        if on
    ]
    if offending:
        raise ValueError(
            "solve_strict replicates the reference's plain KL (beta=1) MU "
            f"update; {', '.join(offending)} would run a different "
            "algorithm under a reference-replication label"
        )
    x = np.asarray(x, np.float32)
    w0 = np.asarray(w0, np.float32)
    h0 = np.asarray(h0, np.float32)
    if x.shape != (w0.shape[0], h0.shape[1]) or w0.shape[1] != h0.shape[0]:
        raise ValueError(
            f"shape mismatch: X{x.shape} vs W{w0.shape} @ H{h0.shape}"
        )
    m, k = w0.shape
    n = h0.shape[1]
    strict_cfg = dataclasses.replace(
        config,
        backend="jnp",                      # the reference's op order
        precision=Precision("float32", "float32", "float32"),
    )
    res = solve(
        pad_to_mult(x), pad_to_mult(w0), pad_to_mult(h0), strict_cfg,
        clamp_inputs=True,                  # load clamp over the PADDED buffers
        device=device,
    )
    return dataclasses.replace(
        res,
        w=res.w[:m, :k].contiguous(),       # de-pad as write_matrix does
        h=res.h[:k, :n].contiguous(),
    )
