"""Consensus-clustering rank selection (Brunet et al., PNAS 2004).

Counterpart of ``nmf_tpu.models.stability``: factorize many times per
candidate rank from seeded initializations, label each column by the
component that dominates it, and average the connectivity matrices into a
per-rank consensus matrix.  Two summaries: the **cophenetic correlation**
of its average-linkage dendrogram (1.0 = stable; Brunet's rule picks the
largest K before it first falls) and the **dispersion**
``mean(4 (C - 1/2)^2)`` (Kim & Park 2007).

The whole study, every rank and every restart, is ONE
:func:`~nmf_tpu_torch.models.selection.solve_rank_sweep` call (members
embedded at ``max(ranks)``), and every member's H comes to the host in one
copy; the O(N^2) consensus assembly runs there (scipy's ``average`` and
``cophenet``).  N is X's column count: sample or slice a very wide X first.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from ..utils.config import SolveConfig
from .selection import SelectionResult, solve_rank_sweep

__all__ = ["StabilityResult", "rank_stability", "consensus_matrix"]


def _consensus_from_host(h_all: np.ndarray, ranks: np.ndarray, rank: int) -> np.ndarray:
    idx = [i for i in range(len(ranks)) if int(ranks[i]) == int(rank)]
    if not idx:
        raise ValueError(f"no members with rank {rank} in this result")
    n = h_all.shape[2]
    acc = np.zeros((n, n), np.float64)
    for i in idx:
        labels = h_all[i, : int(rank), :].argmax(axis=0)
        acc += labels[:, None] == labels[None, :]
    return (acc / len(idx)).astype(np.float32)


def _h_on_host(sel: SelectionResult) -> np.ndarray:
    """Every member's H in one device-to-host copy, as f32."""
    return sel.results.h.float().cpu().numpy()


def consensus_matrix(sel: SelectionResult, rank: int) -> np.ndarray:
    """Average connectivity matrix over ``sel``'s members of this rank: a
    column's label is its dominant component (argmax over H's rank axis);
    two columns are connected when their labels agree."""
    return _consensus_from_host(_h_on_host(sel), sel.ranks, rank)


def _cophenetic(consensus: np.ndarray) -> float:
    """Cophenetic correlation of the consensus matrix (scipy average
    linkage over 1 - consensus)."""
    from scipy.cluster.hierarchy import average, cophenet
    from scipy.spatial.distance import squareform

    d = 1.0 - consensus
    np.fill_diagonal(d, 0.0)
    # symmetrized against round-off before condensing
    cond = squareform((d + d.T) / 2.0, checks=False)
    if not np.any(cond):
        return 1.0  # perfectly stable: every restart agrees
    if np.ptp(cond) == 0.0:
        # every pair equally (un)stable: 0/0 correlation, no structure:
        # zero evidence of stability rather than NaN (which would poison
        # best_rank)
        return 0.0
    coph, _ = cophenet(average(cond), cond)
    return float(coph) if np.isfinite(coph) else 0.0


@dataclasses.dataclass
class StabilityResult:
    """Per-rank stability study: ``cophenetic`` and ``dispersion`` align
    with ``ranks``; ``consensus[k]`` is rank k's (N, N) consensus matrix
    (kept on request); ``sweep`` is the batched solve."""

    ranks: np.ndarray
    cophenetic: np.ndarray
    dispersion: np.ndarray
    consensus: Dict[int, np.ndarray]
    sweep: SelectionResult

    def best_rank(self) -> int:
        """Brunet's rule: the largest rank before the cophenetic
        coefficient first falls."""
        c = self.cophenetic
        for i in range(1, len(c)):
            if c[i] < c[i - 1] - 1e-9:
                return int(self.ranks[i - 1])
        return int(self.ranks[-1])


def rank_stability(
    x,
    ranks: Sequence[int],
    n_restarts: int = 20,
    config: SolveConfig = SolveConfig(),
    *,
    seed: int = 0,
    init: str = "random",
    mesh=None,
    keep_consensus: bool = False,
    device="cuda",
) -> StabilityResult:
    """Consensus-clustering stability study over candidate ranks
    (``nmf_tpu/models/stability.py:116-169``).

    ``len(ranks) * n_restarts`` factorizations run as one
    :func:`solve_rank_sweep` (member i seeded ``seed + i``) on ``device``
    (``"cuda"`` by default); the consensus matrices and their coefficients
    are taken on the host.  ``ranks`` are de-duplicated and sorted
    ascending (the first-drop rule scans upward); ``init`` must be
    seed-sensitive ('random', 'scaled', 'nndsvdar').
    """
    ranks = sorted({int(k) for k in ranks})
    if not ranks:
        raise ValueError("ranks must be non-empty")
    if n_restarts < 2:
        raise ValueError("a consensus over fewer than 2 restarts cannot measure stability")
    if init not in ("random", "scaled", "nndsvdar"):
        raise ValueError(
            f"init={init!r} is deterministic: every restart would be "
            "identical (use 'random', 'scaled', or 'nndsvdar')"
        )
    members = [k for k in ranks for _ in range(n_restarts)]
    sweep = solve_rank_sweep(x, members, config=config, seed=seed, init=init, mesh=mesh,
                             device=device)
    coph = np.empty(len(ranks), np.float64)
    disp = np.empty(len(ranks), np.float64)
    kept: Dict[int, np.ndarray] = {}
    h_all = _h_on_host(sweep)
    for j, k in enumerate(ranks):
        c = _consensus_from_host(h_all, sweep.ranks, k)
        coph[j] = _cophenetic(c)
        disp[j] = float(np.mean(4.0 * (c - 0.5) ** 2))
        if keep_consensus:
            kept[k] = c
    return StabilityResult(
        ranks=np.asarray(ranks, np.int64),
        cophenetic=coph,
        dispersion=disp,
        consensus=kept,
        sweep=sweep,
    )
