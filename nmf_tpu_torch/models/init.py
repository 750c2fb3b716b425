"""Factor initialization (NumPy), counterpart of ``nmf_tpu.models.init``.

* ``random_init``        -- seeded uniform, the reference generator's semantics
* ``scaled_random_init`` -- uniform scaled so mean(W@H) matches mean(X)
* ``nndsvd_init``        -- Boutsidis & Gallopoulos (2008) SVD-based init, with
                            the 'a' (average-fill) and 'ar' (random-fill)
                            variants; deterministic, a much better start

All return NumPy float32 and are the JAX package's NumPy code, so both
packages give the same bytes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["random_init", "scaled_random_init", "nndsvd_init"]


def random_init(m: int, k: int, n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform[0,1) W and H from NumPy's legacy RandomState (matrix_export.py:4-7)."""
    rng = np.random.RandomState(seed)
    w = rng.rand(m, k).astype(np.float32)
    h = rng.rand(k, n).astype(np.float32)
    return w, h


def scaled_random_init(x: np.ndarray, k: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform init scaled so E[W@H] == E[X] (removes the initial scale gap)."""
    m, n = x.shape
    w, h = random_init(m, k, n, seed)
    # E[w]=E[h]=0.5 -> E[(WH)_ij] = k/4 ; rescale each factor by sqrt
    target = float(np.mean(x))
    scale = np.sqrt(max(target, np.finfo(np.float32).tiny) / (k * 0.25))
    return (w * scale).astype(np.float32), (h * scale).astype(np.float32)


def nndsvd_init(
    x: np.ndarray,
    k: int,
    variant: str = "nndsvd",
    seed: int = 0,
    eps: float = 1e-6,
    svd: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Non-Negative Double SVD initialization (Boutsidis & Gallopoulos 2008).

    variants: 'nndsvd' (zeros kept -- best for sparse output), 'nndsvda'
    (zeros set to mean(X) -- dense, good for KL/MU, which cannot move exact
    zeros), 'nndsvdar' (zeros set to small random values -- dense, breaks
    symmetry).

    ``svd`` optionally supplies a precomputed ``np.linalg.svd(x,
    full_matrices=False)`` triple: the SVD depends only on X, so a rank
    sweep computes it once and slices it per rank.
    """
    if variant not in ("nndsvd", "nndsvda", "nndsvdar"):
        raise ValueError(f"unknown NNDSVD variant {variant!r}")
    x = np.asarray(x, dtype=np.float64)
    m, n = x.shape
    if k > min(m, n):
        raise ValueError(f"rank {k} exceeds min(M, N) = {min(m, n)}")
    u, s, vt = np.linalg.svd(x, full_matrices=False) if svd is None else svd
    u, s, vt = u[:, :k], s[:k], vt[:k]

    w = np.zeros((m, k))
    h = np.zeros((k, n))
    # leading factor: |u1| sqrt(s1), |v1| sqrt(s1) (the Perron vector is nonnegative)
    w[:, 0] = np.sqrt(s[0]) * np.abs(u[:, 0])
    h[0, :] = np.sqrt(s[0]) * np.abs(vt[0, :])
    for j in range(1, k):
        uj, vj = u[:, j], vt[j, :]
        up, un = np.maximum(uj, 0), np.maximum(-uj, 0)
        vp, vn = np.maximum(vj, 0), np.maximum(-vj, 0)
        n_up, n_un = np.linalg.norm(up), np.linalg.norm(un)
        n_vp, n_vn = np.linalg.norm(vp), np.linalg.norm(vn)
        pos, neg = n_up * n_vp, n_un * n_vn
        if pos >= neg:
            norm, uu, vv = pos, up / max(n_up, 1e-30), vp / max(n_vp, 1e-30)
        else:
            norm, uu, vv = neg, un / max(n_un, 1e-30), vn / max(n_vn, 1e-30)
        scale = np.sqrt(s[j] * norm)
        w[:, j] = scale * uu
        h[j, :] = scale * vv

    if variant == "nndsvda":
        avg = x.mean()
        w[w < eps] = avg
        h[h < eps] = avg
    elif variant == "nndsvdar":
        rng = np.random.RandomState(seed)
        avg = x.mean()
        wz = w < eps
        hz = h < eps
        w[wz] = avg * rng.rand(int(wz.sum())) / 100.0
        h[hz] = avg * rng.rand(int(hz.sum())) / 100.0
    return w.astype(np.float32), h.astype(np.float32)
