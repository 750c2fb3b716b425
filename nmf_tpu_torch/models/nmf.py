"""The model API: ``NMF`` (fit / transform / inverse_transform), the H-only
and W-only solves and ``normalize_factors``.

Counterpart of ``nmf_tpu.models.nmf``, on one device.  The paper's own
application (drum-source separation) refits H for new audio against a fixed
learned dictionary W: :func:`solve_h_only` iterates the H half-update alone
with the loop of :func:`~nmf_tpu_torch.solve` (plain or accelerated).  On
the KL family its step is the fused kernel K1 (``update_h_fused``) and its
cost K3 (``kl_cost_fused``) with a true-f32 recon in every policy, as JAX's
H-only cost is ``kl_divergence`` whatever the policy (``nmf.py:115``); the
beta, penalized and HALS H-steps take plain ops, as in JAX.  On CUDA
tensors ``backend="auto"`` and ``"autotune"`` resolve per shape as
:func:`~nmf_tpu_torch.solve`'s do (JAX's ``nmf.py:218-240``).

``NMF.transform(mask=...)`` scores partially observed columns through the
masked H-only solve (in memory, or streamed with ``out_of_core``).

``NMF(n_restarts > 1)`` fits through :func:`~nmf_tpu_torch.solve_restarts`
(all restarts in one batched solve) and keeps the lowest-cost member.

``mesh=`` (a ``DeviceMesh`` of :func:`~nmf_tpu_torch.make_mesh`) runs the
H-only solve and ``NMF``'s fit and transform sharded over the mesh's ranks
(:mod:`nmf_tpu_torch.parallel.sharded`; every rank calls with the same
inputs).  With ``n_restarts > 1`` the mesh's ranks form one member axis
(:class:`~nmf_tpu_torch.parallel.mesh.FlatMesh`), and
``transform(out_of_core=True)`` streams onto the mesh
(:func:`~nmf_tpu_torch.transform_out_of_core`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import hals, mu
from ..ops.divergence import beta_divergence, kl_divergence
from ..ops.elementwise import eps_clamp
from ..ops.kernels import fused_mu
from ..utils.autotune import resolve_config
from ..utils.config import Precision, SolveConfig
from ..utils.device import resolve_device
from .init import nndsvd_init, random_init, scaled_random_init
from .solver import (
    SolveResult,
    _dequant_wrap_cost,
    _dequant_wrap_step,
    _prep,
    _shape,
    _use_kernels,
    check_inputs,
    run_checked_loop,
    solve,
)

__all__ = ["NMF", "solve_h_only", "solve_w_only", "normalize_factors"]

_F32 = torch.float32


def _host(a) -> np.ndarray:
    """A tensor (any device; bf16 as exact f32) or array as NumPy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def normalize_factors(w, h, norm: str = "l1"):
    """Rescale each dictionary column of W to unit norm, compensating H.

    W @ H is invariant (``w_k -> w_k / s_k``, ``h_k -> h_k * s_k``); only the
    scale split moves.  ``norm`` is 'l1' (columns sum to 1), 'l2' or 'max'
    (peak-normalized spectra).  All-zero columns pass through unscaled.
    Host-side NumPy, byte-equal to ``nmf_tpu.normalize_factors``.
    """
    w = np.asarray(_host(w), np.float32)
    h = np.asarray(_host(h), np.float32)
    if norm == "l1":
        s = w.sum(axis=0)
    elif norm == "l2":
        s = np.sqrt((w * w).sum(axis=0))
    elif norm == "max":
        s = w.max(axis=0)
    else:
        raise ValueError(f"norm must be 'l1', 'l2' or 'max', got {norm!r}")
    s = np.where(s > 0, s, np.float32(1.0)).astype(np.float32)
    return w / s[None, :], h * s[:, None]


def _h_only_step_cost(config: SolveConfig):
    """(step, cost) of the H-only solve under ``config`` (``nmf.py:61-135``
    of the JAX package).

    KL without penalties: K1 for the step and K3 for the cost under
    :func:`~nmf_tpu_torch.models.solver._use_kernels` (both take the
    ``(codes, scales)`` pair themselves; per-row-block scales take the plain
    ops, or raise under ``backend="pallas"``).  K3 runs with
    ``matmul_dtype="float32"``: JAX's H-only cost has a true-f32 recon in
    every policy, and K3's ``bfloat16`` instance would round it.  The other
    families take plain ops on dequantized X.
    """
    eps, prec = config.eps, config.precision
    takes_pair = False
    if config.algorithm == "hals":
        def step(w, h, x):
            return w, hals._update_h_hals(w, h, x, eps, prec)

        def cost(x, w, h):
            return beta_divergence(x, w, h, 2.0, eps)

    elif config.beta == 1.0 and config.regularized:
        def step(w, h, x):
            return w, mu.update_h_kl_reg(w, h, x, eps, prec, config.l1_h, config.l2_h)

        def cost(x, w, h):
            hf = h.to(_F32)
            pen = (config.l1_h * torch.sum(torch.abs(hf))
                   + 0.5 * config.l2_h * torch.sum(hf * hf))
            return kl_divergence(x, w, h, eps) + pen

    elif config.beta == 1.0 and _use_kernels(config):
        cost_prec = dataclasses.replace(prec, matmul_dtype="float32")

        def step(w, h, x):
            return w, fused_mu.update_h_fused(w, h, x, eps, prec)

        def cost(x, w, h):
            return fused_mu.kl_cost_fused(x, w, h, eps, cost_prec)

        takes_pair = True
    elif config.beta == 1.0:
        def step(w, h, x):
            return w, mu.update_h(w, h, x, eps, prec)

        def cost(x, w, h):
            return kl_divergence(x, w, h, eps)

    else:
        def step(w, h, x):
            # the H half of mu_step_beta
            num, den = mu._beta_ratios(w, h, x, config.beta, eps, prec)
            h_num = mu.matmul(w, num, prec, transpose_a=True)
            h_den = eps_clamp(mu.matmul(w, den, prec, transpose_a=True), eps)
            return w, (h * (h_num / h_den)).to(h.dtype)

        def cost(x, w, h):
            return beta_divergence(x, w, h, config.beta, eps)

    if prec.x_dtype == "int8" and not takes_pair:
        step, cost = _dequant_wrap_step(step), _dequant_wrap_cost(cost)
    return step, cost


def solve_h_only(
    x, w, h0, config: SolveConfig = SolveConfig(), mesh=None, device="cuda"
) -> SolveResult:
    """Iterate only the H half-update with W fixed (NMF inference).

    The loop and convergence rule of :func:`~nmf_tpu_torch.solve`, and its
    load-time prep (clamp, casts, quantization; a ``(codes, scales)`` pair
    passes through); per iteration the reference's ``update_h``
    (nmf.cu:118-146) without the ``update_w`` after it.  ``device`` as in
    ``solve``; the factors of the result stay on it.

    With ``mesh`` the solve runs sharded over the canonical layout (W's row
    blocks fixed and replicated over 'mc', only K-sized products summed a
    step; every family, the KL step on plain ops as in JAX): each rank
    gets its blocks on the mesh's device (``device`` is not read), as
    :func:`~nmf_tpu_torch.parallel.sharded.solve_sharded` returns them.
    """
    config.validate()
    check_inputs(x, w, h0, config)
    if mesh is not None:
        from ..parallel.sharded import solve_h_only_sharded

        return solve_h_only_sharded(x, w, h0, config, mesh)
    dev = resolve_device(device)
    (m, k), n = _shape(w), _shape(h0)[1]
    config = resolve_config(config, m, k, n, dev, "h_only")
    step, cost = _h_only_step_cost(config)
    x, w, h0 = _prep(x, w, h0, config, True, dev)
    return run_checked_loop(x, w, h0, config, step, cost)


def _t(a) -> object:
    """The transpose of a tensor or array, made contiguous once."""
    if isinstance(a, torch.Tensor):
        return a.t().contiguous()
    return np.ascontiguousarray(np.asarray(a).T)


def solve_w_only(
    x, w0, h, config: SolveConfig = SolveConfig(), mesh=None, device="cuda"
) -> SolveResult:
    """Iterate only the W half-update with H fixed (dictionary adaptation).

    The H-only solve of the transposed problem, ``D(X || W H) = D(X^T ||
    H^T W^T)``: X^T, H^T and W0^T are made contiguous once, before the loop
    (the kernels take row-major operands), and the W and H penalties swap
    places (``nmf.py:255-297`` of the JAX package).  With ``mesh`` the
    transposed problem is sharded: ``res.w`` is this rank's block of W with
    its rows split over 'mc', ``res.h`` its block of H with its columns
    split over 'mr' (``gather_result(res, mesh, w_spec=(COL_AXIS, None),
    h_spec=(None, ROW_AXIS))``).
    """
    if isinstance(x, tuple):
        raise NotImplementedError(
            "solve_w_only transposes the problem, and per-column int8 scales "
            "do not transpose — pass the float X (it is quantized "
            "column-wise on the transposed orientation internally)"
        )
    if config.regularized:
        config = dataclasses.replace(
            config, l1_h=config.l1_w, l2_h=config.l2_w, l1_w=config.l1_h, l2_w=config.l2_h,
        )
    res = solve_h_only(_t(x), _t(h), _t(w0), config, mesh=mesh, device=device)
    if res is None:     # a rank outside the mesh
        return None
    return SolveResult(
        w=res.h.t().contiguous(),
        h=res.w.t().contiguous(),
        iterations=res.iterations,
        cost=res.cost,
        cost_history=res.cost_history,
        num_checks=res.num_checks,
        converged=res.converged,
        momentum=res.momentum,
    )


class NMF:
    """scikit-learn-style NMF estimator, ``nmf_tpu.NMF``'s counterpart.

    Parameters as ``nmf_tpu.NMF``: ``n_components`` (K), ``init`` ('random'
    | 'scaled' | 'nndsvd' | 'nndsvda' | 'nndsvdar'), ``beta_loss`` (2
    Frobenius, 1 KL, 0 Itakura-Saito, any float), ``max_iter``, ``tol`` (0:
    exactly ``max_iter`` iterations), ``check_every``, ``random_state``,
    ``precision``, ``backend``, ``solver`` ('mu', or 'cd'/'hals' for HALS),
    ``alpha_W`` / ``alpha_H`` / ``l1_ratio`` (sklearn's regularization
    scaling, KL-MU family) and ``accelerate``; plus ``device`` (``"cuda"``
    by default), and ``n_restarts`` (restarts in one batched solve, the
    lowest cost kept).  ``mesh`` (a ``DeviceMesh`` of
    :func:`~nmf_tpu_torch.make_mesh`) fits and transforms sharded over its
    ranks, each rank calling with the same data, and gathers the global
    ``w_`` and ``components_`` onto every rank; the mesh's device is used
    and ``device`` only by ``score``.

    In the X = W @ H orientation ``w_`` is W (M x K) and ``components_`` is
    H, both NumPy f32; ``reconstruction_err_`` is the raw final divergence
    (sklearn reports ``sqrt(2 D)``); ``n_iter_`` the iterations run.
    """

    def __init__(
        self,
        n_components: int,
        init: str = "nndsvda",
        beta_loss: float = 1.0,
        max_iter: int = 200,
        tol: float = 0.0,
        check_every: int = 25,
        random_state: int = 0,
        precision: Precision = Precision(),
        backend: str = "auto",
        solver: str = "mu",
        mesh=None,
        n_restarts: int = 1,
        alpha_W: float = 0.0,
        alpha_H="same",
        l1_ratio: float = 0.0,
        accelerate: bool = False,
        device="cuda",
    ):
        self.mesh = mesh
        self.accelerate = bool(accelerate)
        self.n_restarts = int(n_restarts)
        self.alpha_W = float(alpha_W)
        self.alpha_H = alpha_H
        self.l1_ratio = float(l1_ratio)
        self.n_components = int(n_components)
        self.init = init
        self.beta_loss = float(beta_loss)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.check_every = int(check_every)
        self.random_state = int(random_state)
        self.precision = precision
        self.backend = backend
        self.solver = {"cd": "hals"}.get(solver, solver)  # sklearn alias
        self.device = device
        self.components_: Optional[np.ndarray] = None
        self.w_: Optional[np.ndarray] = None
        self.reconstruction_err_: Optional[float] = None
        self.n_iter_: Optional[int] = None

    def _config(self, max_iter: Optional[int] = None, shape: Optional[tuple] = None) -> SolveConfig:
        # sklearn's regularization scaling (_nmf.py _compute_regularization):
        # samples are rows (M) and features columns (N) in X = W @ H, so the
        # W penalties scale with N and H's with M
        l1_w = l2_w = l1_h = l2_h = 0.0
        alpha_h = self.alpha_W if self.alpha_H == "same" else float(self.alpha_H)
        if shape is not None and (self.alpha_W or alpha_h):
            m, n = shape
            l1_w = n * self.alpha_W * self.l1_ratio
            l2_w = n * self.alpha_W * (1.0 - self.l1_ratio)
            l1_h = m * alpha_h * self.l1_ratio
            l2_h = m * alpha_h * (1.0 - self.l1_ratio)
        return SolveConfig(
            max_iter=self.max_iter if max_iter is None else max_iter,
            thresh=self.tol,
            check_every=self.check_every,
            precision=self.precision,
            backend=self.backend,
            beta=self.beta_loss,
            algorithm=self.solver,
            l1_w=l1_w, l2_w=l2_w, l1_h=l1_h, l2_h=l2_h,
            accelerate=self.accelerate,
        )

    def _init_factors(self, x: np.ndarray):
        m, n = x.shape
        k = self.n_components
        if self.init == "random":
            return random_init(m, k, n, seed=self.random_state)
        if self.init == "scaled":
            return scaled_random_init(x, k, seed=self.random_state)
        return nndsvd_init(x, k, variant=self.init, seed=self.random_state)

    def fit(self, x, w0=None, h0=None) -> "NMF":
        self.fit_transform(x, w0=w0, h0=h0)
        return self

    def fit_transform(self, x, w0=None, h0=None) -> np.ndarray:
        """Learn W and H for ``x``; returns W (the sample representation)."""
        x = np.asarray(_host(x), np.float32)
        if self.n_restarts > 1 and (w0 is not None or h0 is not None):
            raise ValueError(
                "n_restarts > 1 draws per-restart random inits — it cannot "
                "honor explicit w0/h0 templates (all restarts would be "
                "identical); pass n_restarts=1 or drop the templates"
            )
        if self.n_restarts > 1:
            return self._fit_restarts(x)
        if w0 is None or h0 is None:
            wi, hi = self._init_factors(x)
            w0 = wi if w0 is None else w0
            h0 = hi if h0 is None else h0
        if self.mesh is not None:
            from ..parallel.sharded import gather_result, solve_sharded

            res = self._on_mesh(solve_sharded(x, w0, h0, self._config(shape=x.shape),
                                              mesh=self.mesh))
            res = gather_result(res, self.mesh)
        else:
            res = solve(x, w0, h0, self._config(shape=x.shape), device=self.device)
        self.w_ = _host(res.w)
        self.components_ = _host(res.h)
        self.reconstruction_err_ = self._pure_err(x, float(res.cost))
        self.n_iter_ = int(res.iterations)
        return self.w_

    def _on_mesh(self, res):
        """A sharded solve's result, or ``ValueError`` on a rank beyond the
        mesh (it has no blocks to fit)."""
        if res is None:
            raise ValueError(f"this rank is outside the mesh {tuple(self.mesh.shape)}")
        return res

    def _fit_restarts(self, x: np.ndarray) -> np.ndarray:
        """All restarts in one batched solve; the lowest-cost fit is kept
        (``nmf_tpu/models/nmf.py:416-463``).  The deterministic nndsvd
        inits would make identical members: they take 'scaled' instead."""
        from .selection import solve_restarts

        init = self.init if self.init in ("random", "scaled", "nndsvdar") else "scaled"
        if init != self.init:
            import warnings

            warnings.warn(
                f"init={self.init!r} is deterministic and would make "
                f"identical restart members; using 'scaled' with seeds "
                f"{self.random_state}..{self.random_state + self.n_restarts - 1}",
                stacklevel=3,
            )
        mesh = self.mesh
        if mesh is not None:
            # restarts are pure data parallelism over members: the mesh's
            # ranks read as one member axis (nmf.py:439-450 of JAX)
            from ..parallel.mesh import FlatMesh, check_mesh

            mesh = FlatMesh(check_mesh(mesh), "members")
        sel = solve_restarts(x, rank=self.n_components, n_restarts=self.n_restarts,
                             config=self._config(shape=x.shape), seed=self.random_state,
                             init=init, mesh=mesh, device=self.device)
        best = sel.best_index
        w_b, h_b = sel.factors(best)
        self.w_ = _host(w_b)
        self.components_ = _host(h_b)
        self.reconstruction_err_ = self._pure_err(x, sel.best_cost)
        self.n_iter_ = int(sel.iterations[best])
        return self.w_

    def _pure_err(self, x: np.ndarray, solver_cost: float) -> float:
        """sklearn's ``reconstruction_err_`` is the pure beta-divergence: with
        regularization on, the solver's cost holds the penalties, so the
        divergence is taken again from the fitted factors."""
        alpha_h = self.alpha_W if self.alpha_H == "same" else float(self.alpha_H)
        if not self.alpha_W and not alpha_h:
            return solver_cost
        return -self.score(x)

    def transform(
        self,
        x,
        h0=None,
        max_iter: Optional[int] = None,
        out_of_core: bool = False,
        mask=None,
    ) -> np.ndarray:
        """Solve for H against the learned W, for new columns of data.

        ``x`` is (M, N_new) and the result H_new (K, N_new).  Without
        ``h0``, H starts from ``RandomState(random_state).rand(K, N_new)``,
        as in JAX.  With ``out_of_core`` the columns stream from the host
        (:func:`~nmf_tpu_torch.transform_out_of_core`): ``x`` may also be a
        ``.bin`` path or a memmap.  ``mask`` (X's shape; 0 = missing) lets
        only the observed entries drive the fit
        (:func:`~nmf_tpu_torch.solve_masked_h_only`; with ``out_of_core`` it
        streams beside X).
        """
        if self.w_ is None:
            raise RuntimeError("transform() before fit()")
        if out_of_core:
            from .streaming import _as_source, transform_out_of_core

            # the regularization scaling takes the global dims
            shape = _as_source(x).shape
            res = transform_out_of_core(
                x, self.w_, h0=h0, config=self._config(max_iter, shape=shape),
                mesh=self.mesh, seed=self.random_state, mask=mask, device=self.device,
            )
            if self.mesh is not None:
                self._on_mesh(res)
            return res.h
        x = np.asarray(_host(x), np.float32)
        if h0 is None:
            rng = np.random.RandomState(self.random_state)
            h0 = rng.rand(self.n_components, x.shape[1]).astype(np.float32)
        config = self._config(max_iter, shape=x.shape)
        if mask is not None:
            from .masked import solve_masked_h_only

            res = solve_masked_h_only(x, self.w_, h0, np.asarray(_host(mask), np.float32),
                                      config, mesh=self.mesh, device=self.device)
        else:
            res = solve_h_only(x, self.w_, h0, config, mesh=self.mesh, device=self.device)
        if self.mesh is not None:
            from ..parallel.sharded import gather_result

            res = gather_result(self._on_mesh(res), self.mesh)
        return _host(res.h)

    def inverse_transform(self, h) -> np.ndarray:
        if self.w_ is None:
            raise RuntimeError("inverse_transform() before fit()")
        return np.asarray(self.w_ @ np.asarray(_host(h), np.float32))

    def score(self, x, y=None) -> float:
        """Negative divergence of the fit (higher is better, sklearn-style),
        on ``device``; ``y`` is accepted and ignored."""
        dev = resolve_device(self.device)
        xt = eps_clamp(torch.as_tensor(np.asarray(_host(x), np.float32), device=dev))
        d = beta_divergence(xt, torch.as_tensor(self.w_, device=dev),
                            torch.as_tensor(self.components_, device=dev), self.beta_loss)
        return -float(d)

    # -- sklearn estimator protocol (clone / GridSearchCV / Pipeline) ------
    # every __init__ parameter, by its __init__ name
    _param_names = (
        "n_components", "init", "beta_loss", "max_iter", "tol",
        "check_every", "random_state", "precision", "backend", "solver",
        "mesh", "n_restarts", "alpha_W", "alpha_H", "l1_ratio", "accelerate",
        "device",
    )

    def get_params(self, deep: bool = True) -> dict:
        """All constructor parameters (``sklearn.base.clone`` contract);
        ``solver`` comes back normalized ('cd' is stored as 'hals')."""
        return {name: getattr(self, name) for name in self._param_names}

    def set_params(self, **params) -> "NMF":
        for name, value in params.items():
            if name not in self._param_names:
                raise ValueError(
                    f"invalid parameter {name!r} for NMF; valid: "
                    f"{sorted(self._param_names)}"
                )
            if name == "solver":
                value = {"cd": "hals"}.get(value, value)
            setattr(self, name, value)
        return self

    def __sklearn_tags__(self):
        # sklearn >= 1.6 asks estimators for capability tags; BaseEstimator's
        # defaults, unbound (sklearn stays an optional dependency, imported
        # only here)
        from sklearn.base import BaseEstimator

        tags = BaseEstimator.__sklearn_tags__(self)
        tags.estimator_type = None  # unsupervised transformer
        tags.input_tags.positive_only = True
        return tags
