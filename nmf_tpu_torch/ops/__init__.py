"""Plain torch ops and the CUDA kernels of the MU hot path."""

from .divergence import (
    beta_divergence,
    euclidean_cost,
    itakura_saito,
    kl_divergence,
    kl_divergence_from_recon,
)
from .elementwise import EPS, element_divide, element_multiply, eps_clamp
from .hals import cd_sweep_h, cd_sweep_w, hals_step
from .mu import matmul, mu_step, mu_step_beta, mu_step_kl_reg, update_h, update_w

__all__ = [
    "EPS",
    "beta_divergence",
    "cd_sweep_h",
    "cd_sweep_w",
    "element_divide",
    "element_multiply",
    "eps_clamp",
    "euclidean_cost",
    "hals_step",
    "itakura_saito",
    "kl_divergence",
    "kl_divergence_from_recon",
    "matmul",
    "mu_step",
    "mu_step_beta",
    "mu_step_kl_reg",
    "update_h",
    "update_w",
]
