"""Plain torch ops and the CUDA kernels of the MU hot path."""

from .divergence import kl_divergence, kl_divergence_from_recon
from .elementwise import EPS, eps_clamp
from .mu import matmul, mu_step, update_h, update_w

__all__ = [
    "EPS",
    "eps_clamp",
    "kl_divergence",
    "kl_divergence_from_recon",
    "matmul",
    "mu_step",
    "update_h",
    "update_w",
]
