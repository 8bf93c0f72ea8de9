"""VolSDF Laplace-CDF density and NeRF++ background density.

Counterpart of `multiply_tpu/ops/density.py`.
"""

from __future__ import annotations

import torch

BETA_MIN = 1e-4


def laplace_beta(beta_param: torch.Tensor, beta_min: float = BETA_MIN) -> torch.Tensor:
    return beta_param.abs() + beta_min


def laplace_density(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """sigma(sdf) = (1/beta) * Laplace(0, beta).cdf(-sdf), written with expm1."""
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() / beta))


def abs_density(x: torch.Tensor) -> torch.Tensor:
    return x.abs()
