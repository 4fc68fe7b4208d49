"""Gaussian log-density trio.

Counterpart of ``ffvd_tpu/ops/densities.py``.  Like the reference
(likelihoods.py:89-127) these densities OMIT the −½·log(2π) constant per
dimension: the free-form ELBO is assembled from them, and the golden values
only match with the constant left out.
"""

from __future__ import annotations

import math

import torch

LOG_2PI_HALF = 0.5 * math.log(2.0 * math.pi)


def logdensity_norm_diag_nonvec(y: torch.Tensor, ymean: torch.Tensor,
                                rchol_diag: torch.Tensor) -> torch.Tensor:
    """Elementwise un-normalised Normal log density (likelihoods.py:89-93).

    y, ymean: (..., D); rchol_diag: (D,) std-devs → (..., D)."""
    z = (y - ymean) / rchol_diag
    return -0.5 * z * z - torch.log(rchol_diag)


def logdensity_norm_diag(y: torch.Tensor, ymean: torch.Tensor,
                         rchol_diag: torch.Tensor) -> torch.Tensor:
    """Row-wise un-normalised diagonal-Normal log density
    (likelihoods.py:96-111).  y, ymean: (N, D); rchol_diag: (D,) → (N,)."""
    z = (y - ymean) / rchol_diag
    return -0.5 * torch.sum(z * z, dim=-1) - torch.sum(torch.log(rchol_diag))


def logdensity_norm(y: torch.Tensor, ymean: torch.Tensor,
                    rchol: torch.Tensor) -> torch.Tensor:
    """Row-wise un-normalised full-covariance Normal log density with lower
    Cholesky ``rchol`` (likelihoods.py:114-127).  (N, D), (D, D) → (N,)."""
    diff = (y - ymean).to(rchol.dtype)                     # (N, D)
    a = torch.linalg.solve_triangular(torch.tril(rchol), diff.T,
                                      upper=False)          # (D, N)
    exp_term = -0.5 * torch.sum(a * a, dim=0)
    logdet = -torch.sum(torch.log(torch.diagonal(rchol)))
    return exp_term + logdet
