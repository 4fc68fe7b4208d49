"""Reparameterised Gaussian sampling.

Counterpart of ``ffvd_tpu/ops/sampling.py`` (the reference's ``utils.py``
``get_rand``, :4-11): a draw from N(mean, var) given a diagonal variance
(N, D) or a full covariance (D, N, N), with the reference's 1e-7 Cholesky
jitter.  The normals come from the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ffvd_tpu_torch.ops.chol import psd_cholesky


def get_rand(generator: Optional[torch.Generator], mean: torch.Tensor,
             var: torch.Tensor, full_cov: bool = False) -> torch.Tensor:
    """mean (N, D); var (N, D) diagonal or (D, N, N) full covariance."""
    if full_cov:
        n = mean.shape[0]
        eye = torch.eye(n, dtype=mean.dtype, device=mean.device)
        chol = psd_cholesky(var + 1e-7 * eye)
        eps = torch.randn((var.shape[0], n), generator=generator,
                          dtype=mean.dtype, device=mean.device)
        return mean + torch.einsum("dnm,dm->nd", chol, eps)
    eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                      device=mean.device)
    return mean + eps * torch.sqrt(var)
