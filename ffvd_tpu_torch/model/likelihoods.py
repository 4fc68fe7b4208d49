"""Emission likelihoods.

Counterpart of ``ffvd_tpu/model/likelihoods.py``: the linear-Gaussian
observation model y = x·C + d (likelihoods.py:76-79).  The probit-Bernoulli
likelihood is not ported yet (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

import torch

from ffvd_tpu_torch.ops.densities import logdensity_norm, logdensity_norm_diag


def emission_mean(x: torch.Tensor, c: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """ŷ = x C + d; x: (..., D), c: (D, P), d: (P,) → (..., P)."""
    return x @ c + d


def use_full_r(emission_noise: str, p_dim: int) -> bool:
    """Does this emission mode use the full lower-Cholesky R?  ("auto": full
    iff P > 1.)"""
    return emission_noise == "full" or (emission_noise == "auto"
                                        and p_dim > 1)


def emission_log_lik_rows(params, y: torch.Tensor, y_mean: torch.Tensor,
                          emission_noise: str) -> torch.Tensor:
    """Row-wise emission log density under the configured noise model:
    full-Cholesky (likelihoods.py:114-127) or diagonal (:96-111).
    (N, P) → (N,)."""
    if use_full_r(emission_noise, params.c.shape[1]):
        return logdensity_norm(y, y_mean, params.rchol)
    return logdensity_norm_diag(y, y_mean, params.rchol_diag)
