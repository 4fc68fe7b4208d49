"""Emission likelihoods.

Counterpart of ``ffvd_tpu/model/likelihoods.py``: the linear-Gaussian
observation model y = x·C + d (likelihoods.py:76-79), and the
probit-Bernoulli likelihood with its Gauss-Hermite expectation
(likelihoods.py:129-186), kept for API parity: the GP-SSM path does not
use it.
"""

from __future__ import annotations

import math

import torch

from ffvd_tpu_torch.ops.densities import logdensity_norm, logdensity_norm_diag
from ffvd_tpu_torch.ops.quadrature import ndiagquad


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


def inv_probit(x: torch.Tensor) -> torch.Tensor:
    """Probit link with 1e-3 jitter (likelihoods.py:129-131)."""
    jitter = 1e-3
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0))) \
        * (1 - 2 * jitter) + jitter


class Bernoulli:
    """Probit-Bernoulli likelihood (likelihoods.py:134-186)."""

    def __init__(self, num_gauss_hermite_points: int = 20):
        self.num_gauss_hermite_points = num_gauss_hermite_points

    def logdensity(self, x, p):
        return torch.log(torch.where(x == 1, p, 1 - p))

    def logp(self, f, y):
        return self.logdensity(y, inv_probit(f))

    def conditional_mean(self, f):
        return inv_probit(f)

    def conditional_variance(self, f):
        p = self.conditional_mean(f)
        return p - torch.square(p)

    def predict_mean_and_var(self, fmu, fvar):
        p = inv_probit(fmu / torch.sqrt(1 + fvar))
        return p, p - torch.square(p)

    def predict_density(self, fmu, fvar, y):
        p = self.predict_mean_and_var(fmu, fvar)[0]
        return self.logdensity(y, p)

    def variational_expectations(self, fmu, fvar, y):
        """∫ log p(y|f) N(f; fmu, fvar) df by Gauss-Hermite
        (likelihoods.py:169-185)."""
        return ndiagquad(lambda f, Y: self.logp(f, Y),
                         self.num_gauss_hermite_points, fmu, fvar, Y=y)
