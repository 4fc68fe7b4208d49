"""Log-priors for the free-form ELBO.

Counterpart of ``ffvd_tpu/model/priors.py``: dgp_model.py:105-143 (Layer
priors), :252 (x₀), :326-334 (hyperparameter prior) and the Strauss process
(dgp_model.py:18-43).  ``determinantal`` is a per-dim sum of log-determinants.
"""

from __future__ import annotations

import math

import torch

from ffvd_tpu_torch.ops import chol as cholops
from ffvd_tpu_torch.ops import kernels as kops
from ffvd_tpu_torch.ops.kernels import KernelParams

_LOG_005 = math.log(0.05)


def strauss_logp(z: torch.Tensor, gamma: float = 0.5,
                 radius: float = 0.5) -> torch.Tensor:
    """Strauss point-process prior: (#pairs with dist ≤ R) · log γ
    (dgp_model.py:24-42; R=0.5 fixed at dgp_model.py:74)."""
    zs = torch.sum(z * z, dim=-1, keepdim=True)
    d2 = zs + zs.T - 2.0 * (z @ z.T)
    dist = torch.sqrt(torch.clamp(d2, min=1e-40))
    n_close = torch.sum(dist <= radius).to(z.dtype)
    n_pairs = (n_close - z.shape[0]) / 2.0
    return n_pairs * math.log(gamma)


def prior_z(prior_type: str, kernel_type: str, kparams: KernelParams,
            z: torch.Tensor, det_jitter: float = 1e-7) -> torch.Tensor:
    """Inducing-input prior (dgp_model.py:105-121)."""
    if prior_type == "uniform":
        return torch.zeros((), dtype=z.dtype, device=z.device)
    if prior_type == "normal":
        return -0.5 * torch.sum(z * z)
    if prior_type == "strauss":
        return strauss_logp(z)
    if prior_type == "determinantal":
        kzz = kops.gram(kernel_type, kparams, z)
        eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
        lm = cholops.psd_cholesky(kzz + det_jitter * eye)
        return torch.sum(cholops.chol_logdet(lm))
    raise ValueError(f"invalid prior type {prior_type!r}")


def prior_hyper(kernel_type: str, kparams: KernelParams) -> torch.Tensor:
    """Kernel hyperprior: N(0,1) on log-lengthscales, N(log 0.05, 1) on
    log-variance (dgp_model.py:123-130)."""
    out = -0.5 * torch.sum(torch.square(kparams.log_variance - _LOG_005))
    if kernel_type == "SquaredExponential":
        out = out - 0.5 * torch.sum(torch.square(kparams.log_lengthscales))
    return out


def prior_u(u: torch.Tensor) -> torch.Tensor:
    """Whitened inducing-output prior N(0, I) (dgp_model.py:132-135)."""
    return -0.5 * torch.sum(u * u)


def prior_x0(x0: torch.Tensor) -> torch.Tensor:
    """Initial-state prior N(0, I) (dgp_model.py:252)."""
    return -0.5 * torch.sum(x0 * x0)


def log_q_prior(log_q) -> torch.Tensor:
    """The N(0,1) prior on log Q (dgp_model.py:326-334): a sum over the
    latent dims."""
    return -0.5 * torch.sum(torch.square(log_q))


def emission_prior(c, d, log_rchol) -> torch.Tensor:
    """The N(0,1) priors on C, d and log Rchol (dgp_model.py:326-334)."""
    return (-0.5 * torch.sum(torch.square(c))
            - 0.5 * torch.sum(torch.square(d))
            - 0.5 * torch.sum(torch.square(log_rchol)))
