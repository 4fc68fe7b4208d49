"""Posterior collection and free-running rollout prediction.

Counterpart of ``ffvd_tpu/eval/rollout.py`` (rebuild of
``collect_samples_formal``, base_model.py:197-522), iid branch: for cases
without SG-HMC leaves the posterior samples are independent, so one q(U)
summary feeds S rollouts, all computed by one call of
``ops.rollout.rollout`` (the CUDA kernel on the card).  The SG-HMC thinning
branch waits for ROADMAP Queue 1 item 6.

Per sample: (if U collapsed) q(U) = N(H⁻¹a, H⁻¹) from the training
trajectory (:242-253); free-run from the last training state x_N (:237):
per step x ← x + f_mu + N(0, f_var + Q) (:296-302), recording x and
f_var + Q.

Metrics (base_model.py:340-349, :629):
  ŷ   = mean_samples(x C) + d,   v̂ = mean_samples(x_var C²) + R
  RMSE = sqrt(mean((Y_test[:30] − ŷ[:30])²)) · Y_train_std
  NLL  = −mean log N(y; ŷ, sqrt(v̂)) over the same 30 steps (normalised).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.conditionals import (Precal, collapsed_u_posterior,
                                               kernel_precal)
from ffvd_tpu_torch.model.elbo import gp_inputs
from ffvd_tpu_torch.model.likelihoods import emission_mean, use_full_r
from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
from ffvd_tpu_torch.ops import rollout as rollout_ops


def u_and_qsqrt(trainer: Trainer, params: GPSSMParams, data: SSMData,
                pre: Precal):
    """(U, q_sqrt) for the rollout: the collapsed q(U) mean and its upper
    factor chol(H)⁻ᵀ, or the trained U and None when U is not collapsed."""
    cfg = trainer.cfg
    if not cfg.case_config.u_collapse:
        return params.u, None
    u_val, q_sqrt = collapsed_u_posterior(
        cfg.kernel_type, params.kernel, pre, params.z, params.x,
        gp_inputs(params, data), params.q)
    if cfg.rollout_qsqrt_dim0:
        # reference slip compat (conditionals_multi_output.py:322): dim 0's
        # q(U) factor applied to every dim's variance
        q_sqrt = q_sqrt[:1].expand(q_sqrt.shape)
    return u_val, q_sqrt


@torch.no_grad()
def collect_posterior(trainer: Trainer, params: GPSSMParams, test_len: int,
                      num: Optional[int] = None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
    """Draw ``num`` posterior predictive trajectories of ``test_len`` steps.

    ``noise`` (num, test_len, D), when given, replaces the drawn noise.
    Returns (predict_x (S, T, D), predict_x_var (S, T, D))."""
    cfg = trainer.cfg
    num = num or cfg.num_posterior_samples
    data = trainer.data
    if cfg.kernel_type != "SquaredExponential":
        raise NotImplementedError(
            "the rollout kernel is SE-ARD only; a LinearK rollout is not "
            "ported yet (ROADMAP Queue 1, item 5)")
    n_train = data.y.shape[0]
    controls = data.control[n_train:n_train + test_len]
    if controls.shape[0] < test_len:  # control shorter than test
        pad = controls.new_zeros((test_len - controls.shape[0],
                                  controls.shape[1]))
        controls = torch.cat([controls, pad], dim=0)
    pre = kernel_precal(cfg.kernel_type, params.kernel, params.z, cfg.jitter)
    u_val, q_sqrt = u_and_qsqrt(trainer, params, data, pre)
    return rollout_ops.rollout(
        params.kernel, params.z, pre.lm_inv, u_val, q_sqrt, params.q,
        params.x[-1], controls.contiguous(), num, noise=noise,
        generator=generator)


def predict_summary(params: GPSSMParams, predict_x: torch.Tensor,
                    predict_x_var: torch.Tensor,
                    emission_noise: str = "auto"):
    """ŷ, v̂, and the training fit (base_model.py:334-343).  In diag mode the
    strictly-lower log_rchol entries are not part of the trained density and
    do not enter the predictive variance."""
    c, d = params.c, params.d
    y_s = predict_x @ c + d                           # (S, T, P)
    v_s = predict_x_var @ (c * c)                     # (S, T, P)
    if use_full_r(emission_noise, params.c.shape[1]):
        r2 = params.r_var_diag                        # diag(L·Lᵀ)
    else:
        r2 = params.rchol_diag ** 2                   # exp(2·diag log_rchol)
    predict_y = torch.mean(y_s, dim=0)
    predict_y_var = torch.mean(v_s, dim=0) + r2
    fit_y = emission_mean(params.x[1:], c, d)
    return predict_y, predict_y_var, fit_y


def rmse_nll(y_test: torch.Tensor, predict_y: torch.Tensor,
             predict_y_var: torch.Tensor, y_train_std: float,
             horizon: int = 30):
    """RMSE/NLL on the first ``horizon`` test steps (base_model.py:345-349,
    :629); the NLL uses the normalised Normal logpdf like scipy."""
    yt = y_test[:horizon].reshape(-1)
    yp = predict_y[:horizon].reshape(-1)
    vp = predict_y_var[:horizon].reshape(-1)
    rmse = torch.sqrt(torch.mean((yt - yp) ** 2)) * y_train_std
    nll = -torch.mean(-0.5 * torch.log(2 * math.pi * vp)
                      - 0.5 * (yt - yp) ** 2 / vp)
    return rmse, nll
