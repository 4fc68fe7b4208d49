"""Posterior collection and free-running rollout prediction.

Counterpart of ``ffvd_tpu/eval/rollout.py`` (rebuild of
``collect_samples_formal``, base_model.py:197-522).  Per sample (reference
semantics):

  - (if SG-HMC leaves exist) run ``spacing`` sample-only SG-HMC updates,
    continuing the chain, then factorise that sample's Kmm (:227-234);
  - (if U collapsed) compute q(U) = N(H⁻¹a, H⁻¹) from the training
    trajectory (:242-253);
  - free-run from the last training state x_N (:237): per step
    x ← x + f_mu + N(0, f_var + Q) (:296-302), recording x and f_var + Q.

Without SG-HMC leaves (C1, C4, C6) the samples are iid and share one set
of parameters: one ``ops.rollout.rollout`` call.  With them (C2, C3, C5,
C7, hyperparameter sampling) each sample has its own hypers, Z, U or q(U),
Q and x_N, and all S go to one ``ops.rollout.rollout_batched`` call.  On
the card either is one launch of the CUDA kernel.

The kernel is SE-ARD and shallow only, as the JAX package's Pallas rollout
is (pallas_rollout.py:148).  A LinearK config and a deep one
(``cfg.n_layers > 1``) take ``recursion_rollout``, a torch recursion of
``gp_transition`` (after ``model.deep.propagate_step`` through the hidden
layers, for a deep model): the port of the JAX package's production
rollout, a ``lax.scan`` of the same step.  ``cfg.kernel_type`` and
``cfg.n_layers`` alone choose the path.

Under ``cfg.collapse_precision`` "ds64" or "hybrid", for every case and
both paths, the head's Kmm factors come from ``ds_precal`` and a collapsed
q(U) from ``ds_collapsed_u_posterior`` (the float64 segment,
``model/ds_collapse.py``), as JAX's ``_rollout_one(ds64=...)`` does: at the
sharply trained points that mode reaches, fp32 factors of H inflate the
rollout variance (PARITY §2f).  They are float32, promoted to the params'
dtype in an fp64 run.

Metrics (base_model.py:340-349, :629):
  ŷ   = mean_samples(x C) + d,   v̂ = mean_samples(x_var C²) + R
  RMSE = sqrt(mean((Y_test[:30] − ŷ[:30])²)) · Y_train_std
  NLL  = −mean log N(y; ŷ, sqrt(v̂)) over the same 30 steps (normalised).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from ffvd_tpu_torch.inference.trainer import Trainer, TrainState
from ffvd_tpu_torch.model.conditionals import (Precal, collapsed_u_posterior,
                                               gp_transition, kernel_precal)
from ffvd_tpu_torch.model.deep import (hidden_normals, hidden_precals,
                                       propagate_step)
from ffvd_tpu_torch.model.ds_collapse import (ds_collapsed_u_posterior,
                                              ds_precal)
from ffvd_tpu_torch.model.elbo import gp_inputs
from ffvd_tpu_torch.model.likelihoods import emission_mean, use_full_r
from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
from ffvd_tpu_torch.ops import rollout as rollout_ops
from ffvd_tpu_torch.ops.kernels import KernelParams


def _ds64(cfg) -> bool:
    """Does evaluation take the float64 segment (rollout.py:122-129)?"""
    return cfg.collapse_precision in ("ds64", "hybrid")


def rollout_precal(cfg, params: GPSSMParams) -> Precal:
    """The head's Kmm factors for the rollout: ``ds_precal``'s under
    ds64/hybrid (float32, promoted to the params' dtype), else
    ``kernel_precal``'s."""
    if not _ds64(cfg):
        return kernel_precal(cfg.kernel_type, params.kernel, params.z,
                             cfg.jitter)
    pre = ds_precal(cfg.kernel_type, params.kernel, params.z, cfg.jitter)
    return Precal(lm=pre.lm.to(params.z.dtype),
                  lm_inv=pre.lm_inv.to(params.z.dtype))


def u_and_qsqrt(trainer: Trainer, params: GPSSMParams, data: SSMData,
                pre: Precal):
    """(U, q_sqrt) for the rollout: the collapsed q(U) mean and its upper
    factor chol(H)⁻ᵀ, or the trained U and None when U is not collapsed.
    A deep model's training inputs are mean-propagated through its hidden
    layers: the collapse is a point summary (rollout.py:131-161).  ``pre``
    is read by the native collapse only; under ds64/hybrid the float64
    segment factorises Kmm itself."""
    cfg = trainer.cfg
    if not cfg.case_config.u_collapse:
        return params.u, None
    xc = gp_inputs(params, data, kernel_type=cfg.kernel_type,
                   jitter=cfg.jitter)
    if _ds64(cfg):
        u_val, q_sqrt = ds_collapsed_u_posterior(
            cfg.kernel_type, params.kernel, params.z, params.x, xc,
            params.log_q, jitter=cfg.jitter)
        u_val, q_sqrt = u_val.to(params.z.dtype), q_sqrt.to(params.z.dtype)
    else:
        u_val, q_sqrt = collapsed_u_posterior(
            cfg.kernel_type, params.kernel, pre, params.z, params.x, xc,
            params.q)
    if cfg.rollout_qsqrt_dim0:
        # reference slip compat (conditionals_multi_output.py:322): dim 0's
        # q(U) factor applied to every dim's variance
        q_sqrt = q_sqrt[:1].expand(q_sqrt.shape)
    return u_val, q_sqrt


def thin_posterior(trainer: Trainer, state: TrainState, num: int,
                   spacing: int, generator: Optional[torch.Generator] = None,
                   thin_noise: Optional[Dict[str, torch.Tensor]] = None,
                   thin_prop: Optional[List[torch.Tensor]] = None):
    """Continue the SG-HMC chain: per sample, ``spacing`` sample-only
    sub-steps of the SG-HMC leaves (base_model.py:227-231), full batch.  A
    deep (stochastic) trainer draws fresh inter-layer normals for every
    sub-step's gradient, as training does (rollout.py:176-209).
    ``thin_noise`` (path → (num, spacing, ...)) and ``thin_prop`` (one
    (num, spacing, N, D) tensor per hidden layer) replace the normals drawn
    from ``generator``.  Returns (the ``num`` thinned params, the state
    with the moved chain).  A ``parallel.BatchedTrainer`` thins every
    member at once on the batched gradient; its state, samples and
    injected normals carry the member axis first; a process of a sharded
    run keeps its share of each draw (``Trainer._share``)."""
    subset = trainer.subset
    params = state.params
    sub = {k: v.detach() for k, v in subset.split(params).items()}
    sstate = state.sghmc
    n_hidden = len(params.hidden)
    lead = trainer.lead
    pick = lambda v, i, j: v[(slice(None),) * len(lead) + (i, j)]
    samples = []
    for i in range(num):
        for j in range(spacing):
            nz = (None if thin_noise is None
                  else trainer._share_tree({k: pick(v, i, j)
                                            for k, v in thin_noise.items()}))
            eps = None
            if trainer.stochastic:
                eps = [trainer._share(p) for p in (
                    [pick(p, i, j) for p in thin_prop]
                    if thin_prop is not None else hidden_normals(
                        n_hidden,
                        trainer._whole_lead() + (params.x.shape[-2] - 1,),
                        params.x.shape[-1], generator, params.x.dtype,
                        params.x.device))]
            sub, sstate = trainer.sghmc_move(sub, sstate, params, False, nz,
                                             generator, eps=eps)
        samples.append(subset.merge(sub, params))
    return samples, dataclasses.replace(
        state, params=subset.merge(sub, params), sghmc=sstate)


def posterior_inputs(trainer: Trainer, samples: List[GPSSMParams]) -> dict:
    """The rollout's per-sample inputs, stacked on a leading sample axis:
    each sample's Kmm factorisation, its U (or collapsed q(U)), Q and x_N."""
    cfg = trainer.cfg
    cols = {k: [] for k in ("log_variance", "log_lengthscales", "z",
                            "lm_inv", "u_val", "q_sqrt", "q", "x0")}
    for p in samples:
        pre = rollout_precal(cfg, p)
        u_val, q_sqrt = u_and_qsqrt(trainer, p, trainer.data, pre)
        for k, v in (("log_variance", p.kernel.log_variance),
                     ("log_lengthscales", p.kernel.log_lengthscales),
                     ("z", p.z), ("lm_inv", pre.lm_inv), ("u_val", u_val),
                     ("q_sqrt", q_sqrt), ("q", p.q), ("x0", p.x[-1])):
            cols[k].append(v)
    out = {k: None if v[0] is None else torch.stack(v).detach()
           for k, v in cols.items()}
    out["kparams"] = KernelParams(out.pop("log_variance"),
                                  out.pop("log_lengthscales"))
    return out


def rollout_controls(data: SSMData, test_len: int) -> torch.Tensor:
    """The controls of the first ``test_len`` test steps, zero-padded when
    the control series is shorter."""
    n_train = data.y.shape[0]
    controls = data.control[n_train:n_train + test_len]
    if controls.shape[0] < test_len:
        pad = controls.new_zeros((test_len - controls.shape[0],
                                  controls.shape[1]))
        controls = torch.cat([controls, pad], dim=0)
    return controls.contiguous()


def recursion_rollout(trainer: Trainer, params: GPSSMParams,
                      controls: torch.Tensor, noise: torch.Tensor,
                      hidden_noise: Optional[List[torch.Tensor]] = None):
    """Rollouts of one parameter set by the torch recursion of
    ``gp_transition`` (the step of ``ffvd_tpu/eval/rollout.py::
    _rollout_one``), S = noise.shape[0] rows from x_N sharing its Kmm
    factor, U or q(U) and Q.  noise (S, T, D), the head's normals.  A deep
    model first propagates each step's state through its hidden layers
    (``propagate_step``, the layers' Kmm factorised once), with
    ``hidden_noise``, one (S, T, D) tensor per hidden layer; the identity
    skip stays on x_t.  Returns (xs, var_tot), each (S, T, D)."""
    cfg = trainer.cfg
    pre = rollout_precal(cfg, params)
    u_val, q_sqrt = u_and_qsqrt(trainer, params, trainer.data, pre)
    hpre = hidden_precals(cfg.kernel_type, cfg.jitter, params.hidden)
    q = params.q
    x = params.x[-1][None, :].expand(noise.shape[0], -1)
    xs, vs = [], []
    for t in range(controls.shape[0]):
        h = None
        if params.hidden:
            h = propagate_step(cfg.kernel_type, cfg.jitter, params.hidden,
                               hpre, x, controls[t],
                               [e[:, t] for e in hidden_noise])
        x, v = gp_transition(cfg.kernel_type, params.kernel, pre, params.z,
                             u_val, q, x, controls[t], noise[:, t], q_sqrt,
                             h_t=h)
        xs.append(x)
        vs.append(v)
    return torch.stack(xs, dim=1), torch.stack(vs, dim=1)


@torch.no_grad()
def collect_posterior(trainer: Trainer, state: TrainState, test_len: int,
                      num: Optional[int] = None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      thin_noise: Optional[Dict[str, torch.Tensor]] = None,
                      thin_generator: Optional[torch.Generator] = None,
                      hidden_noise: Optional[List[torch.Tensor]] = None,
                      thin_prop: Optional[List[torch.Tensor]] = None):
    """Draw ``num`` posterior predictive trajectories of ``test_len`` steps.

    Without SG-HMC leaves the samples are iid: one q(U) summary, one
    ``rollout`` call.  With them the chain is thinned first
    (``thin_posterior``, normals from ``thin_generator`` or ``thin_noise``
    and ``thin_prop``) and the S samples' own parameters go to one
    ``rollout_batched`` call.  A LinearK or deep config rolls out by
    ``recursion_rollout`` instead: once for the iid samples, once a sample
    for a thinned chain.  ``generator`` draws the rollout's Philox seed
    (kernel) or normals (recursion); ``noise`` (num, test_len, D) and, for
    a deep model, ``hidden_noise`` (one (num, test_len, D) tensor per
    hidden layer), when given, replace that noise.  Returns (predict_x
    (S, T, D), predict_x_var (S, T, D), the state with the moved chain)."""
    cfg = trainer.cfg
    num = num or cfg.num_posterior_samples
    controls = rollout_controls(trainer.data, test_len)
    x = state.params.x
    recursion = (cfg.kernel_type != "SquaredExponential"
                 or cfg.n_layers > 1)
    if recursion and noise is None:
        noise = hidden_normals(1, (num, test_len), x.shape[1], generator,
                               x.dtype, x.device)[0]
    if recursion and hidden_noise is None and state.params.hidden:
        hidden_noise = hidden_normals(len(state.params.hidden),
                                      (num, test_len), x.shape[1],
                                      generator, x.dtype, x.device)
    if trainer.has_sghmc:
        samples, state = thin_posterior(
            trainer, state, num, cfg.posterior_sample_spacing,
            thin_generator, thin_noise, thin_prop)
        if recursion:
            rolls = [recursion_rollout(
                trainer, p, controls, noise[i:i + 1],
                None if hidden_noise is None
                else [e[i:i + 1] for e in hidden_noise])
                for i, p in enumerate(samples)]
            return (torch.cat([r[0] for r in rolls]),
                    torch.cat([r[1] for r in rolls]), state)
        inp = posterior_inputs(trainer, samples)
        xs, vs = rollout_ops.rollout_batched(
            controls=controls, noise=noise, generator=generator, **inp)
        return xs, vs, state
    params = state.params
    if recursion:
        return (*recursion_rollout(trainer, params, controls, noise,
                                   hidden_noise), state)
    pre = rollout_precal(cfg, params)
    u_val, q_sqrt = u_and_qsqrt(trainer, params, trainer.data, pre)
    xs, vs = rollout_ops.rollout(
        params.kernel, params.z, pre.lm_inv, u_val, q_sqrt, params.q,
        params.x[-1], controls, num, noise=noise, generator=generator)
    return xs, vs, state


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
