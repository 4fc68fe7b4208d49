"""The negative free-form ELBO, collapsed and uncollapsed.

Counterpart of ``ffvd_tpu/model/elbo.py::elbo_terms`` (objective assembly of
``DGPSSM.__init__``, dgp_model.py:248-297, and ``regularizer``,
dgp_model.py:337-359).  Term names match the reference's tensors so per-term
golden values line up.  The reference always runs full batch, so the
collapsed H-scaling /(batch·Q)·Y_N reduces to /Q; with ``data.mask`` every
per-timestep sum is masked and normalised by the number of real
transitions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ffvd_tpu_torch.model import conditionals as cond
from ffvd_tpu_torch.model import priors
from ffvd_tpu_torch.model.likelihoods import (emission_log_lik_rows,
                                              emission_mean)
from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
from ffvd_tpu_torch.ops.densities import (logdensity_norm_diag,
                                          logdensity_norm_diag_nonvec)


def gp_inputs(params: GPSSMParams, data: SSMData) -> torch.Tensor:
    """x̃_t = concat(x_t, u_t) over the N training transitions
    (dgp_model.py:267-271 / :339-342)."""
    n = params.n_transitions
    x_prev = params.x[:n]
    if data.control.shape[1] > 0:
        return torch.cat([x_prev, data.control[:n]], dim=1)
    return x_prev


def elbo_terms(params: GPSSMParams, data: SSMData, *,
               kernel_type: str = "SquaredExponential",
               prior_type: str = "normal",
               u_collapse: bool = True,
               jitter: float = 1e-5,
               emission_noise: str = "auto",
               collapse_precision: str = "native",
               ds64_refine: Optional[int] = None,
               key=None) -> Dict[str, torch.Tensor]:
    """All nll terms.  Returns a dict whose 'nll' entry is the objective.

    ``collapse_precision`` other than "native" and ``key`` (the deep
    transition's sampling key) belong to paths not ported yet."""
    if collapse_precision != "native":
        raise NotImplementedError(
            "collapse_precision='ds64'/'hybrid' is not ported yet "
            "(ROADMAP Queue 1, item 9: precision modes)")
    if key is not None:
        raise NotImplementedError(
            "deep transitions are not ported yet (ROADMAP Queue 1, item 8: "
            "model/deep.py)")
    n = params.n_transitions
    mask = data.mask
    dt, dev = params.x.dtype, params.x.device
    if mask is None:
        y_n = torch.tensor(float(n), dtype=dt, device=dev)
        msum = torch.sum
        row_w = None
    else:
        y_n = torch.sum(mask)

        def msum(rows):           # rows: (N,) or (N, D) — mask leading axis
            w = mask if rows.dim() == 1 else mask[:, None]
            return torch.sum(rows * w)
        row_w = mask
    batch = y_n
    q = params.q

    # Emission term (dgp_model.py:248-250, :264).
    y_mean = emission_mean(params.x[1:], params.c, params.d)
    log_lik = msum(emission_log_lik_rows(params, data.y, y_mean,
                                         emission_noise))
    nll_log_likelihood = -log_lik / batch

    # Priors (dgp_model.py:252, :286/:296, :326-334).
    hyper_prior = priors.hyperparameter_prior(params.log_q, params.c,
                                              params.d, params.log_rchol)
    part_prior = (priors.prior_hyper(kernel_type, params.kernel)
                  + priors.prior_z(prior_type, kernel_type, params.kernel,
                                   params.z)
                  + priors.prior_x0(params.x[0])
                  + hyper_prior)

    xc = gp_inputs(params, data)
    pre = cond.kernel_precal(kernel_type, params.kernel, params.z, jitter)

    terms: Dict[str, torch.Tensor] = {}
    if u_collapse:
        term1, term2, trace = cond.collapsed_bound_terms(
            kernel_type, params.kernel, pre, params.z, params.x, xc, q,
            mask=row_w)
        later_term1 = term1 / y_n
        later_term2 = term2 / y_n
        nll_trace = trace / y_n
        # Residual random-walk dynamics prior (dgp_model.py:283-284).
        x_t_prior_q = -msum(logdensity_norm_diag_nonvec(
            params.x[1:], params.x[:-1], torch.sqrt(q))) / batch
        nll_part_prior = -part_prior / y_n
        nll = (nll_part_prior + nll_log_likelihood + x_t_prior_q
               + nll_trace + later_term1 + later_term2)
        terms.update(later_term1=later_term1, later_term2=later_term2)
    else:
        mean, var = cond.whitened_conditional(
            kernel_type, params.kernel, pre, params.z, params.u, xc)
        mean = mean + params.x[:n]        # identity mean function (:346)
        reg_trace = -0.5 * torch.sum(var / q[None, :], dim=1)
        reg_x_prior = logdensity_norm_diag(params.x[1:], mean, torch.sqrt(q))
        nll_trace = -msum(reg_trace) / batch
        x_t_prior_q = -msum(reg_x_prior) / batch
        nll_part_prior = -(part_prior + priors.prior_u(params.u)) / y_n
        nll = nll_part_prior + nll_log_likelihood + x_t_prior_q + nll_trace

    terms.update(
        nll_log_likelihood=nll_log_likelihood,
        nll_part_prior=nll_part_prior,
        x_t_prior_Q=x_t_prior_q,
        nll_reg_trace_inverse_Q_B=nll_trace,
        nll=nll,
    )
    return terms


def negative_elbo(params: GPSSMParams, data: SSMData, **kw) -> torch.Tensor:
    """Scalar objective (reference's ``self.nll``, dgp_model.py:288/:297)."""
    return elbo_terms(params, data, **kw)["nll"]
