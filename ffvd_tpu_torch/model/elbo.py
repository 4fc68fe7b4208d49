"""The negative free-form ELBO, collapsed and uncollapsed, full batch and
on a random time window.

Counterpart of ``ffvd_tpu/model/elbo.py`` (objective assembly of
``DGPSSM.__init__``, dgp_model.py:248-297, and ``regularizer``,
dgp_model.py:337-359).  Term names match the reference's tensors so per-term
golden values line up.  Full batch, the collapsed H-scaling /(batch·Q)·Y_N
reduces to /Q; with ``data.mask`` every per-timestep sum is masked and
normalised by the number of real transitions.  ``windowed_elbo_terms`` is
the minibatch objective: the same terms over x[start : start+W+1] and
y/control[start : start+W), with the reference's batch scaling.

A deep model (``params.hidden``, ``model/deep.py``) propagates the GP
inputs through its hidden layers, adds their priors, and takes ``eps``, the
per-layer inter-layer normals of one gradient evaluation (None: layer
means).  ``collapse_precision="ds64"`` evaluates the collapsed segment in
float64 (``model/ds_collapse.py``); everything else stays in the params'
dtype.

A process of a sharded run (``parallel/``) evaluates its share of the
objective.  The objective is a sum over the head's latent dims of per-dim
parts (the collapsed or uncollapsed GP terms, the x-dynamics term, the
kernel, log Q and determinantal priors, the whole-u prior) plus a shared
part that couples the dims or has none (the emission, the other priors).
``dims`` names the latent dims a process covers ('ep': its per-dim leaves
hold only those, x and c all D) and ``shared`` whether it adds the shared
part; ``rows`` names the transitions it holds ('sp') and ``reduce`` sums
each sum over transitions across the processes before anything nonlinear.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ffvd_tpu_torch.model import conditionals as cond
from ffvd_tpu_torch.model import priors
from ffvd_tpu_torch.model.deep import hidden_priors, propagate_hidden
from ffvd_tpu_torch.model.ds_collapse import ds_collapsed_terms
from ffvd_tpu_torch.model.likelihoods import (emission_log_lik_rows,
                                              emission_mean)
from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
from ffvd_tpu_torch.ops.densities import (logdensity_norm_diag,
                                          logdensity_norm_diag_nonvec)


def gp_inputs(params: GPSSMParams, data: SSMData, *,
              kernel_type: str = "SquaredExponential", jitter: float = 1e-5,
              eps: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """x̃_t = concat(h_t, u_t) over the N training transitions
    (dgp_model.py:267-271 / :339-342): h_t = x_t for the single-layer model,
    the hidden layers' propagation of x_t for a deep one."""
    n = params.n_transitions
    return _gp_inputs(params, params.x[:n], data.control[:n], kernel_type,
                      jitter, eps)


def _gp_inputs(params, x_prev, ctrl, kernel_type, jitter, eps):
    h = x_prev
    if params.hidden:
        h = propagate_hidden(kernel_type, jitter, params.hidden, x_prev,
                             ctrl, eps)
    return torch.cat([h, ctrl], dim=1) if ctrl.shape[1] > 0 else h


def elbo_terms(params: GPSSMParams, data: SSMData, *,
               kernel_type: str = "SquaredExponential",
               prior_type: str = "normal",
               u_collapse: bool = True,
               jitter: float = 1e-5,
               emission_noise: str = "auto",
               collapse_precision: str = "native",
               ds64_refine: Optional[int] = None,
               eps: Optional[Sequence[torch.Tensor]] = None,
               dims: Optional[Tuple[int, int]] = None,
               shared: bool = True,
               rows: Optional[Tuple[int, int]] = None,
               reduce: Optional[Callable] = None
               ) -> Dict[str, torch.Tensor]:
    """All nll terms.  Returns a dict whose 'nll' entry is the objective.

    ``eps``: a deep model's inter-layer normals, one (N, D) tensor per
    hidden layer (JAX draws them as ``normal(fold_in(key, i), (N, D))``);
    None propagates the layer means.

    ``collapse_precision``: "ds64" evaluates the collapsed segment (gram,
    Kmm factors, H and its terms) as one float64 segment at the float32
    values of its inputs (``ds_collapse.ds_collapsed_terms``), the fix for
    the fp32 gradient bias of that segment (DESIGN §12); any other value
    evaluates it in the params' dtype.  Uncollapsed objectives and a deep
    model's hidden-layer propagation ignore it.  ``ds64_refine`` is
    accepted and has no effect (float64 has nothing to refine).

    ``dims``, ``shared``: a share of the latent dims ('ep'); ``rows`` (t0,
    t1): the transitions x[t0] → x[t0+1] … x[t1-1] → x[t1] ('sp', x and the
    data whole), with ``reduce`` the sum across the processes that hold the
    others (see the module docstring)."""
    n = params.n_transitions
    t0, t1 = (0, n) if rows is None else rows
    red = cond.no_reduce if reduce is None else reduce
    mask = None if data.mask is None else data.mask[t0:t1]
    if mask is None:
        y_n = torch.tensor(float(n), dtype=params.x.dtype,
                           device=params.x.device)
    else:
        y_n = red(torch.sum(mask))
    if eps is not None and rows is not None:
        eps = [e[t0:t1] for e in eps]
    return _assemble(params, params.x[t0:t1 + 1], data.y[t0:t1],
                     data.control[t0:t1], mask, y_n, y_n, 1.0, kernel_type,
                     prior_type, u_collapse, jitter, emission_noise, eps,
                     collapse_precision, dims, shared, red)



def negative_elbo(params: GPSSMParams, data: SSMData, **kw) -> torch.Tensor:
    """Scalar objective (reference's ``self.nll``, dgp_model.py:288/:297)."""
    return elbo_terms(params, data, **kw)["nll"]


def window_rows(t: torch.Tensor, start: Union[int, torch.Tensor],
                length: int) -> torch.Tensor:
    """Rows start .. start+length-1 of t.  ``start`` may be a 0-d or
    1-element integer tensor on the device: the rows are gathered with
    ``index_select``, so no value is read back to the host (``narrow``
    would need a Python int)."""
    idx = torch.arange(length, device=t.device) + (
        start.reshape(()) if torch.is_tensor(start) else start)
    return t.index_select(0, idx)


def windowed_elbo_terms(params: GPSSMParams, data: SSMData,
                        start: Union[int, torch.Tensor], window_n: int, *,
                        kernel_type: str = "SquaredExponential",
                        prior_type: str = "normal",
                        u_collapse: bool = True,
                        jitter: float = 1e-5,
                        emission_noise: str = "auto",
                        collapse_precision: str = "native",
                        ds64_refine: Optional[int] = None,
                        eps: Optional[Sequence[torch.Tensor]] = None,
                        dims: Optional[Tuple[int, int]] = None,
                        shared: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """Minibatch (random time window) objective, the reference's
    batch_placeholder semantics made live (``ffvd_tpu/model/elbo.py:169-
    306``).  With b0 = start, batch = window_n, Y_N = N:

    - emission and x-dynamics terms: window sums / batch;
    - collapsed H-gram and a-vector scaled by Y_N/batch
      (conditionals_multi_output.py:246-248), logdet and quadratic / Y_N;
    - trace term: window sum / Y_N, unscaled (the reference's choice);
    - priors (prior_x0 on the global x₀, the hidden layers'): / Y_N.

    At window_n == N, start == 0 this is ``elbo_terms``.  Masked data: Y_N
    is the number of real transitions, batch the number of real ones in the
    window (at least 1), every window sum mask-weighted.  ``eps``: one
    (window_n, D) normal tensor per hidden layer, or None.
    ``collapse_precision``: as in ``elbo_terms``, the gram scale inside the
    float64 segment.  ``dims``, ``shared``: as in ``elbo_terms``."""
    n = params.n_transitions
    dt, dev = params.x.dtype, params.x.device
    mask = data.mask
    if mask is None:
        y_n = torch.tensor(float(n), dtype=dt, device=dev)
        batch = torch.tensor(float(window_n), dtype=dt, device=dev)
        mask_win = None
        gram_scale = float(n) / float(window_n)
    else:
        mask_win = window_rows(mask, start, window_n)
        y_n = torch.sum(mask)
        batch = torch.clamp(torch.sum(mask_win), min=1.0)
        gram_scale = y_n / batch
    return _assemble(params, window_rows(params.x, start, window_n + 1),
                     window_rows(data.y, start, window_n),
                     window_rows(data.control, start, window_n), mask_win,
                     y_n, batch, gram_scale, kernel_type, prior_type,
                     u_collapse, jitter, emission_noise, eps,
                     collapse_precision, dims, shared, cond.no_reduce)


def windowed_negative_elbo(params: GPSSMParams, data: SSMData,
                           start: Union[int, torch.Tensor], window_n: int,
                           **kw) -> torch.Tensor:
    return windowed_elbo_terms(params, data, start, window_n, **kw)["nll"]


def _assemble(params, x, y, ctrl, mask, y_n, batch, gram_scale, kernel_type,
              prior_type, u_collapse, jitter, emission_noise, eps,
              collapse_precision, dims, shared, reduce):
    """The terms over the transitions x[0] → x[1] … x[W-1] → x[W] with
    observations y (W, P) and controls ctrl (W, U): full batch (x is the
    whole trajectory, batch = Y_N, gram_scale 1), a window, or one
    process's rows.  Kmm is factorised only on the branches that read it:
    the ds64 segment factorises its own.  ``dims``, ``shared``, ``reduce``:
    see the module docstring; the per-dim terms read x[:, dims]."""
    w = x.shape[0] - 1
    if mask is None:
        def msum(rows):
            return reduce(torch.sum(rows))
    else:
        def msum(rows):           # rows: (W,) or (W, D) — mask leading axis
            m = mask if rows.dim() == 1 else mask[:, None]
            return reduce(torch.sum(rows * m))
    q = params.q
    xd = x if dims is None else x[:, dims[0]:dims[1]]

    # Emission term (dgp_model.py:248-250, :264), shared by the dims.
    if shared:
        y_mean = emission_mean(x[1:], params.c, params.d)
        log_lik = msum(emission_log_lik_rows(params, y, y_mean,
                                             emission_noise))
        nll_log_likelihood = -log_lik / batch
    else:
        nll_log_likelihood = x.new_zeros(())

    # Priors (dgp_model.py:252, :286/:296, :326-334): a sum over the dims
    # (the kernel hypers, a determinantal prior_z, log Q), then the shared.
    det = prior_type == "determinantal"
    pz = (priors.prior_z(prior_type, kernel_type, params.kernel, params.z)
          if det or shared else None)
    part_prior = (priors.prior_hyper(kernel_type, params.kernel)
                  + priors.log_q_prior(params.log_q))
    if det:
        part_prior = part_prior + pz
    if shared:
        if not det:
            part_prior = part_prior + pz
        part_prior = (part_prior + priors.prior_x0(params.x[0])
                      + priors.emission_prior(params.c, params.d,
                                              params.log_rchol))
        if params.hidden:
            part_prior = part_prior + hidden_priors(kernel_type, prior_type,
                                                    params.hidden)

    xc = _gp_inputs(params, x[:w], ctrl, kernel_type, jitter, eps)

    terms: Dict[str, torch.Tensor] = {}
    if u_collapse:
        if collapse_precision == "ds64":
            term1, term2, trace = ds_collapsed_terms(
                kernel_type, params.kernel, params.z, xd, xc, params.log_q,
                jitter=jitter, mask=mask, gram_scale=gram_scale,
                reduce=reduce)
        else:
            pre = cond.kernel_precal(kernel_type, params.kernel, params.z,
                                     jitter)
            term1, term2, trace = cond.collapsed_bound_terms(
                kernel_type, params.kernel, pre, params.z, xd, xc, q,
                mask=mask, gram_scale=gram_scale, reduce=reduce)
        later_term1 = term1 / y_n
        later_term2 = term2 / y_n
        nll_trace = trace / y_n
        # Residual random-walk dynamics prior (dgp_model.py:283-284).
        x_t_prior_q = -msum(logdensity_norm_diag_nonvec(
            xd[1:], xd[:-1], torch.sqrt(q))) / batch
        nll_part_prior = -part_prior / y_n
        nll = (nll_part_prior + nll_log_likelihood + x_t_prior_q
               + nll_trace + later_term1 + later_term2)
        terms.update(later_term1=later_term1, later_term2=later_term2)
    else:
        pre = cond.kernel_precal(kernel_type, params.kernel, params.z, jitter)
        mean, var = cond.whitened_conditional(
            kernel_type, params.kernel, pre, params.z, params.u, xc)
        mean = mean + xd[:w]              # identity mean function (:346)
        reg_trace = -0.5 * torch.sum(var / q[None, :], dim=1)
        reg_x_prior = logdensity_norm_diag(xd[1:], mean, torch.sqrt(q))
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
