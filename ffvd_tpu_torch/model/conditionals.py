"""Sparse-GP conditionals and the analytic collapse of q(U), batched over D.

Counterpart of ``ffvd_tpu/model/conditionals.py`` (the reference's
``conditionals_multi_output.py``): one batched ``(D, M, M)`` Cholesky and
explicit ``Lm⁻¹`` (``kernel_pre_cal``, :124-169), then batched matmuls for
the ``(D, M, N)`` projection.  Only the whitened representation is
implemented, as every live reference call site is whitened
(dgp_model.py:99,343).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ffvd_tpu_torch.ops import chol as cholops
from ffvd_tpu_torch.ops import kernels as kops
from ffvd_tpu_torch.ops.kernels import KernelParams


@dataclasses.dataclass
class Precal:
    """Cached factorisation of Kmm for all D dims.

    lm:     (D, M, M) lower Cholesky of Kmm + jitter·I
    lm_inv: (D, M, M) Lm⁻¹ (lower triangular)
    """

    lm: torch.Tensor
    lm_inv: torch.Tensor


def kernel_precal(kernel_type: str, kparams: KernelParams, z: torch.Tensor,
                  jitter: float = 1e-5) -> Precal:
    """Factorise Kmm = K(Z,Z) + jitter·I for all D dims at once."""
    kmm = kops.gram(kernel_type, kparams, z)
    eye = torch.eye(z.shape[0], dtype=kmm.dtype, device=kmm.device)
    lm, lm_inv = cholops.chol_and_inv(kmm + jitter * eye)
    return Precal(lm=lm, lm_inv=lm_inv)


def projection(kernel_type: str, kparams: KernelParams, pre: Precal,
               z: torch.Tensor, xnew: torch.Tensor) -> torch.Tensor:
    """A = Lm⁻¹ K(Z, X̃) for all D dims → (D, M, N).

    Aᵀ is the reference's whitened feature matrix F̃ = K(X̃,Z) Lm⁻ᵀ
    (conditionals_multi_output.py:242)."""
    knm = kops.cross(kernel_type, kparams, xnew, z)           # (D, N, M)
    return pre.lm_inv @ knm.mT                                 # (D, M, N)


def whitened_conditional(
    kernel_type: str,
    kparams: KernelParams,
    pre: Precal,
    z: torch.Tensor,
    u: torch.Tensor,
    xnew: torch.Tensor,
    q_sqrt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whitened predictive q(f*) at xnew for D independent GPs
    (``base_conditional`` with white=True, full_cov=False):

        mean_d = A_dᵀ u_d,   var_d = Kdiag_d − Σ_m A_d² (+ Σ (L_dᵀ A_d)²)

    q_sqrt, if given, is ``(D, M, M)``, the per-dim factor L_d of q(u_d).
    Returns (mean (N, D), var (N, D))."""
    a = projection(kernel_type, kparams, pre, z, xnew)        # (D, M, N)
    kdiag = kops.diag(kernel_type, kparams, xnew)             # (D, N)
    mean = torch.einsum("dmn,md->nd", a, u)                   # (N, D)
    var = kdiag - torch.sum(a * a, dim=1)                     # (D, N)
    if q_sqrt is not None:
        lta = q_sqrt.mT @ a                                   # Lᵀ A
        var = var + torch.sum(lta * lta, dim=1)
    return mean, var.T


def gp_transition(
    kernel_type: str,
    kparams: KernelParams,
    pre: Precal,
    z: torch.Tensor,
    u: torch.Tensor,
    q: torch.Tensor,
    x_t: torch.Tensor,
    ctrl: torch.Tensor,
    eps: torch.Tensor,
    q_sqrt: Optional[torch.Tensor] = None,
    h_t: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the GP transition for a block of R rows: the PG sweep's
    particles (``particle_gibbs.py:81-106``, ``_propagate``) or the
    rollout's samples (``eval/rollout.py:65-80``).

        x̃ = [h_t, ctrl],  (μ, v) = q(f | x̃),
        var_tot = max(v + Q, 0),  x_next = (μ + x_t) + ε·√var_tot

    x_t (R, D); h_t (R, D), the head's state input, is x_t for the shallow
    model and the hidden layers' output for a deep one (the head-skip
    design, ``ffvd_tpu/model/deep.py:14-24``): the identity skip stays on
    x_t.  ctrl (U,), shared by every row, U may be 0; eps (R, D); q (D,);
    q_sqrt as in ``whitened_conditional``.  The clamp guards fp32
    cancellation in Kdiag − ΣA².  Returns (x_next, var_tot), each (R, D)."""
    h = x_t if h_t is None else h_t
    if ctrl.shape[-1] > 0:
        xc = torch.cat([h, ctrl[None, :].expand(h.shape[0], -1)], dim=1)
    else:
        xc = h
    mu, var = whitened_conditional(kernel_type, kparams, pre, z, u, xc,
                                   q_sqrt=q_sqrt)
    var_tot = torch.clamp(var + q, min=0.0)
    return (mu + x_t) + eps * torch.sqrt(var_tot), var_tot


def no_reduce(t: torch.Tensor) -> torch.Tensor:
    """A sum over transitions held whole by one process: as it is."""
    return t


def _collapse_pieces(a: torch.Tensor, dx: torch.Tensor, q: torch.Tensor,
                     gram_scale: float = 1.0, reduce=no_reduce):
    """H_d = s·F̃ᵀF̃/Q_d + I and a_d = s·F̃ᵀ Δx_d / Q_d.  ``reduce`` takes
    the sums over transitions, F̃ᵀF̃ and F̃ᵀΔx, before they are scaled (a
    process of a time-sharded run holds some of the transitions:
    ``parallel/sequence.py``)."""
    eye = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    h = gram_scale * reduce(a @ a.mT) / q[:, None, None] + eye  # (D, M, M)
    avec = (gram_scale * reduce(torch.einsum("dmn,nd->dm", a, dx))
            / q[:, None])
    return h, avec


def collapsed_bound_terms(
    kernel_type: str,
    kparams: KernelParams,
    pre: Precal,
    z: torch.Tensor,
    x: torch.Tensor,
    xc: torch.Tensor,
    q: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    gram_scale: float = 1.0,
    reduce=no_reduce,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three collapsed-bound pieces (``collapse_after_kernel_
    precalculation``, conditionals_multi_output.py:230-257):

        term1   = ½ Σ_d log|H_d|
        term2   = −½ Σ_d a_dᵀ H_d⁻¹ a_d
        trace   = ½ Σ_d Σ_t (K_tt − ‖F̃_t‖²)/Q_d

    un-normalised (the caller divides by Y_N).  ``gram_scale`` is the
    minibatch factor Y_N/batch on the H-gram and a-vector (:246-248); the
    trace term is deliberately not scaled.  x: (N+1, D) latent states;
    xc: (N, Din) GP inputs; ``mask`` (N,) zeroes padded transitions.
    ``reduce`` takes each sum over the transitions (the gram, the
    a-vector, the trace) before anything nonlinear: identity here, the
    'sp' all-reduce when x, xc and mask are one process's rows."""
    a = projection(kernel_type, kparams, pre, z, xc)          # (D, M, N)
    kdiag = kops.diag(kernel_type, kparams, xc)               # (D, N)
    dx = x[1:] - x[:-1]                                       # (N, D)
    if mask is not None:
        a = a * mask[None, None, :]
        kdiag = kdiag * mask[None, :]
        dx = dx * mask[:, None]

    h, avec = _collapse_pieces(a, dx, q, gram_scale, reduce)
    chol_h, hinv_l = cholops.chol_and_inv(h)
    term1 = 0.5 * torch.sum(cholops.chol_logdet(chol_h))
    # aᵀH⁻¹a = ‖L_H⁻¹ a‖² — a matmul against the explicit inverse factor.
    v = torch.einsum("dmk,dk->dm", hinv_l, avec)
    term2 = -0.5 * torch.sum(v * v)
    trace = 0.5 * reduce(torch.sum((kdiag - torch.sum(a * a, dim=1))
                                   / q[:, None]))
    return term1, term2, trace


def collapsed_u_posterior(
    kernel_type: str,
    kparams: KernelParams,
    pre: Precal,
    z: torch.Tensor,
    x: torch.Tensor,
    xc: torch.Tensor,
    q: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior over the collapsed whitened inducing outputs
    (``collapse_u_mean_after_kernel_precalculation``,
    conditionals_multi_output.py:206-227): q(u_d) = N(H_d⁻¹ a_d, H_d⁻¹),
    factor L_d = chol(H_d)⁻ᵀ.

    Returns (u_mean (M, D), q_sqrt (D, M, M) upper-triangular)."""
    a = projection(kernel_type, kparams, pre, z, xc)          # (D, M, N)
    h, avec = _collapse_pieces(a, x[1:] - x[:-1], q)
    _, hinv_l = cholops.chol_and_inv(h)
    # H⁻¹a = L⁻ᵀ (L⁻¹ a); q_sqrt = chol(H)⁻ᵀ = (L⁻¹)ᵀ (upper triangular).
    v = torch.einsum("dmk,dk->dm", hinv_l, avec)
    u_mean = torch.einsum("dmk,dm->dk", hinv_l, v)
    return u_mean.T, hinv_l.mT
