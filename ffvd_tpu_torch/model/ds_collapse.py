"""The collapsed GP bound evaluated as one float64 segment.

Counterpart of ``ffvd_tpu/model/ds_collapse.py``, the fix for the measured
fp32 gradient bias of the collapsed bound near its optimum (DESIGN §12,
PARITY §2f): only evaluating the WHOLE segment

    gram  →  precal (Cholesky + triangular inverse)  →  collapsed terms

in high precision recovers the fp64 optimum.  The TPU has no float64, so
the JAX package computes it in double-single (two-float32) arithmetic.  The
card has native float64, so here the segment is the port's own
``kernel_precal``, ``collapsed_bound_terms`` and ``collapsed_u_posterior``
in ``torch.float64``: simpler, and at least as exact as double-single's
≈49 bits.

The interface is the JAX module's.  Each input is rounded to float32 first
(the mode exists for fp32 parameters, and their float32 values are the
point the segment evaluates at), then widened to float64; Q_d is
exp(log Q_d) in float64, so 1/Q_d is a float64 division, never a float32
reciprocal; the outputs are float32.  Gradients flow through
the casts by autograd, whose backward of ``.to`` casts the cotangent back,
as JAX's ``astype`` does.  ``refine``, the Newton-refinement rounds of the
double-single Cholesky, has nothing to refine in float64: it is accepted and
has no effect.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ffvd_tpu_torch.model import conditionals as cond
from ffvd_tpu_torch.ops.kernels import KernelParams


def _f64(t: torch.Tensor) -> torch.Tensor:
    """float32-rounded, then float64 (differentiable)."""
    return t.to(torch.float32).to(torch.float64)


def _kernel64(kparams: KernelParams) -> KernelParams:
    return KernelParams(_f64(kparams.log_variance),
                        _f64(kparams.log_lengthscales))


def _scale64(s):
    """The minibatch gram scale, float32-rounded: a Python number or a
    tensor (masked windows)."""
    if torch.is_tensor(s):
        return _f64(s)
    return float(np.float32(s))


def ds_precal(kernel_type: str, kparams: KernelParams, z: torch.Tensor,
              jitter: float = 1e-5, refine: Optional[int] = None
              ) -> cond.Precal:
    """The Kmm factorisation in float64, returned as a float32 ``Precal``:
    a drop-in for ``kernel_precal`` where the downstream math is float32
    (the rollout's conditionals)."""
    pre = cond.kernel_precal(kernel_type, _kernel64(kparams), _f64(z), jitter)
    return cond.Precal(lm=pre.lm.to(torch.float32),
                       lm_inv=pre.lm_inv.to(torch.float32))


def ds_collapsed_u_posterior(
    kernel_type: str,
    kparams: KernelParams,
    z: torch.Tensor,
    x: torch.Tensor,
    xc: torch.Tensor,
    log_q: torch.Tensor,
    *,
    jitter: float = 1e-5,
    refine: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q(U) of the collapsed bound from the float64 segment, float32 out.
    H = F̃ᵀF̃/Q + I has cond ~ ‖F̃‖²/Q, so at a sharply trained point
    (Q ~ 1e-6) an fp32 factor of H inflates the rollout variance by orders
    of magnitude (PARITY §2f caveat).

    Returns (u_mean (M, D), q_sqrt (D, M, M) upper-triangular), float32."""
    kp, z64 = _kernel64(kparams), _f64(z)
    pre = cond.kernel_precal(kernel_type, kp, z64, jitter)
    u_mean, q_sqrt = cond.collapsed_u_posterior(
        kernel_type, kp, pre, z64, _f64(x), _f64(xc), torch.exp(_f64(log_q)))
    return u_mean.to(torch.float32), q_sqrt.to(torch.float32)


def ds_collapsed_terms(
    kernel_type: str,
    kparams: KernelParams,
    z: torch.Tensor,
    x: torch.Tensor,
    xc: torch.Tensor,
    log_q: torch.Tensor,
    *,
    jitter: float = 1e-5,
    mask: Optional[torch.Tensor] = None,
    gram_scale=1.0,
    refine: Optional[int] = None,
    reduce=cond.no_reduce,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(term1, term2, trace) of the collapsed bound, float64 throughout,
    float32 out: the values of ``kernel_precal`` + ``collapsed_bound_terms``
    (same un-normalised scaling; the caller divides by Y_N), with log Q in
    place of Q.  ``mask`` zeroes padded transitions of A, Kdiag and Δx;
    ``gram_scale`` multiplies 1/Q in H and a, not in the trace; ``reduce``
    takes the sums over transitions, in float64 (``collapsed_bound_terms``)."""
    kp, z64 = _kernel64(kparams), _f64(z)
    pre = cond.kernel_precal(kernel_type, kp, z64, jitter)
    terms = cond.collapsed_bound_terms(
        kernel_type, kp, pre, z64, _f64(x), _f64(xc), torch.exp(_f64(log_q)),
        mask=None if mask is None else _f64(mask),
        gram_scale=_scale64(gram_scale), reduce=reduce)
    return tuple(t.to(torch.float32) for t in terms)
