"""Deep (multi-layer) GP-SSM transition.

Counterpart of ``ffvd_tpu/model/deep.py``: a doubly-stochastic deep sparse
GP on the residual transition,

    h⁰_t = x_t
    h^l_t = h^{l-1}_t + f_l([h^{l-1}_t, c_t]) + ε_l,
            ε_l ~ N(0, diag(σ²_l([h^{l-1}_t, c_t])))          l = 1..L-1
    x_{t+1} ~ N(x_t + f_L([h^{L-1}_t, c_t]), Q)                (head layer)

The head keeps the residual skip on x_t itself, so the hidden layers warp
the head GP's input space while the collapsed q(U) bound, the particle
weights and the rollout recursion keep their single-layer form
(``conditionals.gp_transition`` takes the head input h_t beside x_t).
Every layer is a whitened sparse GP with its own (Z, U, kernel) that
re-ingests the control, so all layers share the head's (M, D+U) shapes.

The inter-layer noise is explicit: ``eps`` is a list with one standard
normal tensor per hidden layer, shaped like that layer's mean, drawn by the
caller (from a ``torch.Generator``, or injected to reproduce JAX's
``normal(fold_in(key, i), ...)``).  ``eps=None`` propagates the layer means,
the deterministic objective used for reporting, the collapsed q(U) and the
nll of an Adam-free step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ffvd_tpu_torch.model import priors
from ffvd_tpu_torch.model.conditionals import (Precal, kernel_precal,
                                               whitened_conditional)
from ffvd_tpu_torch.model.params import HiddenLayerParams

Normals = Optional[Sequence[torch.Tensor]]


def hidden_priors(kernel_type: str, prior_type: str,
                  hidden: Sequence[HiddenLayerParams]):
    """Log prior of the hidden layers: each layer's kernel hypers, inducing
    inputs and whitened inducing outputs, the trio the head contributes."""
    total = 0.0
    for layer in hidden:
        total = total + (priors.prior_hyper(kernel_type, layer.kernel)
                         + priors.prior_z(prior_type, kernel_type,
                                          layer.kernel, layer.z)
                         + priors.prior_u(layer.u))
    return total


def hidden_precals(kernel_type: str, jitter: float,
                   hidden: Sequence[HiddenLayerParams]) -> Tuple[Precal, ...]:
    return tuple(kernel_precal(kernel_type, layer.kernel, layer.z, jitter)
                 for layer in hidden)


def propagate_hidden(kernel_type: str, jitter: float,
                     hidden: Sequence[HiddenLayerParams], h: torch.Tensor,
                     control: torch.Tensor, eps: Normals = None,
                     precals: Optional[Sequence[Precal]] = None
                     ) -> torch.Tensor:
    """Propagate states h (R, D) through the hidden layers; control (R, U)
    rows aligned with h (U may be 0).  ``eps[i]`` (R, D) samples layer i's
    marginal; None propagates means.  ``precals``: the layers' cached Kmm
    factorisations.  Returns the head layer's state input (R, D)."""
    for i, layer in enumerate(hidden):
        inp = torch.cat([h, control], dim=1) if control.shape[1] > 0 else h
        pre = (precals[i] if precals is not None else
               kernel_precal(kernel_type, layer.kernel, layer.z, jitter))
        mu, var = whitened_conditional(kernel_type, layer.kernel, pre,
                                       layer.z, layer.u, inp)
        h = h + mu
        if eps is not None:
            # A floor, not a clamp at 0: fp32 cancellation in Kdiag − ΣA²
            # can go ≈ −1e-7σ², and sqrt'(0)·0 would put NaN in the gradient.
            h = h + eps[i] * torch.sqrt(torch.clamp(var, min=1e-16))
    return h


def propagate_step(kernel_type: str, jitter: float,
                   hidden: Sequence[HiddenLayerParams],
                   precals: Sequence[Precal], x_t: torch.Tensor,
                   ctrl: torch.Tensor, eps: Normals) -> torch.Tensor:
    """One time step of a block of R rows (rollout samples or particles):
    x_t (R, D), ctrl (U,) shared by every row, ``eps[i]`` (R, D) or None.
    Returns the head layer's state input (R, D)."""
    ctrl_b = ctrl[None, :].expand(x_t.shape[0], -1)
    return propagate_hidden(kernel_type, jitter, hidden, x_t, ctrl_b, eps,
                            precals=precals)


def hidden_normals(n_hidden: int, lead: Tuple[int, ...], d: int,
                   generator: Optional[torch.Generator], dtype,
                   device) -> list:
    """``n_hidden`` tensors of standard normals shaped ``lead + (d,)``,
    drawn from ``generator`` on its own device and moved to ``device``."""
    if generator is None:
        raise ValueError("the deep transition's inter-layer noise needs a "
                         "torch.Generator or injected normals")
    return [torch.randn(tuple(lead) + (d,), generator=generator, dtype=dtype,
                        device=generator.device).to(device)
            for _ in range(n_hidden)]
