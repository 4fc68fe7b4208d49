"""Scale-adapted SG-HMC (Springenberg-style) over a dict of tensors.

Counterpart of ``ffvd_tpu/inference/sghmc.py`` (the rebuild of
``BaseModel.generate_update_step``, base_model.py:143-179).  The sampled
variables are a dict keyed by leaf path (``model/params.py::LEAF_PATHS``);
the auxiliary state holds one tensor per sampled leaf.

Per variable θ with auxiliaries (ξ, g, g², p) initialised (1, 1, 1, 0)
(base_model.py:151-154), every read from the *old* values, as the TF graph
reads before it assigns:

    r      = 1/(ξ+1)
    g_t    = (1−r)·g  + r·∇          (adapted only during burn-in)
    g²_t   = (1−r)·g² + r·∇²
    ξ_t    = 1 + ξ·(1 − g·g/(g²+1e−16))      (the old g, not g_t)
    M⁻¹    = 1/(√(g²+1e−16)+1e−16)
    ε_s    = ε/√X_N                  (base_model.py:166; X_N = N+1)
    σ      = √max(2·ε_s²·mdecay·M⁻¹, 1e−16)
    p_t    = p − ε²·M⁻¹·∇ − mdecay·p + N(0, σ²)   (ε², not ε_s²: the
                                                   reference's quirk, :172)
    θ_t    = θ + p_t

The fp32 guards of the JAX package keep their places: the spike clip of ∇
to ±max(spike_clip·√(g²+1e-16), 1) before the update, the clip of p_t to
±p_clip after it.  Outside burn-in ξ, g and g² keep their old values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

Leaves = Dict[str, torch.Tensor]


@dataclasses.dataclass
class SGHMCState:
    xi: Leaves
    g: Leaves
    g2: Leaves
    p: Leaves


def sghmc_init(params: Leaves) -> SGHMCState:
    return SGHMCState(
        xi={k: torch.ones_like(v) for k, v in params.items()},
        g={k: torch.ones_like(v) for k, v in params.items()},
        g2={k: torch.ones_like(v) for k, v in params.items()},
        p={k: torch.zeros_like(v) for k, v in params.items()})


def _leaf_update(theta, grad, xi, g, g2, p, noise_u, *, epsilon, mdecay,
                 x_n, burn_in: bool, p_clip=None, spike_clip=None):
    """One variable's update; the operations and their order are those of
    the JAX ``_leaf_update`` (fp64 results agree within a few units in the
    last place)."""
    if spike_clip is not None:
        bound = torch.clamp(spike_clip * torch.sqrt(g2 + 1e-16), min=1.0)
        grad = torch.clamp(grad, min=-bound, max=bound)
    r = 1.0 / (xi + 1.0)
    g_t = (1.0 - r) * g + r * grad
    g2_t = (1.0 - r) * g2 + r * grad * grad
    xi_t = 1.0 + xi * (1.0 - g * g / (g2 + 1e-16))
    minv = 1.0 / (torch.sqrt(g2 + 1e-16) + 1e-16)

    eps_scaled = epsilon / math.sqrt(x_n)
    noise_scale = 2.0 * (eps_scaled * eps_scaled) * mdecay * minv
    sigma = torch.sqrt(torch.clamp(noise_scale, min=1e-16))
    p_t = p - epsilon ** 2 * minv * grad - mdecay * p + noise_u * sigma
    if p_clip is not None:
        p_t = torch.clamp(p_t, -p_clip, p_clip)
    theta_t = theta + p_t
    if burn_in:
        return theta_t, xi_t, g_t, g2_t, p_t
    return theta_t, xi, g, g2, p_t


def tree_normals(params: Leaves, generator: Optional[torch.Generator],
                 lead: Tuple[int, ...] = ()) -> Leaves:
    """Standard normals shaped ``lead + leaf.shape`` for every leaf, drawn
    from ``generator`` on its own device and moved to the leaf's."""
    if generator is None:
        raise ValueError("SG-HMC noise needs a torch.Generator or pre-drawn "
                         "normals (noise=)")
    return {k: torch.randn(lead + tuple(v.shape), generator=generator,
                           device=generator.device, dtype=v.dtype)
            .to(v.device)
            for k, v in params.items()}


def sghmc_step(params: Leaves, grads: Leaves, state: SGHMCState, *,
               epsilon: float, mdecay: float, x_n: int, burn_in: bool,
               p_clip=None, spike_clip=None, noise: Optional[Leaves] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Leaves, SGHMCState]:
    """One burn-in (adapt and move) or sampling (move only) update of every
    sampled leaf.  ``noise``: pre-drawn standard normals keyed like
    ``params``; without it they are drawn from ``generator``."""
    if noise is None:
        noise = tree_normals(params, generator)
    new = {k: _leaf_update(params[k], grads[k], state.xi[k], state.g[k],
                           state.g2[k], state.p[k], noise[k],
                           epsilon=epsilon, mdecay=mdecay, x_n=x_n,
                           burn_in=burn_in, p_clip=p_clip,
                           spike_clip=spike_clip)
           for k in params}
    pick = lambda i: {k: v[i] for k, v in new.items()}
    return pick(0), SGHMCState(xi=pick(1), g=pick(2), g2=pick(3), p=pick(4))
