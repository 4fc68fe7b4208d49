"""Plain PyTorch reference of FFVD case C5: the collapsed GP state-space
model of ``perfbench/reference/gpssm.py`` with the SE-ARD kernel's log
variance and log lengthscales sampled by scale-adapted SG-HMC, and every
other leaf but U (collapsed) trained by Adam at a sampled point.

One outer iteration follows the published description (Fan et al., ICML
2023, arXiv:2302.09921; github.com/xuhuifan/FFVD, models.py:142-197,
base_model.py:143-179 and :915-950):

1. 21 sampler sub-steps on the two kernel leaves, burn-in first, then
   (burn-in, sample) ten times; each takes a fresh gradient of the negative
   collapsed ELBO with respect to those leaves alone, the other leaves held
   where they are.  Per variable θ with auxiliaries (ξ, g, g², p), all
   started at (1, 1, 1, 0) and every one read before any is written:

       r   = 1/(ξ+1)
       g'  = (1−r)·g + r·∇,   g²' = (1−r)·g² + r·∇²,
       ξ'  = 1 + ξ·(1 − g·g/(g²+1e−16))          (burn-in only)
       M⁻¹ = 1/(√(g²+1e−16)+1e−16)
       σ   = √max(2·(ε/√(N+1))²·mdecay·M⁻¹, 1e−16)
       p'  = p − ε²·M⁻¹·∇ − mdecay·p + σ·n,   θ' = θ + p'

   (ε², not (ε/√(N+1))², in the drift: the published code's own form);
2. the sampled leaves written into a ring buffer of ``window_size`` slots
   at slot (iteration − 1) mod ``window_size``, the count of filled slots
   capped at its size;
3. one Adam step on x, z, log Q, C, d and the emission noise's log
   Cholesky, its gradient and the reported nll taken with the sampled
   leaves read from a random slot of the window.

Departures from the published TensorFlow code, each the JAX rebuild's and
so the program's:

- float32 guards: a gradient's non-finite entries are zeroed and it is
  clipped to ±``sghmc_grad_clip``; before each sampler update the gradient
  is clipped to ±max(``sghmc_spike_clip``·√(g²+1e−16), 1), after it p' to
  ±``sghmc_p_clip``, and after each sub-step the log leaves to
  [``sghmc_log_clip_lower``, ``sghmc_log_clip``];
- the random numbers come from one ``torch.Generator`` in the program's
  order, not from TensorFlow's: each iteration draws, in float32 (the
  configuration's dtype), the normals of every chain's 21 sub-steps for
  the log variance, (21, C, D), then for the log lengthscales, (21, C, D,
  Din), then C 62-bit integers; chain c takes its own slice of each, and
  its window slot is its integer modulo the count of filled slots (a bias
  under 2⁻⁵⁶ against a uniform draw), drawn after the snapshot.

The draws need the training generator's seed and the chain count, which
the benchmark's system hands over with each member's start
(``with_draws``); ``as_tensors`` carries them to ``train_steps``.  Each
call of ``train_steps`` makes its own generator from that seed on the
device it runs on, so the float64 truth (TF32 off) and the float32 control
(TF32 on) of one process take the same draws.  It imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from perfbench.reference.gpssm import (  # noqa: F401  the cell's interface
    ADAM, GRAD_CLIP, LEAVES, load_series, negative_elbo, philox_normals,
    rollout, warm_start)
from perfbench.reference.gpssm import as_tensors as _as_tensors

Leaves = Dict[str, torch.Tensor]

SAMPLED = ("kernel.log_variance", "kernel.log_lengthscales")
TRAINED = tuple(k for k in LEAVES if k not in SAMPLED + ("u",))
BURN_IN = (True,) + (True, False) * 10      # the 21 sub-steps
EPSILON = 0.01           # FFVD_Main.py:343
MDECAY = 0.05            # dgp_model.py:161
WINDOW = 64              # base_model.py:927-933
SPIKE_CLIP = 20.0
P_CLIP = 1.0
LOG_CLIP = (-30.0, 12.0)
FEED_BITS = 2 ** 62


class Draws(NamedTuple):
    """Where a member's random numbers come from: the training generator's
    ``seed``, the member's ``chain`` of ``chains``, and the dtype in which
    the program draws them."""

    seed: int
    chain: int
    chains: int
    dtype: torch.dtype = torch.float32


class Start(dict):
    """A member's leaves, path → array or tensor, with its ``draws``."""

    def __init__(self, leaves, draws: Draws):
        super().__init__(leaves)
        self.draws = draws


def with_draws(leaves: Dict[str, np.ndarray], seed: int, chain: int,
               chains: int) -> Start:
    """Chain ``chain`` of ``chains``'s starting leaves, drawing from a
    generator seeded with ``seed``."""
    return Start(leaves, Draws(seed, chain, chains))


def as_tensors(leaves: Start, dtype, device, stored=torch.float32) -> Start:
    """``gpssm.as_tensors`` of the leaves, with their draws made in
    ``stored``, the dtype in which the configuration keeps its
    parameters."""
    return Start(_as_tensors(leaves, dtype, device, stored),
                 leaves.draws._replace(dtype=stored))


def _gradient(p: Leaves, y, control, keys):
    """(nll, the sanitised gradient with respect to ``keys``), the other
    leaves held as constants."""
    with torch.enable_grad():
        req = {k: v.detach().requires_grad_(k in keys) for k, v in p.items()}
        nll = negative_elbo(req, y, control)
        grads = torch.autograd.grad(nll, [req[k] for k in keys])
    clean = {k: torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=0.0,
                                             neginf=0.0), -GRAD_CLIP,
                            GRAD_CLIP)
             for k, g in zip(keys, grads)}
    return nll.detach(), clean


def _sampler_update(theta, grad, aux: dict, noise, x_n: int, burn_in: bool):
    """One variable's sub-step: θ' and its auxiliaries (ξ, g, g², p)."""
    xi, g, g2, p = aux["xi"], aux["g"], aux["g2"], aux["p"]
    bound = torch.clamp(SPIKE_CLIP * torch.sqrt(g2 + 1e-16), min=1.0)
    grad = torch.clamp(grad, min=-bound, max=bound)
    r = 1.0 / (xi + 1.0)
    minv = 1.0 / (torch.sqrt(g2 + 1e-16) + 1e-16)
    eps_s = EPSILON / math.sqrt(x_n)
    sigma = torch.sqrt(torch.clamp(2.0 * eps_s * eps_s * MDECAY * minv,
                                   min=1e-16))
    p_new = torch.clamp(p - EPSILON ** 2 * minv * grad - MDECAY * p
                        + noise * sigma, -P_CLIP, P_CLIP)
    out = {"p": p_new}
    if burn_in:
        out.update(xi=1.0 + xi * (1.0 - g * g / (g2 + 1e-16)),
                   g=(1.0 - r) * g + r * grad,
                   g2=(1.0 - r) * g2 + r * grad * grad)
    return theta + p_new, {**aux, **out}


def _iteration_draws(gen: torch.Generator, p: Leaves, d: Draws):
    """One iteration's draws as the program makes them, this chain's
    slice: path → (21, ...) normals in ``p``'s dtype, and the feed's
    integer."""
    normals = {k: torch.randn((len(BURN_IN), d.chains) + tuple(p[k].shape),
                              generator=gen, device=gen.device,
                              dtype=d.dtype)[:, d.chain].to(p[k])
               for k in SAMPLED}
    bits = torch.randint(0, FEED_BITS, (d.chains,), generator=gen,
                         device=gen.device)
    return normals, int(bits[d.chain])


def train_steps(p: Start, y, control, steps: int, grad_steps: int = 1,
                snap: int = 0):
    """``steps`` C5 iterations from ``p``, a ``Start``.  Returns (the nll
    before each Adam step, at its window-fed point; the Adam leaves'
    gradients of the first ``grad_steps``; the leaves after step ``snap``
    (after the last if 0); the leaves after the last)."""
    d = p.draws
    gen = torch.Generator(device=p["x"].device).manual_seed(d.seed)
    p = {k: v.detach().clone() for k, v in p.items()}
    x_n = p["x"].shape[0]
    aux = {k: {"xi": torch.ones_like(p[k]), "g": torch.ones_like(p[k]),
               "g2": torch.ones_like(p[k]), "p": torch.zeros_like(p[k])}
           for k in SAMPLED}
    window = {k: p[k].new_zeros((WINDOW,) + tuple(p[k].shape))
              for k in SAMPLED}
    filled = 0
    m = {k: torch.zeros_like(p[k]) for k in TRAINED}
    s = {k: torch.zeros_like(p[k]) for k in TRAINED}
    nlls, grads, at_snap = [], [], None
    for t in range(1, steps + 1):
        # The program draws every sub-step's normals before the phase and
        # the feed's integer after it: the same stream.
        normals, bits = _iteration_draws(gen, p, d)
        for i, burn_in in enumerate(BURN_IN):
            _, g = _gradient(p, y, control, SAMPLED)
            for k in SAMPLED:
                theta, aux[k] = _sampler_update(p[k], g[k], aux[k],
                                                normals[k][i], x_n, burn_in)
                p[k] = torch.clamp(theta, *LOG_CLIP)
        for k in SAMPLED:
            window[k][(t - 1) % WINDOW] = p[k]
        filled = min(filled + 1, WINDOW)
        slot = bits % max(filled, 1)
        fed = {**p, **{k: window[k][slot] for k in SAMPLED}}
        nll, g = _gradient(fed, y, control, TRAINED)
        nlls.append(nll)
        if t <= grad_steps:
            grads.append(g)
        c1 = 1.0 - ADAM["b1"] ** t
        c2 = 1.0 - ADAM["b2"] ** t
        for k in TRAINED:
            m[k] = ADAM["b1"] * m[k] + (1.0 - ADAM["b1"]) * g[k]
            s[k] = ADAM["b2"] * s[k] + (1.0 - ADAM["b2"]) * g[k] * g[k]
            p[k] = p[k] - (ADAM["lr"] / c1) * m[k] / (
                torch.sqrt(s[k]) / math.sqrt(c2) + ADAM["eps"])
        if t == snap:
            at_snap = dict(p)
    return torch.stack(nlls), grads, at_snap or p, p
