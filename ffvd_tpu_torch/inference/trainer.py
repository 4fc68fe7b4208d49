"""The FFVD training protocol, Adam-only path (cases C1 and C4).

Counterpart of ``ffvd_tpu/inference/trainer.py``.  Per outer iteration the
reference (models.py:142-197) runs an SG-HMC phase, a window snapshot, an
optional particle-Gibbs sweep and one Adam step on the nll.  When the case
has no SG-HMC leaves and no particle Gibbs (C1, C4) only the Adam step
remains, and it draws no random numbers: the nll trace is a deterministic
function of the warm start.  The sampler cases raise at construction until
ROADMAP Queue 1 items 6-7 port them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from ffvd_tpu_torch.config import ADAM, SGHMC, FFVDConfig, partition_for
from ffvd_tpu_torch.model.elbo import negative_elbo
from ffvd_tpu_torch.model.params import GPSSMParams, SSMData


def label_tree(cfg: FFVDConfig) -> Dict[str, str]:
    """'adam'/'sghmc'/'frozen' label per leaf path of a shallow model."""
    part = partition_for(cfg)
    return {"x": part.x, "u": part.u, "z": part.z,
            "kernel.log_variance": part.kernel,
            "kernel.log_lengthscales": part.kernel,
            "log_q": part.log_q, "c": part.lik, "d": part.lik,
            "log_rchol": part.lik}


def sanitize_grads(grads, clip):
    """Zero non-finite gradient elements and clip magnitudes to ±clip
    (FFVDConfig.sghmc_grad_clip).  No-op when clip is None."""
    if clip is None:
        return list(grads)
    return [torch.clamp(torch.where(torch.isfinite(g), g,
                                    torch.zeros_like(g)), -clip, clip)
            for g in grads]


@dataclasses.dataclass
class TrainState:
    params: GPSSMParams
    adam: torch.optim.Adam
    step: int = 0


class Trainer:
    """Runs the Adam-only FFVD training protocol for one config."""

    def __init__(self, cfg: FFVDConfig, data: SSMData):
        if cfg.case_config.x_pg:
            raise NotImplementedError(
                f"case {cfg.case_config.name} needs particle Gibbs, which is "
                "not ported yet (ROADMAP Queue 1, item 7)")
        self.labels = label_tree(cfg)
        if any(l == SGHMC for l in self.labels.values()):
            raise NotImplementedError(
                f"case {cfg.case_config.name} (hyperparameter_sampling="
                f"{cfg.hyperparameter_sampling}) samples leaves by SG-HMC, "
                "which is not ported yet (ROADMAP Queue 1, item 6)")
        if cfg.n_layers > 1:
            raise NotImplementedError(
                "deep transitions are not ported yet (ROADMAP Queue 1, "
                "item 8: model/deep.py)")
        if cfg.minibatch_size is not None and \
                cfg.minibatch_size < data.y.shape[0]:
            raise NotImplementedError(
                "minibatch windows are not ported yet (ROADMAP Queue 1, "
                "item 8: windowed_elbo_terms)")
        if cfg.collapse_precision != "native":
            raise NotImplementedError(
                "collapse_precision='ds64'/'hybrid' is not ported yet "
                "(ROADMAP Queue 1, item 9)")
        self.cfg = cfg
        self.data = data
        self.nll_fn = functools.partial(
            negative_elbo,
            kernel_type=cfg.kernel_type, prior_type=cfg.prior_type,
            u_collapse=cfg.case_config.u_collapse, jitter=cfg.jitter,
            emission_noise=cfg.emission_noise)
        # Effective Adam lr: 0.003·0.95^(global_step/1000) evaluated at the
        # constant global_step=1 the reference always passes
        # (base_model.py:188-194).
        self.adam_lr = cfg.adam_lr * 0.95 ** (1.0 / 1000.0)

    def init_state(self, params: GPSSMParams) -> TrainState:
        """Copy ``params`` into trainable leaves; Adam covers the 'adam'
        leaves only, so frozen leaves (u in C4) get no update."""
        leaves = {k: v.detach().clone().requires_grad_(self.labels[k] == ADAM)
                  for k, v in params.leaves().items()}
        # torch.optim.Adam is optax.adam's formula: b1=0.9, b2=0.999,
        # bias-corrected moments, eps=1e-8 added outside the square root.
        adam = torch.optim.Adam(
            [v for k, v in leaves.items() if self.labels[k] == ADAM],
            lr=self.adam_lr, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(params=GPSSMParams.from_leaves(leaves), adam=adam)

    def outer_step(self, state: TrainState) -> torch.Tensor:
        """One Adam step in place.  Returns the nll BEFORE the update
        (trainer.py:430), detached."""
        group = state.adam.param_groups[0]["params"]
        nll = self.nll_fn(state.params, self.data)
        grads = torch.autograd.grad(nll, group)
        for p, g in zip(group, sanitize_grads(grads,
                                              self.cfg.sghmc_grad_clip)):
            p.grad = g
        state.adam.step()
        state.step += 1
        return nll.detach()

    def run(self, state: TrainState, num_iterations: int,
            chunk_size: int = 500,
            nan_check: bool = True) -> Tuple[TrainState, torch.Tensor]:
        """Run ``num_iterations`` outer iterations (the reference runs
        2×cfg.iterations, models.py:142).  Returns (state, nll_trace).

        ``nan_check``: per chunk of ``chunk_size`` iterations, raise with the
        failing iteration index and a finite-by-block diagnosis."""
        traces = []
        done = 0
        while done < num_iterations:
            n = min(chunk_size, num_iterations - done)
            nlls = torch.stack([self.outer_step(state) for _ in range(n)])
            if nan_check and not bool(torch.isfinite(nlls).all()):
                bad = int(torch.nonzero(~torch.isfinite(nlls))[0, 0])
                diag = {k: bool(torch.isfinite(v).all())
                        for k, v in state.params.leaves().items()}
                raise FloatingPointError(
                    f"non-finite nll at iteration {done + bad}; "
                    f"finite-by-block: {diag}. For ill-conditioned fp32 "
                    f"runs try fp64 or a larger jitter (cfg.jitter).")
            traces.append(nlls)
            done += n
        if not traces:
            return state, torch.zeros((0,), dtype=state.params.x.dtype,
                                      device=state.params.x.device)
        return state, torch.cat(traces)
