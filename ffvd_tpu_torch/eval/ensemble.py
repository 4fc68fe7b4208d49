"""Multi-seed ensemble pooling of the posterior predictive.

Counterpart of ``ffvd_tpu/eval/ensemble.py``.  A single chain's rollout
estimator (``predict_summary``) averages within-chain variances only, so
the chain-to-chain spread of modes is invisible to it and the 30-step NLL
of one chain can explode (PARITY §2d/§2e).  Pooling C independently
trained chains as an equal-weight mixture, with the mixture's total
variance (within-chain variance + the spread of predictive means), gives
calibrated free-run uncertainty.  Chains train one after another on the
model's device; pooling is on the host in float64 numpy (T×P arrays).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ffvd_tpu_torch.model.likelihoods import use_full_r

Chain = Tuple[np.ndarray, np.ndarray, np.ndarray]  # y_s (S,T,P), v_s, r2 (P,)


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


@torch.no_grad()
def chain_moments(model, noise: Optional[torch.Tensor] = None) -> Chain:
    """Per-sample emission-space moments of one fitted ``FFVDModel``: the
    protocol's S posterior rollouts over the test half (through
    ``eval_trainer``, thinning the chain where it has SG-HMC leaves) pushed
    through the emission before any averaging, so chains can pool.
    ``noise`` (S, T, D) replaces the rollout's drawn noise."""
    xs, vs = model._collect(model.dataset.n_test, noise=noise)
    p = model.params
    y_s = _f64(xs @ p.c + p.d)
    v_s = _f64(vs @ (p.c * p.c))
    r2 = _f64(p.r_var_diag if use_full_r(model.cfg.emission_noise,
                                         p.c.shape[1])
              else p.rchol_diag ** 2)
    return y_s, v_s, r2


def pool_moments(chains: Sequence[Chain], include_spread: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Equal-weight mixture moments over the chains' pooled samples: the
    mean of all predictive means; the mean within-sample variance plus the
    mean emission noise, plus, when ``include_spread``, the variance of the
    predictive means across all pooled samples (the law of total variance).
    ``include_spread=False`` is the single-chain estimator applied to the
    pool, for ablation."""
    y_all = np.concatenate([c[0] for c in chains], axis=0)
    v_all = np.concatenate([c[1] for c in chains], axis=0)
    r2 = np.mean([c[2] for c in chains], axis=0)
    py = y_all.mean(axis=0)
    pv = v_all.mean(axis=0) + r2
    if include_spread:
        pv = pv + y_all.var(axis=0)
    return py, pv


def _metrics(py, pv, y_test, y_train_std, horizon):
    yt = np.asarray(y_test, np.float64)[:horizon].reshape(-1)
    yp = py[:horizon].reshape(-1)
    vp = pv[:horizon].reshape(-1)
    rmse = float(np.sqrt(np.mean((yt - yp) ** 2)) * y_train_std)
    nll = float(-np.mean(-0.5 * np.log(2 * math.pi * vp)
                         - 0.5 * (yt - yp) ** 2 / vp))
    return rmse, nll


def ensemble_evaluate(models: List, horizon: int = 30,
                      include_spread: bool = True,
                      noise: Optional[Sequence[torch.Tensor]] = None) -> dict:
    """Pooled mixture metrics and per-chain protocol metrics for C fitted
    models of one dataset.  ``noise``, one (S, T, D) tensor per model,
    replaces the rollouts' drawn noise.  Returns {rmse, nll, nll_no_spread,
    predict_y, predict_y_var, per_chain}."""
    ds = models[0].dataset
    chains = [chain_moments(m, None if noise is None else noise[i])
              for i, m in enumerate(models)]
    py, pv = pool_moments(chains, include_spread=include_spread)
    rmse, nll = _metrics(py, pv, ds.y_test, ds.y_train_std, horizon)
    py_ns, pv_ns = pool_moments(chains, include_spread=False)
    _, nll_ns = _metrics(py_ns, pv_ns, ds.y_test, ds.y_train_std, horizon)
    per = []
    for y_s, v_s, r2 in chains:
        r, n = _metrics(y_s.mean(axis=0), v_s.mean(axis=0) + r2,
                        ds.y_test, ds.y_train_std, horizon)
        per.append({"rmse": r, "nll": n})
    return {"rmse": rmse, "nll": nll, "nll_no_spread": nll_ns,
            "predict_y": py, "predict_y_var": pv, "per_chain": per}


def fit_ensemble(cfg, n_chains: int, device=None, dtype=None,
                 seeds: Optional[Sequence[int]] = None,
                 init_jitter: float = 0.0, **fit_kwargs) -> List:
    """Train C independent chains of one config (seeds cfg.seed,
    cfg.seed+1, … unless given) one after another on ``device`` and return
    the fitted ``FFVDModel``s.

    Seeds change only the random streams of stochastic protocols (SG-HMC,
    particle Gibbs, windows, deep): a full-batch Adam case (C1/C4) is
    deterministic given its warm start, so its chains are bit-identical.
    ``init_jitter`` adds N(0, jitter²) to every leaf of chains 1…C−1's warm
    start, drawn from a CPU ``torch.Generator`` seeded with ``seed ^
    0x5EED``, so that deterministic chains reach different optima; chain 0
    keeps the exact warm start.  ``seeds`` keeps the signature of the JAX
    package's ``fit_ensemble``, which the port mirrors."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.model.params import GPSSMParams

    seeds = list(seeds) if seeds is not None else [
        cfg.seed + i for i in range(n_chains)]
    models = []
    for i, s in enumerate(seeds):
        m = FFVDModel(dataclasses.replace(cfg, seed=s), device=device,
                      dtype=dtype)
        if init_jitter and i > 0:
            g = torch.Generator().manual_seed(s ^ 0x5EED)
            with torch.no_grad():
                leaves = {k: v + init_jitter * torch.randn(
                    v.shape, generator=g, dtype=v.dtype).to(v.device)
                    for k, v in m.params.leaves().items()}
            m.state = m.trainer.init_state(GPSSMParams.from_leaves(leaves))
        m.fit(**fit_kwargs)
        models.append(m)
    return models
