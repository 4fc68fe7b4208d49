"""Multi-seed ensemble pooling of the posterior predictive.

Counterpart of ``ffvd_tpu/eval/ensemble.py``.  A single chain's rollout
estimator (``predict_summary``) averages within-chain variances only, so
the chain-to-chain spread of modes is invisible to it and the 30-step NLL
of one chain can explode (PARITY §2d/§2e).  Pooling C independently
trained chains as an equal-weight mixture, with the mixture's total
variance (within-chain variance + the spread of predictive means), gives
calibrated free-run uncertainty.  Chains train one after another on the
model's device; pooling is on the host in float64 numpy (T×P arrays).
``multichain_moments`` takes the chains of one ``MultiChainTrainer``
instead, trained together, and rolls all of them out in one launch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


@torch.no_grad()
def multichain_moments(mct, state, test_len: int, num: Optional[int] = None,
                       spacing: Optional[int] = None,
                       generator: Optional[torch.Generator] = None,
                       thin_generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       thin_noise=None):
    """Chain moments of a chain-stacked ``parallel.MultiChainTrainer``
    state (``ffvd_tpu/eval/ensemble.py:105-148``).  Returns (one
    ``chain_moments``-shaped tuple per chain, for ``pool_moments``; the
    stacked state after thinning).

    A sampler case thins every chain at once on the batched gradient
    (``eval.rollout.thin_posterior``; normals from ``thin_generator``, or
    ``thin_noise`` path → (C, S, spacing, ...)).  The C×S rollouts are then
    one ``rollout_batched`` launch: chain c's sample s is row c·S+s, and an
    iid chain's inputs are repeated over its S rows.  LinearK and deep
    chains roll out by ``recursion_rollout``.  ``noise`` (C, S, T, D)
    replaces the head's rollout noise drawn from ``generator`` (a deep
    model's inter-layer noise is drawn from it too).

    The emission moments use each chain's params after thinning, as JAX's
    do: the rollouts came from the moved chain.

    On a mesh (``MultiChainTrainer(mesh=)``) each process thins its own
    chains and dims with its share of the draws; the first process of each
    'ep' group rolls out its chains' rows [c0·S, c1·S) with all D dims in
    one launch whose Philox rows start at c0·S (``row_offset``), so the
    rows are those of one launch of all C×S; the rollouts are then summed
    into every process, which returns every chain's moments and its own
    share of the thinned state.  The seed is drawn on every process."""
    from ffvd_tpu_torch.eval.rollout import (posterior_inputs,
                                             recursion_rollout,
                                             rollout_controls, thin_posterior)
    from ffvd_tpu_torch.model.deep import hidden_normals
    from ffvd_tpu_torch.ops import rollout as rollout_ops
    from ffvd_tpu_torch.ops.kernels import KernelParams
    from ffvd_tpu_torch.parallel.distributed import all_sum_flat
    from ffvd_tpu_torch.parallel.sharding import (axis_index, gather_leaves,
                                                  member)

    cfg, c = mct.cfg, mct.n
    mesh = mct.mesh
    c_all, c0 = mct.n_whole, mct.place.members[0]
    num = num or cfg.num_posterior_samples
    spacing = spacing or cfg.posterior_sample_spacing
    r0, r1 = c0 * num, (c0 + c) * num       # this process's rows
    controls = rollout_controls(mct.data, test_len)
    x = state.params.x
    d = x.shape[-1]
    if mct.has_sghmc:
        samples, state = thin_posterior(mct, state, num, spacing,
                                        thin_generator, thin_noise)
        samples = [mct.whole_dims(p) for p in samples]
        rows = [member(samples[s], i) for i in range(c) for s in range(num)]
    else:
        full = mct.whole_dims(state.params)
        rows = [member(full, i) for i in range(c)]
    # One process of an 'ep' group rolls its chains out.
    launch = axis_index(mesh, "ep") == 0
    if cfg.kernel_type != "SquaredExponential" or cfg.n_layers > 1:
        n_hidden = len(state.params.hidden)
        if noise is None:
            noise = hidden_normals(1, (c_all, num, test_len), d, generator,
                                   x.dtype, x.device)[0]
        hidden_noise = [e[r0:r1] for e in hidden_normals(
            n_hidden, (c_all * num, test_len), d, generator, x.dtype,
            x.device)]
        noise = noise.reshape(c_all * num, test_len, d)[r0:r1]
        per = num if len(rows) == c else 1        # rows sharing params
        rolls = [recursion_rollout(
            mct, p, controls, noise[r * per:(r + 1) * per],
            [e[r * per:(r + 1) * per] for e in hidden_noise])
            for r, p in enumerate(rows if launch else ())]
        if launch:
            xs = torch.cat([r[0] for r in rolls])
            vs = torch.cat([r[1] for r in rolls])
    elif launch:
        inp = posterior_inputs(mct, rows)
        if len(rows) == c:                        # iid: S rows a chain
            rep = lambda t: (None if t is None
                             else t.repeat_interleave(num, dim=0))
            kp = inp.pop("kparams")
            inp = {k: rep(v) for k, v in inp.items()}
            inp["kparams"] = KernelParams(rep(kp.log_variance),
                                          rep(kp.log_lengthscales))
        xs, vs = rollout_ops.rollout_batched(
            controls=controls, generator=generator, row_offset=r0,
            noise=None if noise is None
            else noise.reshape(c_all * num, test_len, d)[r0:r1], **inp)
    elif noise is None:
        rollout_ops.draw_seed(generator)          # the launch's seed
    emission = {k: state.params.leaves()[k] for k in ("c", "d", "log_rchol")}
    if mesh is not None:
        # Every process's rows, and every chain's emission parameters.
        xs_all = x.new_zeros((2, c_all * num, test_len, d))
        if launch:
            xs_all[0, r0:r1], xs_all[1, r0:r1] = xs, vs
        xs, vs = all_sum_flat([xs_all], dist.group.WORLD)[0]
        emission = gather_leaves(emission, mct.place, mesh)
    xs = xs.reshape(c_all, num, test_len, d)
    vs = vs.reshape(c_all, num, test_len, d)
    full_r = use_full_r(cfg.emission_noise, emission["c"].shape[-1])
    p0 = member(state.params, 0)
    chains = []
    for i in range(c_all):
        p = dataclasses.replace(p0, **{k: v[i] for k, v in emission.items()})
        chains.append((_f64(xs[i] @ p.c + p.d), _f64(vs[i] @ (p.c * p.c)),
                       _f64(p.r_var_diag if full_r else p.rchol_diag ** 2)))
    return chains, state


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
