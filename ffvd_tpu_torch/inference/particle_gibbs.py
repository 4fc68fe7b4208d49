"""Particle Gibbs (conditional SMC) for the latent trajectory — case C6.

Counterpart of ``ffvd_tpu/inference/particle_gibbs.py`` (the rebuild of the
reference's ``PG_for_X_speedup``, base_model.py:78-141), with the same
names.  P−1 free particles go through the GP transition
(``model.conditionals.gp_transition``) with one Kmm factorisation a sweep,
are weighted by the emission likelihood of y_t and resampled, with the
current trajectory kept as the reference particle.  A deep model first
sends the particle block through its hidden layers
(``model.deep.propagate_step``) with fresh per-particle normals, the hidden
layers' Kmm factorised once a sweep too (particle_gibbs.py:81-112).

Two styles, as in the JAX package (``cfg.pg_ancestor_trace``):

- ``pg_ancestor_style`` (the default): resample parents, propagate from
  them, backtrack the ancestry from a weight-proportional final draw, which
  gives a coherent draw from the smoothing posterior;
- ``pg_reference_style``: the reference's storage of the resampled states
  per time, and a uniform final choice of a column.

Every random number of a sweep is drawn up front, one call per array
(``pg_draws``), or injected (``draws=``), so the tests can feed both
packages JAX's draws.  Resampling is Gumbel-max, ``argmax(logits + G)``,
which is how ``jax.random.categorical`` samples.  Nothing in a sweep reads
a value back to the host: indices stay on the device (``argmax``,
``index_select``, ``gather``, ``torch.where``) and ``kernel_precal``'s
Cholesky retry is branch-free (``ops/chol.py``), so the whole sweep can be
captured in a CUDA graph.

Several independent sweeps, the chains or datasets of
``parallel.BatchedTrainer``, run as one (``batched_sweep``): the
one-member sweep under ``torch.func.vmap`` over a leading member axis of
the params, the draws and, on a dataset axis, the data, as the JAX
package's ``jax.vmap(outer_step)`` does.  Each of the sweep's kernels then
covers every member, and each member factorises its own Kmm in one batched
Cholesky.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.model.conditionals import (Precal, gp_transition,
                                               kernel_precal)
from ffvd_tpu_torch.model.deep import hidden_precals, propagate_step
from ffvd_tpu_torch.model.likelihoods import (emission_log_lik_rows,
                                              emission_mean)
from ffvd_tpu_torch.model.params import GPSSMParams, SSMData

Draws = Dict[str, torch.Tensor]
Stats = Dict[str, torch.Tensor]


def _occupancy(idx: torch.Tensor, pp: int, dtype):
    """(unique-count, ref-survived) of each step's categorical index draw,
    idx (n, K), over a pool of ``pp`` (the reference particle is pool slot
    pp-1): one scatter for all steps, out of place, so that it batches
    under ``torch.func.vmap``.  Returns two (n,) tensors."""
    counts = torch.zeros((idx.shape[0], pp), dtype=dtype,
                         device=idx.device).scatter_add(
        1, idx, torch.ones(idx.shape, dtype=dtype, device=idx.device))
    return torch.sum(counts > 0, dim=1), counts[:, pp - 1] > 0


def _weights(params: GPSSMParams, pool: torch.Tensor, y_t: torch.Tensor,
             emission_noise: str) -> torch.Tensor:
    """Emission log-likelihood of y_t for each pool row (P,): the free
    particles and, last, the reference particle."""
    return emission_log_lik_rows(
        params, y_t, emission_mean(pool, params.c, params.d), emission_noise)


def _stats(new_x: torch.Tensor, old_x: torch.Tensor, idx: torch.Tensor,
           accepted: torch.Tensor, pp: int) -> Stats:
    """The mixing diagnostics of a sweep (see ``make_pg_fn``) from its new
    and old x, its resampling indices (n, P−1) and whether it left the
    reference trajectory."""
    uniq, ref_ok = _occupancy(idx, pp, new_x.dtype)
    dx = torch.abs(new_x - old_x)
    return {
        "ref_survival": torch.mean(ref_ok.to(new_x.dtype)),
        "unique_frac": torch.mean(uniq.to(new_x.dtype)) / pp,
        "accepted": accepted.to(new_x.dtype),
        "dx_mean_abs": torch.mean(dx),
        "dx_frac_moved": torch.mean(torch.any(dx > 0, dim=-1)
                                    .to(new_x.dtype)),
    }


def _gumbel(shape, generator, dtype):
    """Standard Gumbel draws, −log(−log U), as ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


def pg_draws(cfg: FFVDConfig, params: GPSSMParams,
             generator: Optional[torch.Generator]) -> Draws:
    """One sweep's random numbers, one call per array, on the params'
    device and in their dtype:

      particles0  (P−1, D)     initial free particles, standard normal
      normals     (n, P−1, D)  propagation noise
      gumbels     (n, P−1, P)  resampling Gumbels
      final       (P,) Gumbels (ancestor style) or (1,) int64 in [0, P)
                  (reference style): the final choice
      hidden      (n, L−1, P−1, D) inter-layer normals, deep models only."""
    if generator is None:
        raise ValueError("the particle-Gibbs sweep needs a torch.Generator "
                         "or injected draws (pg=)")
    pp, n, d = cfg.pg_particles, params.n_transitions, params.x_dim
    dtype, dev = params.x.dtype, params.x.device
    normal = lambda *shape: torch.randn(shape, generator=generator,
                                        dtype=dtype, device=generator.device)
    out = {"particles0": normal(pp - 1, d), "normals": normal(n, pp - 1, d),
           "gumbels": _gumbel((n, pp - 1, pp), generator, dtype)}
    if cfg.pg_ancestor_trace:
        out["final"] = _gumbel((pp,), generator, dtype)
    else:
        out["final"] = torch.randint(0, pp, (1,), generator=generator,
                                     device=generator.device)
    if params.hidden:
        out["hidden"] = normal(n, len(params.hidden), pp - 1, d)
    return {k: v.to(dev) for k, v in out.items()}


def _step_fn(cfg: FFVDConfig, params: GPSSMParams, pre: Precal,
             draws: Draws):
    """x_t (R, D), ctrl, eps, t → x_{t+1} (R, D) for this sweep's params;
    a deep model's particles first pass the hidden layers with the step's
    normals ``draws["hidden"][t]``."""
    q = params.q
    hpre = hidden_precals(cfg.kernel_type, cfg.jitter, params.hidden)

    def step(x_t, ctrl, eps, t):
        h = None
        if params.hidden:
            h = propagate_step(cfg.kernel_type, cfg.jitter, params.hidden,
                               hpre, x_t, ctrl, draws["hidden"][t])
        return gp_transition(cfg.kernel_type, params.kernel, pre, params.z,
                             params.u, q, x_t, ctrl, eps, h_t=h)[0]
    return step


@torch.no_grad()
def pg_reference_style(cfg: FFVDConfig, params: GPSSMParams, pre: Precal,
                       data: SSMData, draws: Draws
                       ) -> Tuple[torch.Tensor, Stats, Dict]:
    """The reference's CSMC (base_model.py:78-141): store the resampled
    states per time, pick a column uniformly at the end.  Returns (new x,
    stats, picks), picks = {"resampled": (n, P−1) indices into the pool,
    "final": the column draw}."""
    pp, n = cfg.pg_particles, params.n_transitions
    step = _step_fn(cfg, params, pre, draws)
    controls, x_ref = data.control[:n], params.x[1:]
    x_t = draws["particles0"]
    seq, idxs = [x_t], []
    for t in range(n):
        x_next = step(x_t, controls[t], draws["normals"][t], t)
        pool = torch.cat([x_next, x_ref[t:t + 1]], dim=0)      # (P, D)
        logits = _weights(params, pool, data.y[t], cfg.emission_noise)
        idx = torch.argmax(draws["gumbels"][t] + logits, dim=-1)
        x_t = pool.index_select(0, idx)                         # (P−1, D)
        seq.append(x_t)
        idxs.append(idx)
    trajectory = torch.stack(seq)                               # (n+1, P−1, D)
    idxs = torch.stack(idxs)                                    # (n, P−1)

    # Uniform choice among P columns; column P−1 means "keep reference".
    choice = draws["final"]
    col = trajectory.index_select(1, torch.clamp(choice, max=pp - 2))[:, 0]
    accepted = choice[0] < pp - 1
    new_x = torch.where(accepted, col, params.x)
    return (new_x, _stats(new_x, params.x, idxs, accepted, pp),
            {"resampled": idxs, "final": choice})


@torch.no_grad()
def pg_ancestor_style(cfg: FFVDConfig, params: GPSSMParams, pre: Precal,
                      data: SSMData, draws: Draws
                      ) -> Tuple[torch.Tensor, Stats, Dict]:
    """Proper CSMC: resample parents, propagate from them, keep the
    reference as particle P; backtrack ancestors from a weight-proportional
    final draw → a coherent smoothing-posterior sample.  Returns (new x,
    stats, picks), picks = {"ancestors": (n, P) parent of each particle,
    "final": the lane the backtrack starts from}."""
    pp, n = cfg.pg_particles, params.n_transitions
    step = _step_fn(cfg, params, pre, draws)
    controls, x_ref = data.control[:n], params.x[1:]
    x_t = torch.cat([draws["particles0"], params.x[:1]], dim=0)  # (P, D)
    logits = torch.zeros(pp, dtype=x_t.dtype, device=x_t.device)
    states, parents = [x_t], []
    for t in range(n):
        par = torch.argmax(draws["gumbels"][t] + logits, dim=-1)
        x_free = step(x_t.index_select(0, par), controls[t],
                      draws["normals"][t], t)
        x_t = torch.cat([x_free, x_ref[t:t + 1]], dim=0)       # (P, D)
        logits = _weights(params, x_t, data.y[t], cfg.emission_noise)
        states.append(x_t)
        parents.append(par)
    parents = torch.stack(parents)                              # (n, P−1)
    # The reference keeps its lane: ancs[t, P−1] = P−1.
    ancs = torch.cat([parents, torch.full((n, 1), pp - 1, dtype=torch.int64,
                                          device=x_t.device)], dim=1)

    j_final = torch.argmax(draws["final"] + logits, dim=-1).reshape(1)
    # Backtrack: the lane of x_{t+1} is j[t+1], its parent's j[t] =
    # ancs[t, j[t+1]]; then one gather of every x_t from its lane.
    js = [j_final]
    for t in reversed(range(n)):
        js.append(ancs[t].index_select(0, js[-1]))
    lanes = torch.stack(js[::-1])                               # (n+1, 1)
    states = torch.stack(states)                                # (n+1, P, D)
    new_x = torch.gather(states, 1, lanes[:, :, None].expand(
        -1, -1, states.shape[2]))[:, 0]
    # The reference lane is slot pp-1 at every step, so the selected
    # lineage is the retained trajectory iff the final draw lands on it.
    return (new_x, _stats(new_x, params.x, parents, j_final[0] < pp - 1, pp),
            {"ancestors": ancs, "final": j_final})


def make_pg_fn(cfg: FFVDConfig, data: Optional[SSMData] = None,
               with_stats: bool = False) -> Callable:
    """Returns pg_fn(params, generator=None, data=None, draws=None) ->
    params with a resampled trajectory (or (params, stats) when
    ``with_stats``).  ``data`` may be bound here or passed per call;
    ``draws`` (see ``pg_draws``) replaces the draws from ``generator``.
    The new x is a fresh tensor outside autograd; the other leaves are the
    caller's.

    ``with_stats``: also return the per-sweep mixing diagnostics —
      ref_survival   fraction of steps where the reference particle
                     survives resampling into the free pool,
      unique_frac    mean fraction of distinct pool members selected,
      accepted       1.0 when the sweep replaced x with a non-reference
                     trajectory,
      dx_mean_abs    mean |new_x − old_x|,
      dx_frac_moved  fraction of trajectory rows that changed."""
    bound_data = data

    if cfg.pg_compat_noop:
        # The reference's PG assign is dead in its graph (see
        # FFVDConfig.pg_compat_noop in the JAX package): x is left as it is.
        def noop(params, generator=None, data=None, draws=None):
            if with_stats:
                z = params.x.new_zeros(())
                return params, {"ref_survival": z + 1.0, "unique_frac": z,
                                "accepted": z, "dx_mean_abs": z,
                                "dx_frac_moved": z}
            return params
        return noop

    style = pg_ancestor_style if cfg.pg_ancestor_trace else pg_reference_style

    @torch.no_grad()
    def pg_fn(params: GPSSMParams,
              generator: Optional[torch.Generator] = None,
              data: Optional[SSMData] = None,
              draws: Optional[Draws] = None):
        data = bound_data if data is None else data
        pre = kernel_precal(cfg.kernel_type, params.kernel, params.z,
                            cfg.jitter)
        if draws is None:
            draws = pg_draws(cfg, params, generator)
        new_x, stats, _ = style(cfg, params, pre, data, draws)
        params = dataclasses.replace(params, x=new_x)
        return (params, stats) if with_stats else params
    return pg_fn


def stack_draws(draws: Sequence[Draws]) -> Draws:
    """Per-member sweep draws (``pg_draws``'s dicts) stacked on a leading
    member axis."""
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


@torch.no_grad()
def batched_sweep(pg_fn: Callable, params: GPSSMParams, data: SSMData,
                  draws: Draws, data_axis: bool = False) -> torch.Tensor:
    """The sweeps of n members as one: ``pg_fn`` (``make_pg_fn``'s, the
    sweep of one member from injected draws) under ``torch.func.vmap`` over
    the leading member axis of every leaf of ``params``, of ``draws``
    (``stack_draws``) and, with ``data_axis``, of ``data``'s y and control
    (one dataset per member; otherwise all members share ``data``).
    ``kernel_precal`` runs inside the map, so every member's Kmm is
    factorised in one batched Cholesky.  Returns the n new trajectories
    (n, N+1, D); member i's equals ``pg_fn(member i, data i, draws i)``'s.
    An op without a batching rule falls back to functorch's per-member loop
    unless the caller turns that off (``parallel.sharding.
    no_vmap_fallback``, as ``BatchedTrainer`` does)."""
    def one(leaves, dr, y, control):
        return pg_fn(GPSSMParams.from_leaves(leaves), None,
                     SSMData(y=y, control=control), draws=dr).x

    dd = 0 if data_axis else None
    return torch.func.vmap(one, in_dims=(0, 0, dd, dd))(
        params.leaves(), draws, data.y, data.control)
