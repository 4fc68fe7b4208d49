"""Posterior collection and free-running rollout prediction.

Counterpart of ``ffvd_tpu/eval/rollout.py`` (rebuild of
``collect_samples_formal``, base_model.py:197-522).  Per sample (reference
semantics):

  - (if SG-HMC leaves exist) run ``spacing`` sample-only SG-HMC updates,
    continuing the chain, then factorise that sample's Kmm (:227-234);
  - (if U collapsed) compute q(U) = N(H⁻¹a, H⁻¹) from the training
    trajectory (:242-253);
  - free-run from the last training state x_N (:237): per step
    x ← x + f_mu + N(0, f_var + Q) (:296-302), recording x and f_var + Q.

Without SG-HMC leaves (C1, C4, C6) the samples are iid and share one set
of parameters: one ``ops.rollout.rollout`` call.  With them (C2, C3, C5,
C7, hyperparameter sampling) each sample has its own hypers, Z, U or q(U),
Q and x_N, and all S go to one ``ops.rollout.rollout_batched`` call.  On
the card either is one launch of the CUDA kernel.

The kernel is SE-ARD and shallow only, as the JAX package's Pallas rollout
is (pallas_rollout.py:148).  A LinearK config and a deep one
(``cfg.n_layers > 1``) take ``recursion_rollout``, a torch recursion of
``gp_transition`` (after ``model.deep.propagate_step`` through the hidden
layers, for a deep model): the port of the JAX package's production
rollout, a ``lax.scan`` of the same step, ``vmap``ped over the samples
and the chains.  Here too every row goes through one recursion: G
parameter sets of R rows each (iid samples G=1, R=S; a thinned chain's
samples G=S, R=1; chains G=C, R=S; thinned chains G=C×S, R=1), each step
run once for all of them under ``torch.func.vmap`` over G.  On the card
that step is captured once in a CUDA graph and replayed T times
(``_RolloutGraph``), the draws copied in once an evaluation.
``cfg.kernel_type`` and ``cfg.n_layers`` alone choose the path.

Under ``cfg.collapse_precision`` "ds64" or "hybrid", for every case and
both paths, the head's Kmm factors come from ``ds_precal`` and a collapsed
q(U) from ``ds_collapsed_u_posterior`` (the float64 segment,
``model/ds_collapse.py``), as JAX's ``_rollout_one(ds64=...)`` does: at the
sharply trained points that mode reaches, fp32 factors of H inflate the
rollout variance (PARITY §2f).  They are float32, promoted to the params'
dtype in an fp64 run.

Metrics (base_model.py:340-349, :629):
  ŷ   = mean_samples(x C) + d,   v̂ = mean_samples(x_var C²) + R
  RMSE = sqrt(mean((Y_test[:30] − ŷ[:30])²)) · Y_train_std
  NLL  = −mean log N(y; ŷ, sqrt(v̂)) over the same 30 steps (normalised).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional

import torch

from ffvd_tpu_torch.inference.sghmc import SGHMCState
from ffvd_tpu_torch.inference.trainer import Trainer, TrainState, _assign
from ffvd_tpu_torch.model.conditionals import (Precal, collapsed_u_posterior,
                                               gp_transition, kernel_precal)
from ffvd_tpu_torch.model.deep import (hidden_normals, hidden_precals,
                                       propagate_step)
from ffvd_tpu_torch.model.ds_collapse import (ds_collapsed_u_posterior,
                                              ds_precal)
from ffvd_tpu_torch.model.elbo import gp_inputs
from ffvd_tpu_torch.model.likelihoods import emission_mean, use_full_r
from ffvd_tpu_torch.model.params import (GPSSMParams, HiddenLayerParams,
                                         SSMData)
from ffvd_tpu_torch.ops import rollout as rollout_ops
from ffvd_tpu_torch.ops.kernels import KernelParams
from ffvd_tpu_torch.parallel.sharding import no_vmap_fallback, stack_members
from ffvd_tpu_torch.utils import graphs
from ffvd_tpu_torch.utils.profiling import span, spanned


def _ds64(cfg) -> bool:
    """Does evaluation take the float64 segment (rollout.py:122-129)?"""
    return cfg.collapse_precision in ("ds64", "hybrid")


def rollout_precal(cfg, params: GPSSMParams) -> Precal:
    """The head's Kmm factors for the rollout: ``ds_precal``'s under
    ds64/hybrid (float32, promoted to the params' dtype), else
    ``kernel_precal``'s."""
    if not _ds64(cfg):
        return kernel_precal(cfg.kernel_type, params.kernel, params.z,
                             cfg.jitter)
    pre = ds_precal(cfg.kernel_type, params.kernel, params.z, cfg.jitter)
    return Precal(lm=pre.lm.to(params.z.dtype),
                  lm_inv=pre.lm_inv.to(params.z.dtype))


def u_and_qsqrt(trainer: Trainer, params: GPSSMParams, data: SSMData,
                pre: Precal):
    """(U, q_sqrt) for the rollout: the collapsed q(U) mean and its upper
    factor chol(H)⁻ᵀ, or the trained U and None when U is not collapsed.
    A deep model's training inputs are mean-propagated through its hidden
    layers: the collapse is a point summary (rollout.py:131-161).  ``pre``
    is read by the native collapse only; under ds64/hybrid the float64
    segment factorises Kmm itself."""
    cfg = trainer.cfg
    if not cfg.case_config.u_collapse:
        return params.u, None
    xc = gp_inputs(params, data, kernel_type=cfg.kernel_type,
                   jitter=cfg.jitter)
    if _ds64(cfg):
        u_val, q_sqrt = ds_collapsed_u_posterior(
            cfg.kernel_type, params.kernel, params.z, params.x, xc,
            params.log_q, jitter=cfg.jitter)
        u_val, q_sqrt = u_val.to(params.z.dtype), q_sqrt.to(params.z.dtype)
    else:
        u_val, q_sqrt = collapsed_u_posterior(
            cfg.kernel_type, params.kernel, pre, params.z, params.x, xc,
            params.q)
    if cfg.rollout_qsqrt_dim0:
        # reference slip compat (conditionals_multi_output.py:322): dim 0's
        # q(U) factor applied to every dim's variance
        q_sqrt = q_sqrt[:1].expand(q_sqrt.shape)
    return u_val, q_sqrt


def _thin_move(trainer: Trainer, params: GPSSMParams, generator,
               sub: Dict[str, torch.Tensor], sstate: SGHMCState, d: dict):
    """One sample-only sub-step of the chain (``sub``, ``sstate``) on the
    full-batch gradient at ``params``: ``d`` may hold its ``noise`` and a
    deep model's inter-layer normals ``eps``, else they are drawn from
    ``generator``."""
    eps = d.get("eps")
    if trainer.stochastic and eps is None:
        x = params.x
        eps = [trainer._share(p) for p in hidden_normals(
            len(params.hidden), trainer._whole_lead() + (x.shape[-2] - 1,),
            x.shape[-1], generator, x.dtype, x.device)]
    return trainer.sghmc_move(sub, sstate, params, False, d.get("noise"),
                              generator, eps=eps)


class _ThinGraph:
    """``_thin_move`` on static chain buffers, as a ``utils.graphs.
    StepGraph`` whose calls take the trainer; bound to the fixed leaves of
    ``params``, the data and the generator (``fp``) and to the draws'
    signature (``sig``)."""

    def __init__(self, params, generator, sub, sstate, d, fp,
                 capture: bool):
        sub = self.sub = {k: v.clone() for k, v in sub.items()}
        sstate = self.sstate = sstate.map(torch.clone)

        def body(dd, trainer):
            new, ss = _thin_move(trainer, params, generator, sub, sstate, dd)
            with torch.no_grad():
                _assign(sub, new)
                sstate.assign_(ss)

        self.graph = graphs.StepGraph(body, d, capture, generator)
        self.fp, self.sig = fp, (capture, graphs.signature(d))

    def load(self, sub, sstate) -> None:
        """Start the chain from ``sub``, ``sstate``."""
        with torch.no_grad():
            _assign(self.sub, sub)
            self.sstate.assign_(sstate)


@spanned("ffvd::eval.thin")
@graphs.scoped
def thin_posterior(trainer: Trainer, state: TrainState, num: int,
                   spacing: int, generator: Optional[torch.Generator] = None,
                   thin_noise: Optional[Dict[str, torch.Tensor]] = None,
                   thin_prop: Optional[List[torch.Tensor]] = None,
                   capture: Optional[bool] = None):
    """Continue the SG-HMC chain: per sample, ``spacing`` sample-only
    sub-steps of the SG-HMC leaves (base_model.py:227-231), full batch.  A
    deep (stochastic) trainer draws fresh inter-layer normals for every
    sub-step's gradient, as training does (rollout.py:176-209).
    ``thin_noise`` (path → (num, spacing, ...)) and ``thin_prop`` (one
    (num, spacing, N, D) tensor per hidden layer) replace the normals drawn
    from ``generator``.  Returns (the ``num`` thinned params, the state
    with the moved chain); ``state`` itself is left as it was.  A
    ``parallel.BatchedTrainer`` thins every member at once on the batched
    gradient; its state, samples and injected normals carry the member
    axis first; a process of a sharded run keeps its share of each draw
    (``Trainer._share``).

    ``capture`` (as in ``Trainer.run``; by default on the card): each
    sub-step is one replay of a captured sub-step (``utils/graphs.py``),
    the counterpart of ``build_collect``'s thinning scan, with its injected
    normals copied into static buffers.  A sample is a copy of the chain's
    buffers.  The trainer keeps the graph for its next call, unless the
    step all-reduces over NCCL (``utils.graphs.graph_scope``)."""
    return _thin(trainer, state, num, spacing, generator, thin_noise,
                 thin_prop, trainer.capture_mode(state, capture) or None)


def _thin(trainer: Trainer, state: TrainState, num: int, spacing: int,
          generator, thin_noise, thin_prop, graph: Optional[bool]):
    """``thin_posterior``: eagerly (``graph`` None), or through the
    sub-step's graph, captured (True) or run plainly (False, the CPU
    tests' view of what the card captures)."""
    subset = trainer.subset
    params = state.params
    sub = {k: v.detach() for k, v in subset.split(params).items()}
    sstate = state.sghmc
    lead = trainer.lead
    pick = lambda v, i, j: v[(slice(None),) * len(lead) + (i, j)]

    def draws(i, j) -> dict:
        d = {}
        if thin_noise is not None:
            d["noise"] = trainer._share_tree({k: pick(v, i, j)
                                              for k, v in thin_noise.items()})
        if thin_prop is not None and trainer.stochastic:
            d["eps"] = [trainer._share(pick(p, i, j)) for p in thin_prop]
        return d

    if graph is not None:
        fixed = [v for k, v in params.leaves().items()
                 if k not in subset.paths]
        fp = graphs.fingerprint(generator,
                                fixed + graphs.data_tensors(trainer))
        g = getattr(trainer, "_thin_graph", None)
        if g is None or g.fp != fp or g.sig != (graph,
                                                graphs.signature(draws(0, 0))):
            g = trainer._thin_graph = _ThinGraph(
                params, generator, sub, sstate, draws(0, 0), fp, graph)
        g.load(sub, sstate)
        sub, sstate = g.sub, g.sstate
        step = g.graph

        def move(sub, sstate, d):
            step(d, trainer)
            return sub, sstate
        keep = torch.clone
    else:
        def move(sub, sstate, d):
            return _thin_move(trainer, params, generator, sub, sstate, d)
        keep = lambda t: t
    samples = []
    for i in range(num):
        for j in range(spacing):
            sub, sstate = move(sub, sstate, draws(i, j))
        samples.append(subset.merge({k: keep(v) for k, v in sub.items()},
                                    params))
    return samples, dataclasses.replace(
        state, params=subset.merge({k: keep(v) for k, v in sub.items()},
                                   params), sghmc=sstate.map(keep))


def rollout_inputs(trainer: Trainer, params: GPSSMParams) -> dict:
    """One parameter set's inputs of the rollout kernel, keyed and ordered
    as ``ops.rollout``'s first arguments: the kernel hypers, Z, the head's
    Kmm factor Lm⁻¹, U or the collapsed q(U) mean and factor from
    ``trainer.data``, Q and x_N."""
    pre = rollout_precal(trainer.cfg, params)
    u_val, q_sqrt = u_and_qsqrt(trainer, params, trainer.data, pre)
    return {"kparams": params.kernel, "z": params.z, "lm_inv": pre.lm_inv,
            "u_val": u_val, "q_sqrt": q_sqrt, "q": params.q,
            "x0": params.x[-1]}


def stack_inputs(sets: List[dict]) -> dict:
    """``rollout_inputs`` of several sets stacked on a leading axis, as
    ``rollout_batched`` and ``rollout_grouped`` take them."""
    stack = lambda vs: None if vs[0] is None else torch.stack(vs).detach()
    col = lambda k: [s[k] for s in sets]
    return {k: KernelParams(stack([p.log_variance for p in col(k)]),
                            stack([p.log_lengthscales for p in col(k)]))
            if k == "kparams" else stack(col(k)) for k in sets[0]}


def posterior_inputs(trainer: Trainer, samples: List[GPSSMParams]) -> dict:
    """The rollout's per-sample inputs, stacked on a leading sample axis:
    each sample's Kmm factorisation, its U (or collapsed q(U)), Q and x_N."""
    return stack_inputs([rollout_inputs(trainer, p) for p in samples])


def uses_recursion(cfg) -> bool:
    """Does this config roll out by ``recursion_rollout`` (LinearK, or a
    deep model) rather than the kernel (SE-ARD, shallow)?"""
    return cfg.kernel_type != "SquaredExponential" or cfg.n_layers > 1


def rollout_controls(data: SSMData, test_len: int) -> torch.Tensor:
    """The controls of the first ``test_len`` test steps, zero-padded when
    the control series is shorter."""
    n_train = data.y.shape[0]
    controls = data.control[n_train:n_train + test_len]
    if controls.shape[0] < test_len:
        pad = controls.new_zeros((test_len - controls.shape[0],
                                  controls.shape[1]))
        controls = torch.cat([controls, pad], dim=0)
    return controls.contiguous()


def _rollout_set(trainer: Trainer, params: GPSSMParams
                 ) -> Dict[str, torch.Tensor]:
    """One parameter set's recursion inputs: the head's kernel, Z, Lm⁻¹,
    U or the collapsed q(U) mean and factor, Q and x_N, and each hidden
    layer's u, z, kernel and Lm⁻¹ (its Kmm factorised once)."""
    cfg = trainer.cfg
    pre = rollout_precal(cfg, params)
    u_val, q_sqrt = u_and_qsqrt(trainer, params, trainer.data, pre)
    out = {"log_variance": params.kernel.log_variance,
           "log_lengthscales": params.kernel.log_lengthscales,
           "z": params.z, "lm_inv": pre.lm_inv, "u": u_val, "q": params.q,
           "x0": params.x[-1]}
    if q_sqrt is not None:
        out["q_sqrt"] = q_sqrt
    hpre = hidden_precals(cfg.kernel_type, cfg.jitter, params.hidden)
    for i, (layer, hp) in enumerate(zip(params.hidden, hpre)):
        out.update({f"hidden.{i}.u": layer.u, f"hidden.{i}.z": layer.z,
                    f"hidden.{i}.log_variance": layer.kernel.log_variance,
                    f"hidden.{i}.log_lengthscales":
                        layer.kernel.log_lengthscales,
                    f"hidden.{i}.lm_inv": hp.lm_inv})
    return out


def rollout_sets(trainer: Trainer, params: GPSSMParams
                 ) -> Dict[str, torch.Tensor]:
    """The recursion inputs of G parameter sets stacked on the leading axis
    of every leaf of ``params``, all set up at once under
    ``torch.func.vmap``."""
    one = lambda leaves: _rollout_set(trainer,
                                      GPSSMParams.from_leaves(leaves))
    with no_vmap_fallback():
        return torch.func.vmap(one)(params.leaves())


def _transition(cfg, n_hidden: int, s: Dict[str, torch.Tensor],
                x: torch.Tensor, ctrl: torch.Tensor, eps: torch.Tensor,
                heps: List[torch.Tensor]):
    """One step of one group's R rows (``_rollout_one``'s step): x (R, D)
    through the hidden layers with normals ``heps``, then
    ``gp_transition`` with the head's normals ``eps``; ``s`` is the group's
    set (``_rollout_set``).  Returns (x_next, var_tot), each (R, D)."""
    kt = cfg.kernel_type
    h = None
    if n_hidden:
        layers = [HiddenLayerParams(
            u=s[f"hidden.{i}.u"], z=s[f"hidden.{i}.z"],
            kernel=KernelParams(s[f"hidden.{i}.log_variance"],
                                s[f"hidden.{i}.log_lengthscales"]))
            for i in range(n_hidden)]
        hpre = [Precal(lm=None, lm_inv=s[f"hidden.{i}.lm_inv"])
                for i in range(n_hidden)]
        h = propagate_step(kt, cfg.jitter, layers, hpre, x, ctrl, heps)
    return gp_transition(kt, KernelParams(s["log_variance"],
                                          s["log_lengthscales"]),
                         Precal(lm=None, lm_inv=s["lm_inv"]), s["z"],
                         s["u"], s["q"], x, ctrl, eps, s.get("q_sqrt"),
                         h_t=h)


class _RolloutGraph:
    """One step of the recursion for every row of G groups of R, as a
    ``utils.graphs.StepGraph`` over static buffers: the G sets, the
    controls (T, U) and the whole draws, the head's (G, R, T, D) and each
    hidden layer's.  The step reads its index t from a device counter,
    gathers ``controls[t]`` and the draws' column t, runs ``_transition``
    under ``torch.func.vmap`` over G, writes ``xs[:, :, t]`` and
    ``vs[:, :, t]`` in place and advances the counter: nothing comes from
    the host.  ``run`` copies one evaluation's inputs in once and runs the
    step T times; captured, the first two are eager warm-ups, the third
    captures and every later one is a replay.  Bound to the inputs'
    signature (``sig``); it owns every buffer it reads."""

    def __init__(self, cfg, inputs: dict, capture: bool):
        st = self.static = graphs.tree_map(torch.clone, inputs)
        noise = st["noise"]
        n_hidden = len(st["hidden"])
        t = self.t = torch.zeros(1, dtype=torch.int64, device=noise.device)
        x = self.x = noise.new_empty(noise.shape[:2] + noise.shape[3:])
        xs = self.xs = torch.empty_like(noise)
        vs = self.vs = torch.empty_like(noise)
        step = torch.func.vmap(functools.partial(_transition, cfg, n_hidden),
                               in_dims=(0, 0, None, 0, 0))

        def body(_):
            col = lambda e: e.index_select(2, t)[:, :, 0]
            with no_vmap_fallback():
                x1, v = step(st["sets"], x,
                             st["controls"].index_select(0, t)[0],
                             col(st["noise"]), [col(e) for e in st["hidden"]])
            xs.index_copy_(2, t, x1.unsqueeze(2))
            vs.index_copy_(2, t, v.unsqueeze(2))
            x.copy_(x1)
            t.add_(1)

        self.graph = graphs.StepGraph(body, {}, capture)
        self.sig = (capture, graphs.signature(inputs))

    def run(self, inputs: dict):
        graphs.copy_into(self.static, inputs)
        x0 = self.static["sets"]["x0"]
        self.x.copy_(x0[:, None, :].expand(self.x.shape))
        self.t.zero_()
        for _ in range(self.xs.shape[2]):
            self.graph({})
        return self.xs.clone(), self.vs.clone()


@spanned("ffvd::eval.rollout")
@graphs.scoped
def recursion_rollout(trainer: Trainer, params: GPSSMParams,
                      controls: torch.Tensor, noise: torch.Tensor,
                      hidden_noise: Optional[List[torch.Tensor]] = None,
                      capture: bool = False):
    """Rollouts by the recursion of ``gp_transition`` (the step of
    ``ffvd_tpu/eval/rollout.py::_rollout_one``), every row of G groups at
    once: group g's R rows start from its x_N and share its Kmm factor, U
    or q(U) and Q.  A deep model first propagates each step's state through
    its hidden layers (``propagate_step``, the layers' Kmm factorised once
    a set), with ``hidden_noise``; the identity skip stays on x_t.

    ``noise`` (R, T, D), the head's normals, with ``hidden_noise`` one
    (R, T, D) tensor per hidden layer: ``params`` is one set (G=1) and the
    result (xs, var_tot) is (R, T, D) each.  ``noise`` (G, R, T, D), with
    ``hidden_noise`` shaped alike: ``params`` holds G sets stacked on the
    leading axis of every leaf, and the result is (G, R, T, D) each.  So
    iid samples are G=1, R=S; thinned samples G=S, R=1; chains G=C, R=S;
    thinned chains G=C×S, R=1.

    The sets are set up once (``rollout_sets``), then every step runs once
    for all G×R rows, under ``torch.func.vmap`` over G, reading its inputs
    from the static buffers of ``_RolloutGraph``.  ``capture``: replay that
    step from a CUDA graph (on the card; the caller decides, see
    ``collect_posterior``), else run it plainly.  The trainer keeps the
    graph (``trainer._rollout_graph``) for its next call with inputs of
    the same shapes, unless its step all-reduces over NCCL
    (``utils.graphs.graph_scope``)."""
    if len(hidden_noise or ()) != len(params.hidden):
        raise ValueError(f"{len(params.hidden)} hidden layers need as many "
                         "hidden_noise tensors, one a layer")
    grouped = noise.dim() == 4
    lift = (lambda t: t) if grouped else (lambda t: t[None])
    params = GPSSMParams.from_leaves({k: lift(v) for k, v in
                                      params.leaves().items()})
    inputs = {"sets": rollout_sets(trainer, params), "controls": controls,
              "noise": lift(noise),
              "hidden": [lift(e) for e in hidden_noise or ()]}
    g = getattr(trainer, "_rollout_graph", None)
    if g is None or g.sig != (capture, graphs.signature(inputs)):
        g = trainer._rollout_graph = _RolloutGraph(trainer.cfg, inputs,
                                                   capture)
    xs, vs = g.run(inputs)
    return (xs, vs) if grouped else (xs[0], vs[0])


@torch.no_grad()
@spanned("ffvd::eval")
@graphs.scoped
def collect_posterior(trainer: Trainer, state: TrainState, test_len: int,
                      num: Optional[int] = None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      thin_noise: Optional[Dict[str, torch.Tensor]] = None,
                      thin_generator: Optional[torch.Generator] = None,
                      hidden_noise: Optional[List[torch.Tensor]] = None,
                      thin_prop: Optional[List[torch.Tensor]] = None,
                      capture: Optional[bool] = None):
    """Draw ``num`` posterior predictive trajectories of ``test_len`` steps.

    Without SG-HMC leaves the samples are iid: one q(U) summary, one
    ``rollout`` call.  With them the chain is thinned first
    (``thin_posterior``, normals from ``thin_generator`` or ``thin_noise``
    and ``thin_prop``) and the S samples' own parameters go to one
    ``rollout_batched`` call.  A LinearK or deep config rolls out by
    ``recursion_rollout`` instead, once for all S rows: one group of S for
    the iid samples, S groups of one for a thinned chain.  ``generator``
    draws the rollout's Philox seed (kernel) or normals (recursion);
    ``noise`` (num, test_len, D) and, for a deep model, ``hidden_noise``
    (one (num, test_len, D) tensor per hidden layer), when given, replace
    that noise.  ``capture``, as in ``Trainer.run``: by default on the card
    the thinning replays its captured sub-step and the recursion its
    captured step; never on the CPU, nor where the trainer's step
    all-reduces over a gloo group (``inference.trainer.capture_rule``).
    Returns (predict_x (S, T, D), predict_x_var (S, T, D), the state with
    the moved chain)."""
    cfg = trainer.cfg
    with span("ffvd::eval.prep"):
        num = num or cfg.num_posterior_samples
        capture = trainer.capture_mode(state, capture)
        controls = rollout_controls(trainer.data, test_len)
        x = state.params.x
        recursion = uses_recursion(cfg)
        if recursion and noise is None:
            noise = hidden_normals(1, (num, test_len), x.shape[1], generator,
                                   x.dtype, x.device)[0]
        if recursion and hidden_noise is None and state.params.hidden:
            hidden_noise = hidden_normals(len(state.params.hidden),
                                          (num, test_len), x.shape[1],
                                          generator, x.dtype, x.device)
    if trainer.has_sghmc:
        samples, state = thin_posterior(
            trainer, state, num, cfg.posterior_sample_spacing,
            thin_generator, thin_noise, thin_prop, capture)
        if recursion:
            xs, vs = recursion_rollout(
                trainer, stack_members(samples), controls, noise[:, None],
                [e[:, None] for e in hidden_noise or ()], capture=capture)
            return xs[:, 0], vs[:, 0], state
        with span("ffvd::eval.prep"):
            inp = posterior_inputs(trainer, samples)
        xs, vs = rollout_ops.rollout_batched(
            controls=controls, noise=noise, generator=generator, **inp)
        return xs, vs, state
    params = state.params
    if recursion:
        return (*recursion_rollout(trainer, params, controls, noise,
                                   hidden_noise, capture=capture), state)
    with span("ffvd::eval.prep"):
        inp = rollout_inputs(trainer, params)
    xs, vs = rollout_ops.rollout(controls=controls, num_samples=num,
                                 noise=noise, generator=generator, **inp)
    return xs, vs, state


def predict_summary(params: GPSSMParams, predict_x: torch.Tensor,
                    predict_x_var: torch.Tensor,
                    emission_noise: str = "auto"):
    """ŷ, v̂, and the training fit (base_model.py:334-343).  In diag mode the
    strictly-lower log_rchol entries are not part of the trained density and
    do not enter the predictive variance."""
    c, d = params.c, params.d
    y_s = predict_x @ c + d                           # (S, T, P)
    v_s = predict_x_var @ (c * c)                     # (S, T, P)
    if use_full_r(emission_noise, params.c.shape[1]):
        r2 = params.r_var_diag                        # diag(L·Lᵀ)
    else:
        r2 = params.rchol_diag ** 2                   # exp(2·diag log_rchol)
    predict_y = torch.mean(y_s, dim=0)
    predict_y_var = torch.mean(v_s, dim=0) + r2
    fit_y = emission_mean(params.x[1:], c, d)
    return predict_y, predict_y_var, fit_y


def rmse_nll(y_test: torch.Tensor, predict_y: torch.Tensor,
             predict_y_var: torch.Tensor, y_train_std: float,
             horizon: int = 30):
    """RMSE/NLL on the first ``horizon`` test steps (base_model.py:345-349,
    :629); the NLL uses the normalised Normal logpdf like scipy."""
    yt = y_test[:horizon].reshape(-1)
    yp = predict_y[:horizon].reshape(-1)
    vp = predict_y_var[:horizon].reshape(-1)
    rmse = torch.sqrt(torch.mean((yt - yp) ** 2)) * y_train_std
    nll = -torch.mean(-0.5 * torch.log(2 * math.pi * vp)
                      - 0.5 * (yt - yp) ** 2 / vp)
    return rmse, nll
