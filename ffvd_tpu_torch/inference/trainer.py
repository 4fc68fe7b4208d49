"""The FFVD training protocol.

Counterpart of ``ffvd_tpu/inference/trainer.py``.  Per outer iteration the
reference (models.py:142-197) runs:

  1. an SG-HMC phase: 1 burn-in + 10×(burn-in + sample) = 21 sub-steps on
     the SG-HMC-labelled leaves, each a full nll-gradient evaluation
     (base_model.py:915-925);
  2. a snapshot of those leaves into a ring-buffer window of 64
     (base_model.py:927-933);
  3. one Adam step on the nll, with the SG-HMC leaves fed from a random
     window slot (base_model.py:944-950).

In C6 a particle-Gibbs sweep (``inference/particle_gibbs.py``) replaces
the trajectory x between 2 and 3, as ``ffvd_tpu/inference/trainer.py:414``
does; x is frozen to Adam there.  A case without SG-HMC leaves (C1, C4,
C6) skips 1-2; a case without Adam leaves (C7) skips 3 and reports the nll
after the sampler phase.

Two options make every training gradient evaluation random, as in JAX:
``cfg.minibatch_size < N`` evaluates it on a random time window
(``model/elbo.py::windowed_elbo_terms``, a uniform start per evaluation),
and a deep model (``cfg.n_layers > 1``) samples its inter-layer noise per
evaluation (``model/deep.py``).  Reported nlls of an Adam-free step and the
evaluation stay full batch and mean-propagated.

The random numbers come from the caller's ``torch.Generator`` or are
injected (``noise=``, ``feed=``, ``pg=``, ``starts=``, ``prop=``), so the
tests can feed both packages the same draws.  A process of a sharded run
(``parallel/``) makes every draw at the shape it has in one process and
keeps its share, through the hooks at the end of ``Trainer``.

``cfg.collapse_precision="ds64"`` trains on the collapsed bound evaluated
as one float64 segment (``model/ds_collapse.py``); "hybrid" trains native
here, and ``api.FFVDModel`` runs the last ``cfg.hybrid_tail_iters`` of a
``fit`` on a second, ds64 Trainer that shares the ``TrainState``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ffvd_tpu_torch.config import ADAM, SGHMC, FFVDConfig, partition_for
from ffvd_tpu_torch.inference.sghmc import (SGHMCState, sghmc_init,
                                            sghmc_step, tree_normals)
from ffvd_tpu_torch.model.deep import hidden_normals
from ffvd_tpu_torch.model.elbo import negative_elbo, windowed_negative_elbo
from ffvd_tpu_torch.model.params import (HIDDEN_FIELDS, GPSSMParams, SSMData,
                                         hidden_paths)

Leaves = Dict[str, torch.Tensor]

# The SG-HMC phase's burn-in flags: B, (B, S)×10 (base_model.py:915-925).
SUBSTEP_FLAGS = (True,) + (True, False) * 10


def label_tree(cfg: FFVDConfig) -> Dict[str, str]:
    """'adam'/'sghmc'/'frozen' label per leaf path, hidden layers included.

    Hidden layers are Adam-trained point estimates by default; with
    ``deep_sample_hidden`` they follow the case's u/z/kernel partition like
    the head, except that a collapsed head (C4/C5) leaves hidden U to Adam:
    only the head's U has an analytic collapse
    (``ffvd_tpu/inference/trainer.py:45-74``)."""
    part = partition_for(cfg)
    labels = {"x": part.x, "u": part.u, "z": part.z,
              "kernel.log_variance": part.kernel,
              "kernel.log_lengthscales": part.kernel,
              "log_q": part.log_q, "c": part.lik, "d": part.lik,
              "log_rchol": part.lik}
    if cfg.deep_sample_hidden:
        hidden_u = ADAM if cfg.case_config.u_collapse else part.u
        layer = (hidden_u, part.z, part.kernel, part.kernel)
    else:
        layer = (ADAM,) * len(HIDDEN_FIELDS)
    paths = hidden_paths(cfg.n_layers - 1)
    labels.update(zip(paths, layer * (cfg.n_layers - 1)))
    return labels


def grads_of(nll: torch.Tensor, leaves) -> list:
    """d nll / d leaf for each leaf, zeros for a leaf the objective does not
    use (the LinearK lengthscales), as ``jax.grad`` returns them.  A (C,)
    ``nll`` of independent members is summed: each member's leaves get
    its own gradient."""
    if nll.dim():
        nll = nll.sum()
    grads = torch.autograd.grad(nll, leaves, allow_unused=True)
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(leaves, grads)]


def sanitize_grads(grads, clip):
    """Zero non-finite gradient elements and clip magnitudes to ±clip
    (FFVDConfig.sghmc_grad_clip).  No-op when clip is None."""
    if clip is None:
        return list(grads)
    return [torch.clamp(torch.where(torch.isfinite(g), g,
                                    torch.zeros_like(g)), -clip, clip)
            for g in grads]


def _assign(dst: Leaves, src: Leaves) -> None:
    """dst[k] ← src[k] in place for every key of ``dst``: the tensors keep
    their addresses (one foreach copy)."""
    keys = list(dst)
    if keys:
        torch._foreach_copy_([dst[k] for k in keys], [src[k] for k in keys])


def adam_steps_in_leaf_dtype(adam: Optional[torch.optim.Adam]) -> None:
    """A capturable Adam (the card's) keeps each step count on the device as
    a float32 tensor and computes the bias corrections 1 − βᵗ from it, so
    in float32 for fp64 leaves too (2.7e-6 relative over 200 fp64 C4
    iterations against the CPU's float64 count).  Give every leaf its state
    now (Adam's own zeros) with the count in the leaf's dtype, or recast a
    restored count."""
    if adam is None or not adam.defaults["capturable"]:
        return
    for p in adam.param_groups[0]["params"]:
        st = adam.state[p]
        if st:
            st["step"] = st["step"].to(p.dtype)
        else:
            st.update(step=p.new_zeros(()), exp_avg=torch.zeros_like(p),
                      exp_avg_sq=torch.zeros_like(p))


def _log_clip_bounds(clip):
    """None → None, scalar c → (−c, c), or an explicit (lower, upper) pair
    (FFVDConfig.log_clip_bounds)."""
    if clip is None:
        return None
    if isinstance(clip, tuple):
        return clip
    return (-clip, clip)


def clip_log_leaves(tree: Leaves, clip) -> Leaves:
    """Clip the leaves whose path contains 'log' to the given bounds, the
    fp32 overflow guard of SG-HMC-sampled hyperparameters.  Under
    hyperparameter sampling that includes ``log_rchol``'s raw strictly-lower
    entries, as in the JAX package.  No-op when clip is None."""
    bounds = _log_clip_bounds(clip)
    if bounds is None:
        return tree
    lo, hi = bounds
    return {k: torch.clamp(v, lo, hi) if "log" in k else v
            for k, v in tree.items()}


class SubsetOps:
    """Split/merge the leaves with one label (the SG-HMC leaves by default),
    in ``label_tree``'s order, which is the JAX package's pytree order."""

    def __init__(self, labels: Dict[str, str], target: str = SGHMC):
        self.paths = tuple(k for k, v in labels.items() if v == target)

    def split(self, params: GPSSMParams) -> Leaves:
        leaves = params.leaves()
        return {k: leaves[k] for k in self.paths}

    def merge(self, sub: Leaves, into: GPSSMParams) -> GPSSMParams:
        return GPSSMParams.from_leaves({**into.leaves(), **sub})


def _scoped(method: Callable) -> Callable:
    """``utils.graphs.scoped`` for this module's methods: ``graph_scope``
    is imported at the call, since ``utils/`` imports this module."""
    @functools.wraps(method)
    def call(self, *args, **kw):
        from ffvd_tpu_torch.utils.graphs import graph_scope
        with graph_scope(self):
            return method(self, *args, **kw)
    return call


def capture_rule(capture: Optional[bool], on_card: bool,
                 collectives: Iterable[Tuple[str, str]] = ()) -> bool:
    """Whether a step replays a CUDA graph (``utils/graphs.py``).

    ``collectives``: (mesh axis, backend) of every group whose all-reduces
    the step issues.  A CUDA graph captures NCCL's all-reduces (their
    kernels run on the card) and not gloo's (a host round trip).  So a
    step may be captured when it issues no collective (one process, a
    'dp'-only mesh, a world of one) or when every collective runs on NCCL;
    a graph of NCCL's lives only as long as the call that made it
    (``utils.graphs.graph_scope``).

    ``capture`` None: captured on the card when every collective runs on
    NCCL (or there is none), else eager (gloo, and the CPU); a capture
    that fails raises.  True: captured, or a ``ValueError`` that names the
    backend and the axis, or the CPU.  False: eager."""
    collectives = tuple(collectives)
    if capture is None:
        return on_card and all(b == "nccl" for _, b in collectives)
    if not capture:
        return False
    held = [(axis, b) for axis, b in collectives if b != "nccl"]
    if held:
        raise ValueError(
            "capture=True: the step all-reduces over "
            + ", ".join(f"'{axis}' on {b}" for axis, b in held)
            + ", which a CUDA graph cannot capture (it captures NCCL's); "
            "run it eagerly (capture=None or False) or on an NCCL group")
    if not on_card:
        raise ValueError("capture=True needs the state on a CUDA device; "
                         "the CPU runs the step eagerly")
    return True


@dataclasses.dataclass
class TrainState:
    params: GPSSMParams
    adam: Optional[torch.optim.Adam]
    sghmc: Optional[SGHMCState] = None
    # (window_size, ...) snapshots of the SG-HMC leaves only, keyed by path
    window: Leaves = dataclasses.field(default_factory=dict)
    # [step, window_count], int64 on the params' device: the step reads
    # and advances them there, so a CUDA graph can replay it
    # (``utils/graphs.py``).  ``step`` and ``window_count`` read them as ints.
    counts: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.counts is None:
            self.counts = torch.zeros(2, dtype=torch.int64,
                                      device=self.params.x.device)

    @property
    def step(self) -> int:
        return int(self.counts[0])

    @step.setter
    def step(self, value: int):
        self.counts[0] = int(value)

    @property
    def window_count(self) -> int:
        return int(self.counts[1])

    @window_count.setter
    def window_count(self, value: int):
        self.counts[1] = int(value)

    def adam_paths(self) -> List[str]:
        """The paths of the Adam leaves, in the optimizer's order."""
        if self.adam is None:
            return []
        by_id = {id(v): k for k, v in self.params.leaves().items()}
        return [by_id[id(p)] for p in self.adam.param_groups[0]["params"]]

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state, Adam's moments and steps included."""
        out = list(self.params.leaves().values()) + [self.counts]
        out += list(self.window.values())
        if self.sghmc is not None:
            out += self.sghmc.tensors()
        if self.adam is not None:
            out += [v for st in self.adam.state.values() for v in st.values()
                    if torch.is_tensor(v)]
        return out


class Trainer:
    """Runs the FFVD training protocol for one config.

    ``lead`` is the shape of a leading member axis that every leaf, draw
    and nll carries: () here, (C,) in ``parallel.sharding.BatchedTrainer``,
    which overrides the objective and the few hooks that index members."""

    lead: Tuple[int, ...] = ()
    # The mesh of a run split over processes (parallel/), None in one.
    mesh = None
    # (mesh axis, backend) of each process group of more than one process
    # whose collectives run inside ``outer_step``: none in one process or
    # over 'dp' alone, whose trace is gathered after a chunk.  The mesh
    # trainers read it from their groups once, when they are built.
    step_collectives: Tuple[Tuple[str, str], ...] = ()

    @property
    def graphs_per_call(self) -> bool:
        """Whether the step all-reduces over NCCL, so that a graph of it
        holds NCCL's communicators and lives only as long as the call that
        made it (``utils.graphs.graph_scope``)."""
        return any(b == "nccl" for _, b in self.step_collectives)

    def __init__(self, cfg: FFVDConfig, data: SSMData,
                 pg_fn: Optional[Callable] = None):
        """``pg_fn``: the particle-Gibbs sweep of case C6
        (``particle_gibbs.make_pg_fn``), required there."""
        if cfg.case_config.x_pg and pg_fn is None:
            raise ValueError("case C6 requires a particle-Gibbs function")
        self.cfg = cfg
        self.data = data
        self.pg_fn = pg_fn
        self.labels = label_tree(cfg)
        self.has_sghmc = SGHMC in self.labels.values()
        self.has_adam = ADAM in self.labels.values()
        self.subset = SubsetOps(self.labels)
        self.adam_paths = SubsetOps(self.labels, ADAM).paths
        # "hybrid" trains native; its ds64 tail is a second Trainer with
        # collapse_precision="ds64" (api.FFVDModel.fit), on the same state.
        self.train_precision = ("native" if cfg.collapse_precision == "hybrid"
                                else cfg.collapse_precision)
        kw = dict(kernel_type=cfg.kernel_type, prior_type=cfg.prior_type,
                  u_collapse=cfg.case_config.u_collapse, jitter=cfg.jitter,
                  emission_noise=cfg.emission_noise,
                  collapse_precision=self.train_precision,
                  ds64_refine=cfg.ds64_refine)
        self.nll_fn = functools.partial(negative_elbo, **kw)
        # A deep model samples its inter-layer noise per training gradient.
        self.stochastic = cfg.n_layers > 1
        # A window covering the whole sequence is full batch, also the
        # reference's effective default (its --minibatch_size 1000 exceeds
        # every stock dataset).
        n = data.y.shape[0]
        self.window_n = (cfg.minibatch_size if cfg.minibatch_size is not None
                         and cfg.minibatch_size < n else None)
        if self.window_n is not None:
            self.win_nll_fn = functools.partial(
                windowed_negative_elbo, window_n=self.window_n, **kw)
            # Starts are uniform on [0, hi): with a padding mask (a suffix)
            # inside the real prefix, read once here, not per draw.
            real_n = n if data.mask is None else int(torch.sum(data.mask))
            self.start_hi = max(real_n - self.window_n + 1, 1)
        # Effective Adam lr: 0.003·0.95^(global_step/1000) evaluated at the
        # constant global_step=1 the reference always passes
        # (base_model.py:188-194).
        self.adam_lr = cfg.adam_lr * 0.95 ** (1.0 / 1000.0)

    # -- state ------------------------------------------------------------

    def init_state(self, params: GPSSMParams) -> TrainState:
        """Copy ``params`` into fresh leaves; Adam covers the 'adam' leaves
        only, so frozen leaves get no update and SG-HMC leaves move only by
        the sampler."""
        if len(params.hidden) != self.cfg.n_layers - 1:
            raise ValueError(
                f"params has {len(params.hidden)} hidden layers but "
                f"cfg.n_layers={self.cfg.n_layers} expects "
                f"{self.cfg.n_layers - 1} (model/deep.py; "
                "init_hidden_layers grafts them onto a shallow start)")
        leaves = {k: v.detach().clone().requires_grad_(self.labels[k] == ADAM)
                  for k, v in params.leaves().items()}
        # torch.optim.Adam is optax.adam's formula: b1=0.9, b2=0.999,
        # bias-corrected moments, eps=1e-8 added outside the square root.
        # On the card its step count stays on the device (capturable), on
        # the eager path too, so eager and captured runs agree bit for bit.
        # C7 has no Adam leaves, and Adam takes no empty parameter list.
        adam = (torch.optim.Adam(
            [v for k, v in leaves.items() if self.labels[k] == ADAM],
            lr=self.adam_lr, betas=(0.9, 0.999), eps=1e-8,
            capturable=params.x.device.type == "cuda")
            if self.has_adam else None)
        adam_steps_in_leaf_dtype(adam)
        params = GPSSMParams.from_leaves(leaves)
        sub = self.subset.split(params)
        w = self.cfg.window_size
        m = len(self.lead)
        return TrainState(
            params=params, adam=adam,
            sghmc=sghmc_init(sub) if self.has_sghmc else None,
            window={k: v.new_zeros(tuple(v.shape[:m]) + (w,)
                                   + tuple(v.shape[m:]))
                    for k, v in sub.items()})

    def chain_from_numpy(self, state: TrainState, sghmc: Dict[str, Dict],
                         window: Dict[str, np.ndarray],
                         window_count: int) -> TrainState:
        """``state`` with the SG-HMC chain of the JAX package put in:
        ``sghmc`` maps 'xi', 'g', 'g2', 'p' to numpy leaves keyed by path
        (the JAX SGHMCState's fields, whole trees or the SG-HMC subset),
        ``window`` maps each SG-HMC path to its (window_size, ...) array.
        The leaves take the dtype and device of ``state.params``."""
        ref = state.params.x
        as_t = lambda a: torch.tensor(np.asarray(a), dtype=ref.dtype,
                                      device=ref.device)
        paths = self.subset.paths
        chain = SGHMCState(**{f: {k: as_t(sghmc[f][k]) for k in paths}
                              for f in ("xi", "g", "g2", "p")})
        state = dataclasses.replace(
            state, sghmc=chain, window={k: as_t(window[k]) for k in paths},
            counts=state.counts.clone())
        state.window_count = int(window_count)
        return state

    # -- one gradient evaluation's objective and random inputs --------------

    def train_nll(self, params: GPSSMParams, data: Optional[SSMData] = None,
                  start: Optional[torch.Tensor] = None,
                  eps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """The objective of one gradient evaluation: on the window at
        ``start`` (training with ``window_n``), or full batch when
        ``start`` is None (no window, or eval thinning, rollout.py:181-200);
        a deep model's inter-layer normals ``eps`` (None: layer means)."""
        data = self.data if data is None else data
        if start is None:
            return self.nll_fn(params, data, eps=eps)
        return self.win_nll_fn(params, data, start, eps=eps)

    def grad_draws(self, n_evals: int, generator: Optional[torch.Generator],
                   x: torch.Tensor) -> Dict[str, object]:
        """The random inputs of ``n_evals`` training gradient evaluations,
        as ``outer_step`` takes them: ``starts`` (n_evals,) window starts,
        uniform on [0, N − W] (on the real prefix of masked data), and
        ``prop``, one (n_evals, rows, D) normal tensor per hidden layer, rows
        = W or N, in the dtype and on the device of the trajectory ``x``.
        Empty for a full-batch shallow trainer.  The starts stay on the
        device: the window is gathered, never read back."""
        out: Dict[str, object] = {}
        if self.window_n is None and not self.stochastic:
            return out
        if generator is None:
            raise ValueError("window starts and inter-layer noise need a "
                             "torch.Generator or injected draws (starts=, "
                             "prop=)")
        dev = x.device
        if self.window_n is not None:
            out["starts"] = self._draw_starts(n_evals, generator, dev)
        if self.stochastic:
            rows = self.window_n or self.data.y.shape[-2]
            out["prop"] = [self._share(p) for p in hidden_normals(
                self.cfg.n_layers - 1, self._whole_lead() + (n_evals, rows),
                x.shape[-1], generator, x.dtype, dev)]
        return out

    def _draw_starts(self, n_evals: int, generator: torch.Generator,
                     dev) -> torch.Tensor:
        """(n_evals,) window starts, uniform on [0, start_hi)."""
        return torch.randint(0, self.start_hi, (n_evals,),
                             generator=generator,
                             device=generator.device).to(dev)

    def _eval_draws(self, starts, prop, e: int):
        """(start, eps) of gradient evaluation ``e`` of an iteration."""
        return (None if starts is None else starts[..., e:e + 1],
                None if prop is None
                else [p.select(len(self.lead), e) for p in prop])

    # -- the SG-HMC leaves' gradient and chain ------------------------------

    def subset_grads(self, sub: Leaves, params: GPSSMParams,
                     data: Optional[SSMData] = None,
                     start: Optional[torch.Tensor] = None,
                     eps: Optional[List[torch.Tensor]] = None) -> Leaves:
        """Sanitised nll gradient with respect to the SG-HMC leaves only;
        the other leaves enter as constants, so autograd builds no backward
        chain for them.  ``start``/``eps``: see ``train_nll``."""
        fixed = {k: v.detach() for k, v in params.leaves().items()}
        req = {k: v.detach().requires_grad_(True) for k, v in sub.items()}
        with torch.enable_grad():
            nll = self.train_nll(GPSSMParams.from_leaves({**fixed, **req}),
                                 data, start, eps)
            grads = grads_of(nll, list(req.values()))
        grads = self._reduce_grads(list(req), grads)
        return dict(zip(req, sanitize_grads(grads, self.cfg.sghmc_grad_clip)))

    def sghmc_move(self, sub: Leaves, sstate: SGHMCState, params: GPSSMParams,
                   burn_in: bool, noise: Optional[Leaves] = None,
                   generator: Optional[torch.Generator] = None,
                   start: Optional[torch.Tensor] = None,
                   eps: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[Leaves, SGHMCState]:
        """One sampler sub-step of the SG-HMC leaves ``sub`` (the rest of
        ``params`` held fixed), then the log clip.  ``noise`` replaces the
        normals drawn from ``generator``; ``start``/``eps`` are the
        gradient's window start and inter-layer normals."""
        cfg = self.cfg
        grads = self.subset_grads(sub, params, start=start, eps=eps)
        if noise is None:
            noise = self._sampler_normals(sub, generator)
        sub, sstate = sghmc_step(
            sub, grads, sstate, epsilon=cfg.epsilon, mdecay=cfg.mdecay,
            x_n=params.x.shape[-2], burn_in=burn_in, p_clip=cfg.sghmc_p_clip,
            spike_clip=cfg.sghmc_spike_clip, noise=noise)
        return clip_log_leaves(sub, cfg.log_clip_bounds), sstate

    def _sghmc_phase(self, params: GPSSMParams, sstate: SGHMCState,
                     noise: Leaves, starts=None, prop=None
                     ) -> Tuple[GPSSMParams, SGHMCState]:
        """The 21 sub-steps B, (B, S)×10, gradients with respect to the
        SG-HMC leaves only, sub-step i on window ``starts[i]`` with
        inter-layer normals ``prop[·][i]`` (trainer.py:329-393)."""
        sub = {k: v.detach() for k, v in self.subset.split(params).items()}
        m = len(self.lead)
        for i, flag in enumerate(SUBSTEP_FLAGS):
            start, eps = self._eval_draws(starts, prop, i)
            sub, sstate = self.sghmc_move(
                sub, sstate, params, flag,
                {k: v.select(m, i) for k, v in noise.items()},
                start=start, eps=eps)
        return self.subset.merge(sub, params), sstate

    # -- one outer iteration ----------------------------------------------

    def _feed_params(self, state: TrainState, generator, feed) -> GPSSMParams:
        """The params with the SG-HMC leaves replaced by window slot i,
        i ~ U[0, max(count, 1)) drawn after the snapshot (trainer.py:424),
        one slot per member.  The bound is the device count: a 62-bit draw
        modulo it (a bias below 2⁻⁵⁶), so nothing is read back."""
        dev = state.params.x.device
        shape = self._whole_lead() or (1,)
        if feed is None:
            if generator is None:
                raise ValueError("the window feed needs a torch.Generator or "
                                 "an injected index (feed=)")
            bits = torch.randint(0, 2 ** 62, shape, generator=generator,
                                 device=generator.device).to(dev)
            i = bits % torch.clamp(state.counts[1], min=1)
        elif torch.is_tensor(feed):
            i = feed.to(dev).reshape(shape)
        else:
            i = torch.as_tensor(np.asarray(feed, dtype=np.int64)
                                .reshape(shape), device=dev)
        i = self._share(i)
        return self.subset.merge(
            {k: self._window_slot(w, i) for k, w in state.window.items()},
            state.params)

    def _window_slot(self, w: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Slot ``i`` (1,) of one leaf's window (window_size, ...)."""
        return torch.index_select(w, 0, i)[0]

    def _pg(self, params: GPSSMParams, generator, pg) -> GPSSMParams:
        """C6: the particle-Gibbs sweep of the trajectory."""
        return self.pg_fn(params, generator, self.data, draws=pg)

    def outer_step(self, state: TrainState,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Leaves] = None,
                   feed=None,
                   pg: Optional[dict] = None,
                   starts: Optional[torch.Tensor] = None,
                   prop: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """One outer iteration, updating ``state``'s tensors in place (its
        leaves, chain, window and counts keep their addresses, and nothing
        is read back to the host, so ``utils/graphs.py`` can capture it).
        Returns the nll, detached ((C,) with a member axis): at the
        window-fed point before the Adam update, on
        that gradient's window and inter-layer draw (trainer.py:430), or
        full batch and mean-propagated after the sampler phase when there
        is no Adam leaf (C7, :434).  ``noise`` (path → (21, ...)), ``feed``,
        ``pg`` (one sweep's draws, ``particle_gibbs.pg_draws``), ``starts``
        and ``prop`` (``grad_draws``: one entry per gradient evaluation, the
        21 sub-steps' first, then Adam's) replace the draws from
        ``generator``; ``feed`` is an int, an array or a device tensor of
        the member shape.  Under a profiler the sampler phase and the
        snapshot run inside ``ffvd::train.sghmc``, the feed and the Adam
        step inside ``ffvd::train.adam``."""
        # utils/ imports this module
        from ffvd_tpu_torch.utils.profiling import span
        n_evals = (len(SUBSTEP_FLAGS) if self.has_sghmc else 0) \
            + int(self.has_adam)
        drawn = self.grad_draws(n_evals, generator, state.params.x) if (
            (self.window_n is not None and starts is None)
            or (self.stochastic and prop is None)) else {}
        starts = drawn.get("starts") if starts is None else self._share(
            starts)
        prop = (drawn.get("prop") if prop is None
                else [self._share(p) for p in prop])
        if self.has_sghmc:
            with span("ffvd::train.sghmc"):
                if noise is None:   # the 21 sub-steps' normals, up front
                    noise = self._sampler_normals(
                        self.subset.split(state.params), generator,
                        len(SUBSTEP_FLAGS))
                else:
                    noise = self._share_tree(noise)
                params, sghmc = self._sghmc_phase(
                    state.params, state.sghmc, noise, starts, prop)
                sub = self.subset.split(params)
                with torch.no_grad():
                    _assign(self.subset.split(state.params), sub)
                    state.sghmc.assign_(sghmc)
                    # Window snapshot as a ring buffer (base_model.py:
                    # 927-933), slot step % window_size, the count capped
                    # at its size.
                    slot = state.counts[:1] % self.cfg.window_size
                    m = len(self.lead)
                    for k, w in state.window.items():
                        w.index_copy_(m, slot, sub[k].unsqueeze(m))
                    state.counts[1:].add_(1).clamp_(
                        max=self.cfg.window_size)
        if self.pg_fn is not None and self.cfg.case_config.x_pg:
            with torch.no_grad():
                state.params.x.copy_(self._pg(state.params, generator, pg).x)
        if self.has_adam:
            with span("ffvd::train.adam"):
                feed_params = (self._feed_params(state, generator, feed)
                               if self.has_sghmc else state.params)
                start, eps = self._eval_draws(starts, prop, n_evals - 1)
                group = state.adam.param_groups[0]["params"]
                # The gradient is taken at fresh aliases of the Adam
                # leaves: an autograd graph made outside the step may hold
                # the leaves' own grad accumulators, bound to the stream it
                # ran on.
                leaves = feed_params.leaves()
                alias = {k: leaves[k].detach().requires_grad_(True)
                         for k in self.adam_paths}
                with torch.enable_grad():
                    nll = self.train_nll(GPSSMParams.from_leaves(
                        {**leaves, **alias}), None, start, eps)
                    grads = grads_of(nll, list(alias.values()))
                grads = self._reduce_grads(self.adam_paths, grads)
                for p, g in zip(group, sanitize_grads(
                        grads, self.cfg.sghmc_grad_clip)):
                    p.grad = g
                state.adam.step()
        else:
            with torch.no_grad():
                nll = self.train_nll(state.params)
        with torch.no_grad():
            state.counts[:1].add_(1)
        return self._reduce_nll(nll.detach())

    @_scoped
    def run(self, state: TrainState, num_iterations: int,
            chunk_size: int = 500, nan_check: bool = True,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Iterable[dict]] = None,
            capture: Optional[bool] = None
            ) -> Tuple[TrainState, torch.Tensor]:
        """Run ``num_iterations`` outer iterations (the reference runs
        2×cfg.iterations, models.py:142).  Returns (state, nll_trace).

        ``generator`` draws the sampler noise, the window feed, the PG
        sweep's numbers, the window starts and the inter-layer normals;
        ``draws``, one dict of ``outer_step`` keywords (``noise``, ``feed``,
        ``pg``, ``starts``, ``prop``) per iteration, replaces it.
        ``nan_check``: per chunk of ``chunk_size`` iterations, raise with
        the failing iteration index and a finite-by-block diagnosis.

        ``capture``: replay one captured iteration from a CUDA graph
        (``utils/graphs.py``, the counterpart of JAX's jitted scan), with
        one host read a chunk, for the NaN check.  None (the default)
        captures on the card unless the step all-reduces over gloo
        (``capture_rule``): one process, a 'dp'-only mesh, and a mesh over
        NCCL, whose graph lives until this call returns; it runs eagerly
        on gloo and on the CPU.  True raises where it cannot capture;
        False runs ``outer_step`` eagerly.  Both give the same numbers."""
        # utils/ imports this module
        from ffvd_tpu_torch.utils.profiling import span
        with span("ffvd::train.run"):
            capture = self.capture_mode(state, capture)
            draws = iter(draws) if draws is not None else None
            traces = []
            done = 0
            while done < num_iterations:
                n = min(chunk_size, num_iterations - done)
                if capture:
                    nlls = self._replay(state, generator, draws, n, True)
                else:
                    nlls = torch.stack([
                        self.outer_step(state, generator,
                                        **(next(draws) if draws is not None
                                           else {}))
                        for _ in range(n)])
                with span("ffvd::train.read"):
                    nlls = self._gather_trace(nlls)
                    if nan_check and not bool(torch.isfinite(nlls).all()):
                        self._raise_non_finite(nlls, done, state)
                traces.append(nlls)
                done += n
        if not traces:
            return state, torch.zeros((0,) + self._whole_lead(),
                                      dtype=state.params.x.dtype,
                                      device=state.params.x.device)
        return state, torch.cat(traces)

    def capture_mode(self, state: TrainState, capture: Optional[bool]
                     ) -> bool:
        """Whether ``run``, ``eval.rollout.thin_posterior`` and the
        rollout recursion replay a CUDA graph (``capture_rule`` on the
        collectives of this trainer's step)."""
        return capture_rule(capture, state.params.x.device.type == "cuda",
                            self.step_collectives)

    @_scoped
    def _replay(self, state: TrainState, generator, draws, n: int,
                capture: Optional[bool] = None) -> torch.Tensor:
        """n iterations of the captured step: each copies its injected
        draws into the graph's static inputs and replays it.  One graph a
        trainer, captured again when the state, the generator, the draws'
        shapes or ``capture`` (``capture_mode``'s; False: the same step
        run plainly) change, and kept as ``graph_scope`` says."""
        # utils/ imports this module
        from ffvd_tpu_torch.utils import graphs
        from ffvd_tpu_torch.utils.profiling import span
        capture = self.capture_mode(state, capture)
        dev = state.params.x.device
        g = getattr(self, "_graph", None)
        with span("ffvd::train.replay"):
            fp = graphs.train_fingerprint(self, state, generator)
            parts = []
            for _ in range(n):
                d = graphs.to_device(next(draws) if draws is not None else {},
                                     dev, self._whole_lead() or (1,))
                if g is None or g.fp != fp or g.sig != graphs.signature(d) \
                        or g.graph.capture != capture:
                    if g is not None:
                        parts.append(g.flush())
                    g = self._graph = graphs.TrainGraph(self, state,
                                                        generator, d, capture)
                parts.append(g.step(self, d))
                fp = g.fp   # a warm-up may have given Adam its moments
            parts.append(g.flush())
            return torch.cat([p for p in parts if p is not None])

    def _raise_non_finite(self, nlls: torch.Tensor, done: int,
                          state: TrainState):
        """Name the first non-finite iteration of a chunk's trace and which
        parameter blocks are still finite."""
        bad = int(torch.nonzero(~torch.isfinite(nlls))[0, 0])
        diag = {k: bool(torch.isfinite(v).all())
                for k, v in state.params.leaves().items()}
        raise FloatingPointError(
            f"non-finite nll at iteration {done + bad}; "
            f"finite-by-block: {diag}. For ill-conditioned fp32 "
            f"runs try fp64 or a larger jitter (cfg.jitter).")

    # -- a sharded run's hooks: identity in one process ----------------------
    # parallel/sharding.py (members over 'dp', latent dims over 'ep') and
    # parallel/sequence.py (transitions over 'sp') override them.

    def _whole_lead(self) -> Tuple[int, ...]:
        """The member axis that a draw has in one process."""
        return self.lead

    def _whole_like(self, leaves: Leaves) -> Leaves:
        """Tensors shaped as ``leaves`` are in one process: the templates
        of their draws."""
        return leaves

    def _share(self, t: torch.Tensor, path: Optional[str] = None
               ) -> torch.Tensor:
        """This process's share of ``t``, a draw at one process's shape
        (member axis first); ``path``: the leaf whose shape it has."""
        return t

    def _reduce_grads(self, paths, grads) -> list:
        """The gradients of the leaves at ``paths``, summed over the
        processes whose objectives share them."""
        return grads

    def _reduce_nll(self, nll: torch.Tensor) -> torch.Tensor:
        """The nll of the whole objective from this process's part."""
        return nll

    def _gather_trace(self, nlls: torch.Tensor) -> torch.Tensor:
        """A chunk's nll trace of every member, from this process's."""
        return nlls

    def _whole_state(self, state: TrainState) -> TrainState:
        """The state one process would hold, from this process's share."""
        return state

    def _share_tree(self, tree: Leaves) -> Leaves:
        return {k: self._share(v, k) for k, v in tree.items()}

    def _sampler_normals(self, sub: Leaves, generator, steps: int = 0
                         ) -> Leaves:
        """Standard normals for the SG-HMC leaves ``sub``: ``steps``
        sub-steps' (path → lead + (steps,) + leaf), or one sub-step's."""
        m = len(self.lead)
        drawn = tree_normals(self._whole_like(sub), generator,
                             (steps,) if steps else ())
        return self._share_tree({k: v.movedim(0, m) if steps else v
                                 for k, v in drawn.items()})
