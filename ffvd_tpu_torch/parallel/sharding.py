"""Independent chains, on one device or over a ('dp', 'ep') mesh:
``MultiChainTrainer`` and the batched outer step that it shares with
``parallel/multidataset.py``.

Counterpart of ``ffvd_tpu/parallel/sharding.py``.  The JAX package runs C
chains as ``jax.vmap(Trainer.outer_step)`` inside one jit.  Here every leaf
of the state carries a leading axis of C (chains, or datasets in
``MultiDatasetTrainer``), and ``BatchedTrainer``, the single-chain
``Trainer`` with a member axis, takes the C members through one
iteration's launches:

- only the objective goes under ``torch.func.vmap``: it gives the (C,)
  nlls, and one ``torch.autograd.grad`` of their sum gives each member its
  own gradient, since the members are independent;
- the SG-HMC update, the gradient sanitiser, the log clip and Adam are
  elementwise and run on the stacked tensors as they are;
- every random number (sampler normals, window starts and feeds,
  inter-layer normals) is drawn outside ``vmap`` with a member axis, from
  the caller's ``torch.Generator``, or injected;
- the particle-Gibbs sweep of case C6 draws inside its recursion and runs
  one member at a time, outside ``vmap``; the rest of the step stays
  batched.

functorch runs an op that has no batching rule as a loop over the members
and says so only in a warning.  The step turns that fallback off, so such
an op raises instead of looping unnoticed (``no_vmap_fallback``).

The stacked ``TrainState``: params, SG-HMC state and the Adam leaves have
shape (C, ...), the window (C, window_size, ...); ``step`` and
``window_count`` are one int for all members, which always step together.

The mesh half.  JAX annotates the stacked state with a ('dp', 'ep')
sharding and lets GSPMD insert the collectives.  PyTorch runs one process
per device (``parallel/distributed.py``), and ``MeshBatchedTrainer`` is the
layer that turns ``BatchedTrainer`` into one process's share of the run:

- 'dp': the process holds members [m0, m1) of the C chains (or datasets);
  C must be a multiple of dp;
- 'ep': it holds latent dims [d0, d1) of the head's per-dim leaves (u,
  the kernel hypers, log Q; ``EP_AXIS``), D split as evenly as it goes
  (D=6 over ep=4: 2, 2, 1, 1).  x, c, z, d, log_rchol and the hidden
  layers stay whole on every process of an 'ep' group: x (N×D, a few KB)
  is the GP input of every dim, where JAX's ``P(..., 'ep')`` on x and c
  is a GSPMD layout the port need not copy.  The objective is a sum over
  the dims of per-dim parts plus a shared part (``model/elbo.py``): the
  process computes its dims' parts, and the shared part on the group's
  first process only;
- after each ``autograd.grad`` (outside ``vmap``) the gradients of the
  whole leaves are summed over the 'ep' group, and the nll with them; the
  per-dim leaves' gradients stay local.  SG-HMC and Adam then move the
  whole leaves identically on every process and each process its slices;
- every random draw is made at the shape it has in one process, from a
  generator that every process advances alike, and cut to the share
  (``Trainer._share``), so a sharded run with generator g is the
  one-process run with g (up to the order of the 'ep' sums);
- ``run`` returns the whole (T, C) trace on every process, and the NaN
  check reads it, so every process raises the same error with the global
  chain index.

``params_pspec`` and ``state_pspec`` give the map from leaf path to the
mesh axis of each dim with JAX's assignments; ``shard_chain_state`` and
``gather_chain_state`` cut a whole state to a process's share and back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch._C._functorch as _functorch
import torch.distributed as dist

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference.sghmc import SGHMCState
from ffvd_tpu_torch.inference.trainer import Leaves, Trainer, TrainState
from ffvd_tpu_torch.model.params import GPSSMParams, SSMData, hidden_paths
from ffvd_tpu_torch.parallel.distributed import (_default_ep, all_sum,
                                                 all_sum_flat, gather_blocks,
                                                 mesh_device_type)


@contextlib.contextmanager
def no_vmap_fallback():
    """Inside: an op without a batching rule raises under ``vmap`` instead
    of running functorch's per-member loop."""
    was = _functorch._is_vmap_fallback_enabled()
    _functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        _functorch._set_vmap_fallback_enabled(was)


def member(params: GPSSMParams, i: int) -> GPSSMParams:
    """Member ``i`` of stacked params (views)."""
    return GPSSMParams.from_leaves({k: v[i]
                                    for k, v in params.leaves().items()})


def stack_members(trees: Sequence[GPSSMParams]) -> GPSSMParams:
    """Stack params of equal shapes on a new leading axis."""
    leaves = [t.leaves() for t in trees]
    return GPSSMParams.from_leaves({k: torch.stack([lv[k] for lv in leaves])
                                    for k in leaves[0]})


class BatchedTrainer(Trainer):
    """The training protocol of ``Trainer`` for ``n`` independent members
    stacked on a leading axis (``lead = (n,)``).  ``data_axis``: ``data``
    is stacked too (one dataset per member), else shared by all members.

    It inherits the protocol (``outer_step``, the SG-HMC phase and sub-step,
    the window, the feed, ``run``) and overrides only the objective, the
    window starts, the window slot, the PG sweep and the NaN report."""

    axis_name = "member"

    def __init__(self, cfg: FFVDConfig, data: SSMData, n: int,
                 data_axis: bool, pg_fn=None):
        template = (SSMData(y=data.y[0], control=data.control[0],
                            mask=None if data.mask is None else data.mask[0])
                    if data_axis else data)
        super().__init__(cfg, template, pg_fn=pg_fn)
        self.data = data
        self.n = n
        self.lead = (n,)
        self.data_axis = data_axis
        if self.window_n is not None:
            # Starts are uniform on [0, hi): each member's real prefix, read
            # once here (a masked dataset's padding is a suffix).
            if data_axis and data.mask is not None:
                real = torch.sum(data.mask, dim=1).round().to(torch.float64)
                hi = torch.clamp(real - self.window_n + 1, min=1.0)
            else:
                hi = torch.full((n,), float(self.start_hi),
                                dtype=torch.float64)
            self.start_hi = hi.to(data.y.device)

    # -- state ------------------------------------------------------------

    def init_state(self, params: GPSSMParams) -> TrainState:
        """The stacked ``TrainState`` of stacked ``params``: Adam over the
        stacked Adam leaves, which is C independent Adams (optax's formula)
        with one shared step count; the SG-HMC state (C, ...) and the
        window (C, window_size, ...) of the SG-HMC leaves."""
        for k, v in params.leaves().items():
            if v.shape[0] != self.n:
                raise ValueError(f"leaf {k} has leading size {v.shape[0]}, "
                                 f"expected {self.n} ({self.axis_name}s)")
        return super().init_state(params)

    def member_data(self, i: int) -> SSMData:
        """Member ``i``'s data (the shared data on the chain axis)."""
        if not self.data_axis:
            return self.data
        d = self.data
        return SSMData(y=d.y[i], control=d.control[i],
                       mask=None if d.mask is None else d.mask[i])

    # -- the objective under vmap -----------------------------------------

    # One member's objective, the function that goes under vmap.
    member_nll = Trainer.train_nll

    def train_nll(self, params: GPSSMParams, data: Optional[SSMData] = None,
                  start: Optional[torch.Tensor] = None,
                  eps: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """(n,) training objectives of stacked ``params``: member i on the
        window at ``start[i]`` (None: full batch) with inter-layer normals
        ``[e[i] for e in eps]`` (None: layer means)."""
        data = self.data if data is None else data
        dd = 0 if self.data_axis else None
        inputs = {"y": data.y, "control": data.control, "mask": data.mask,
                  "start": start, "eps": eps}
        mapped = {k: v for k, v in inputs.items() if v is not None}
        dims = {k: (dd if k in ("y", "control", "mask") else 0)
                for k in mapped}

        def one(lv, m):
            full = {**dict.fromkeys(inputs), **m}
            return self.member_nll(
                GPSSMParams.from_leaves(lv),
                SSMData(y=full["y"], control=full["control"],
                        mask=full["mask"]), full["start"], full["eps"])

        with no_vmap_fallback():
            return torch.func.vmap(one, in_dims=(0, dims))(params.leaves(),
                                                           mapped)

    # -- the hooks that index members ---------------------------------------

    def _draw_starts(self, n_evals: int, generator: torch.Generator,
                     dev) -> torch.Tensor:
        """(n, n_evals) window starts, each uniform on its member's
        [0, hi)."""
        u = torch.rand(self._whole_lead() + (n_evals,), generator=generator,
                       device=generator.device, dtype=torch.float64)
        return torch.floor(self._share(u.to(dev))
                           * self.start_hi[:, None]).long()

    def _window_slot(self, w: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Member c's slot ``i[c]`` of the windows (n, window_size, ...)."""
        return w[torch.arange(self.n, device=w.device), i]

    def _pg(self, params: GPSSMParams, generator, pg) -> GPSSMParams:
        """C6: one particle-Gibbs sweep per member, one after another
        (``pg`` one sweep's draws per member)."""
        xs = [self.pg_fn(member(params, i), generator, self.member_data(i),
                         draws=None if pg is None else pg[i]).x
              for i in range(self.n)]
        return dataclasses.replace(params, x=torch.stack(xs))

    def _raise_non_finite(self, nlls: torch.Tensor, done: int,
                          state: TrainState):
        """Name the first non-finite iteration and member of a chunk's
        (T, n) trace (``ffvd_tpu/parallel/sharding.py:38-46``)."""
        bad = torch.nonzero(~torch.isfinite(nlls))[0]
        raise FloatingPointError(
            f"non-finite nll at iteration {done + int(bad[0])} in "
            f"{self.axis_name} {int(bad[1])}; try fp64 or a larger jitter "
            "(cfg.jitter)")


# ---------------------------------------------------------------------------
# The mesh: members over 'dp', each model's latent dims over 'ep'
# ---------------------------------------------------------------------------

# The head's per-dim leaves and their latent-dim axis, counted from the end,
# so it holds under any leading axes (members, sub-steps, window slots).
EP_AXIS = {"u": -1, "kernel.log_variance": -1,
           "kernel.log_lengthscales": -2, "log_q": -1}


def mesh_shape(n: int, ep: Optional[int] = None,
               x_dim: int = 4) -> Tuple[int, int]:
    """(dp, ep) of a mesh of ``n`` devices: 'ep' defaults to the largest
    power of two ≤ min(x_dim, n) that divides n, as JAX's ``make_mesh``
    (``ffvd_tpu/parallel/sharding.py:49-61``)."""
    if ep is None:
        ep = _default_ep(n, x_dim)
    if n % ep != 0:
        raise ValueError(f"ep={ep} does not divide the {n}-device mesh")
    return n // ep, ep


def make_mesh(n_devices: Optional[int] = None, ep: Optional[int] = None,
              x_dim: int = 4):
    """A ('dp', 'ep') ``DeviceMesh`` over every process of the started
    group, shaped by ``mesh_shape``.  The port runs one process a device,
    so ``n_devices`` (default: all) must be the group's size."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices in a group of {n} "
                         "processes: one process runs each device, and the "
                         "mesh takes them all")
    return init_device_mesh(mesh_device_type(), mesh_shape(n, ep, x_dim),
                            mesh_dim_names=("dp", "ep"))


def axis_size(mesh, name: str) -> int:
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh, name: str) -> int:
    return 0 if axis_size(mesh, name) == 1 else mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of this process's line along ``name``, or None
    when the axis has one process."""
    return None if axis_size(mesh, name) == 1 else mesh.get_group(name)


def dim_split(d: int, ep: int, e: int) -> Tuple[int, int]:
    """Latent dims [lo, hi) of 'ep' coordinate e: D over ep as evenly as it
    goes, the larger blocks first."""
    base, rem = divmod(d, ep)
    lo = e * base + min(e, rem)
    return lo, lo + base + (1 if e < rem else 0)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One process's block of the whole run: members [m0, m1) of ``n`` and
    latent dims [d0, d1) of ``d``."""

    members: Tuple[int, int]
    n: int
    dims: Tuple[int, int]
    d: int


def placement(mesh, n: int, d: int) -> Placement:
    dp, ep = axis_size(mesh, "dp"), axis_size(mesh, "ep")
    if n % dp != 0:
        raise ValueError(f"{n} members do not divide over dp={dp}")
    if ep > d:
        raise ValueError(f"ep={ep} exceeds the {d} latent dims")
    per, i = n // dp, axis_index(mesh, "dp")
    return Placement((i * per, (i + 1) * per), n,
                     dim_split(d, ep, axis_index(mesh, "ep")), d)


def share_leaf(t: torch.Tensor, path: Optional[str],
               pl: Placement) -> torch.Tensor:
    """The block of ``t`` (member axis first, whole shape) that ``pl``
    holds: its members and, for a per-dim leaf's tensor, its dims."""
    m0, m1 = pl.members
    t = t.narrow(0, m0, m1 - m0)
    if path in EP_AXIS:
        d0, d1 = pl.dims
        t = t.narrow(t.dim() + EP_AXIS[path], d0, d1 - d0)
    return t


def gather_leaves(tree: Leaves, pl: Placement, mesh, members: bool = True
                  ) -> Leaves:
    """The whole tensors of every process's blocks: the per-dim leaves'
    dims gathered over 'ep', then (``members``) the members over 'dp'.
    One all-reduce per axis."""
    out = dict(tree)
    ep_paths = [k for k in out if k in EP_AXIS]
    if ep_paths and axis_size(mesh, "ep") > 1:
        out.update(zip(ep_paths, gather_blocks(
            [(out[k], out[k].dim() + EP_AXIS[k]) for k in ep_paths],
            pl.dims[0], pl.d, axis_group(mesh, "ep"))))
    if members and axis_size(mesh, "dp") > 1:
        keys = list(out)
        out.update(zip(keys, gather_blocks([(out[k], 0) for k in keys],
                                           pl.members[0], pl.n,
                                           axis_group(mesh, "dp"))))
    return out


def params_pspec(chain_axis: bool = True, n_hidden: int = 0
                 ) -> Dict[str, tuple]:
    """Leaf path → the mesh axis of each leading dim (None: replicated;
    dims past the tuple replicated), JAX's assignments
    (``ffvd_tpu/parallel/sharding.py:64-87``): chains over 'dp'; x, u, c,
    the kernel hypers and log Q by latent dim over 'ep'; the hidden layers'
    u and kernel like the head's.  The port holds x, c and the hidden
    layers whole within an 'ep' group (``shard_chain_state``)."""
    pre = ("dp",) if chain_axis else ()
    spec = {"x": pre + (None, "ep"), "u": pre + (None, "ep"), "z": pre,
            "kernel.log_variance": pre + ("ep",),
            "kernel.log_lengthscales": pre + ("ep",),
            "log_q": pre + ("ep",), "c": pre + ("ep",), "d": pre,
            "log_rchol": pre}
    for path in hidden_paths(n_hidden):
        field = path.split(".", 2)[2]
        spec[path] = {"u": pre + (None, "ep"), "z": pre}.get(
            field, pre + ("ep",))
    return spec


def state_pspec(state: TrainState) -> Dict[str, tuple]:
    """``params_pspec`` for every tensor of a chain-stacked ``TrainState``,
    keyed "params.<path>", "sghmc.<field>.<path>", "window.<path>",
    "adam.exp_avg.<path>", "adam.exp_avg_sq.<path>", "adam.step", "step"
    and "window_count", with JAX's assignments
    (``ffvd_tpu/parallel/sharding.py:94-103``): the SG-HMC state like its
    leaves, the window and Adam's moments over 'dp', the counts
    replicated (the port's step and window count are one int for all
    members)."""
    pspec = params_pspec(n_hidden=len(state.params.hidden))
    out = {f"params.{k}": v for k, v in pspec.items()}
    if state.sghmc is not None:
        for f in ("xi", "g", "g2", "p"):
            out.update({f"sghmc.{f}.{k}": pspec[k]
                        for k in getattr(state.sghmc, f)})
    out.update({f"window.{k}": ("dp",) for k in state.window})
    for k in _adam_paths(state):
        out[f"adam.exp_avg.{k}"] = ("dp",)
        out[f"adam.exp_avg_sq.{k}"] = ("dp",)
    if state.adam is not None:
        out["adam.step"] = ()
    out.update(step=(), window_count=())
    return out


def _adam_paths(state: TrainState) -> List[str]:
    """The paths of the Adam leaves, in the optimizer's order."""
    if state.adam is None:
        return []
    by_id = {id(v): k for k, v in state.params.leaves().items()}
    return [by_id[id(p)] for p in state.adam.param_groups[0]["params"]]


def map_state(state: TrainState, fn: Callable) -> TrainState:
    """A new ``TrainState`` of ``fn(path, tensor)`` for every tensor of
    ``state`` (params, SG-HMC state, window, Adam's moments), with a fresh
    Adam over the new leaves carrying the mapped moments."""
    leaves = {k: fn(k, v.detach()).requires_grad_(v.requires_grad)
              for k, v in state.params.leaves().items()}
    adam = None
    if state.adam is not None:
        paths = _adam_paths(state)
        group = state.adam.param_groups[0]
        adam = torch.optim.Adam([leaves[k] for k in paths],
                                **{k: v for k, v in group.items()
                                   if k != "params"})
        for k, old in zip(paths, group["params"]):
            st = state.adam.state.get(old)
            if st:
                adam.state[leaves[k]] = {
                    "step": st["step"].clone(),
                    "exp_avg": fn(k, st["exp_avg"]),
                    "exp_avg_sq": fn(k, st["exp_avg_sq"])}
    sghmc = None if state.sghmc is None else SGHMCState(**{
        f: {k: fn(k, v) for k, v in getattr(state.sghmc, f).items()}
        for f in ("xi", "g", "g2", "p")})
    return TrainState(params=GPSSMParams.from_leaves(leaves), adam=adam,
                      step=state.step, sghmc=sghmc,
                      window={k: fn(k, w) for k, w in state.window.items()},
                      window_count=state.window_count)


def shard_chain_state(state: TrainState, mesh) -> TrainState:
    """This process's share of a whole chain-stacked ``TrainState``: its
    members and, of the per-dim leaves (``EP_AXIS``) and of every tensor
    shaped like one (its SG-HMC state, window and Adam moments, which each
    process moves itself), its latent dims.  Where ``state_pspec`` puts x,
    c and the hidden layers over 'ep' (JAX's GSPMD layout), the port holds
    them whole on every process of an 'ep' group, and it splits the window
    and the Adam moments of the per-dim leaves where JAX's spec has them
    over 'dp' only."""
    x = state.params.x
    pl = placement(mesh, x.shape[0], x.shape[-1])
    return map_state(state, lambda k, t: share_leaf(t, k, pl).clone())


def gather_chain_state(state: TrainState, mesh) -> TrainState:
    """The whole chain-stacked ``TrainState`` from every process's share
    (``shard_chain_state``'s inverse, exact), on every process: for
    evaluation and checkpoints."""
    x = state.params.x
    pl = placement(mesh, x.shape[0] * axis_size(mesh, "dp"), x.shape[-1])
    return map_state(state, lambda k, t: gather_leaves({k: t}, pl, mesh)[k])


class MeshBatchedTrainer(BatchedTrainer):
    """``BatchedTrainer`` on one process's share of a ('dp', 'ep') mesh
    (see the module docstring); with ``mesh=None`` it is the
    ``BatchedTrainer`` of all ``n`` members.  ``init_state`` takes the
    whole stacked params and keeps the share; ``run`` returns the whole
    trace on every process."""

    def __init__(self, cfg: FFVDConfig, data: SSMData, n: int,
                 data_axis: bool, mesh=None, pg_fn=None):
        self.mesh = mesh
        self.place = placement(mesh, n, cfg.x_dim)
        m0, m1 = self.place.members
        if data_axis and mesh is not None:
            data = SSMData(y=data.y[m0:m1], control=data.control[m0:m1],
                           mask=None if data.mask is None
                           else data.mask[m0:m1])
        super().__init__(cfg, data, m1 - m0, data_axis, pg_fn=pg_fn)
        self.n_whole = n
        self.ep_group = axis_group(mesh, "ep")
        if self.ep_group is not None:
            part = dict(dims=self.place.dims,
                        shared=axis_index(mesh, "ep") == 0)
            self.nll_fn = functools.partial(self.nll_fn, **part)
            if self.window_n is not None:
                self.win_nll_fn = functools.partial(self.win_nll_fn, **part)

    def init_state(self, params: GPSSMParams) -> TrainState:
        """The state of this process's share of the whole stacked
        ``params`` (leading axis n, D = cfg.x_dim latent dims)."""
        if self.mesh is not None:
            x = params.x
            if x.shape[0] != self.n_whole or x.shape[-1] != self.place.d:
                raise ValueError(
                    f"params hold {x.shape[0]} members of {x.shape[-1]} "
                    f"latent dims; the mesh shares {self.n_whole} of "
                    f"{self.place.d} (cfg.x_dim)")
            params = GPSSMParams.from_leaves({
                k: share_leaf(v.detach(), k, self.place)
                for k, v in params.leaves().items()})
        return super().init_state(params)

    def whole_dims(self, params: GPSSMParams) -> GPSSMParams:
        """This process's members with all D latent dims (gathered over
        'ep'): the PG sweep and the rollout need every dim."""
        if self.ep_group is None:
            return params
        return GPSSMParams.from_leaves(gather_leaves(
            params.leaves(), self.place, self.mesh, members=False))

    # -- the hooks of a sharded run (inference/trainer.py) ------------------

    def _whole_lead(self) -> Tuple[int, ...]:
        return (self.n_whole,)

    def _whole_like(self, leaves: Leaves) -> Leaves:
        if self.mesh is None:
            return leaves
        out = {}
        for k, v in leaves.items():
            shape = [self.n_whole] + list(v.shape[1:])
            if k in EP_AXIS:
                shape[len(shape) + EP_AXIS[k]] = self.place.d
            out[k] = v.new_empty(shape)
        return out

    def _share(self, t: torch.Tensor, path: Optional[str] = None
               ) -> torch.Tensor:
        return t if self.mesh is None else share_leaf(t, path, self.place)

    def _reduce_grads(self, paths, grads) -> list:
        idx = [i for i, k in enumerate(paths) if k not in EP_AXIS]
        out = list(grads)
        for i, g in zip(idx, all_sum_flat([grads[i] for i in idx],
                                          self.ep_group)):
            out[i] = g
        return out

    def _reduce_nll(self, nll: torch.Tensor) -> torch.Tensor:
        return all_sum(nll.clone(), self.ep_group)

    def _gather_trace(self, nlls: torch.Tensor) -> torch.Tensor:
        return gather_blocks([(nlls, 1)], self.place.members[0],
                             self.n_whole, axis_group(self.mesh, "dp"))[0]

    def _pg(self, params: GPSSMParams, generator, pg) -> GPSSMParams:
        """C6 on a mesh: every member's sweep draws are made in order, this
        process's members sweep with all D dims (the same sweep on every
        process of an 'ep' group)."""
        if self.mesh is None:
            return super()._pg(params, generator, pg)
        if pg is None and not self.cfg.pg_compat_noop:
            from ffvd_tpu_torch.inference.particle_gibbs import pg_draws
            p0 = member(params, 0)
            pg = [pg_draws(self.cfg, p0, generator)
                  for _ in range(self.n_whole)]
        m0, m1 = self.place.members
        local = None if pg is None else list(pg)[m0:m1]
        swept = super()._pg(self.whole_dims(params), generator, local)
        return dataclasses.replace(params, x=swept.x)


def stack_warmstarts(dataset: str, file_ids, device="cpu",
                     dtype=torch.float64) -> GPSSMParams:
    """Several Factnonlin warm starts of one dataset stacked on a chain axis
    (``ffvd_tpu/parallel/sharding.py:109-119``): the reference runs them as
    separate processes (FFVD_Main.py:363,386); here they train as chains of
    one ``MultiChainTrainer`` and the best posterior is picked afterwards.
    Warm starts other than the vendored ``file_id=3`` need the reference
    data directory (``data/warmstart.py``)."""
    from ffvd_tpu_torch.data import load_warmstart
    from ffvd_tpu_torch.model.params import init_params_from_warmstart
    return stack_members([init_params_from_warmstart(
        load_warmstart(dataset, f), device=device, dtype=dtype)
        for f in file_ids])


class MultiChainTrainer(MeshBatchedTrainer):
    """C independent FFVD chains of one dataset in one batched step
    (``ffvd_tpu/parallel/sharding.py:122-192``): each chain follows the
    full single-chain protocol.  With a ``mesh`` (``make_mesh``) this
    process runs chains [m0, m1) of C over 'dp' and its block of each
    chain's latent dims over 'ep'."""

    axis_name = "chain"

    def __init__(self, cfg: FFVDConfig, data: SSMData, n_chains: int,
                 mesh=None, pg_fn=None):
        super().__init__(cfg, data, n_chains, data_axis=False, mesh=mesh,
                         pg_fn=pg_fn)

    def stack_params(self, params: GPSSMParams,
                     generator: Optional[torch.Generator] = None,
                     normals: Optional[Leaves] = None) -> GPSSMParams:
        """One start replicated across the chains, each leaf perturbed by
        1e-3·N(0, 1) per chain so that the chains decorrelate, as JAX's
        ``stack_params(params, jitter_key)`` does.  The normals are
        ``normals`` (path → (C, ...)) or drawn from ``generator`` on its
        device; with neither, the chains start identical."""
        out = {}
        for k, v in params.leaves().items():
            a = v.detach().expand((self.n_whole,) + tuple(v.shape)).clone()
            if normals is not None:
                a = a + 1e-3 * torch.tensor(np.asarray(normals[k]),
                                            dtype=a.dtype, device=a.device)
            elif generator is not None:
                a = a + 1e-3 * torch.randn(
                    tuple(a.shape), generator=generator, dtype=a.dtype,
                    device=generator.device).to(a.device)
            out[k] = a
        return GPSSMParams.from_leaves(out)

    @staticmethod
    def rhat(nll_trace, burn_frac: float = 0.5) -> float:
        """Split-R̂ over the post-burn-in tail of ``run``'s (T, C) trace
        (R̂ ≲ 1.01 on the nll: the chains agree)."""
        from ffvd_tpu_torch.utils.metrics import split_rhat
        trace = (nll_trace.detach().cpu().numpy()
                 if torch.is_tensor(nll_trace) else np.asarray(nll_trace))
        return split_rhat(trace[int(trace.shape[0] * burn_frac):])
