"""Independent chains on one device: ``MultiChainTrainer`` and the batched
outer step that it shares with ``parallel/multidataset.py``.

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

Not ported yet: the mesh half of the JAX module (``make_mesh``,
``params_pspec``, ``state_pspec``, ``shard_chain_state``) and the
multi-host helpers.  They shard the chain axis over several devices and
wait for ``torch.distributed`` (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch._C._functorch as _functorch

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference.trainer import Leaves, Trainer, TrainState
from ffvd_tpu_torch.model.params import GPSSMParams, SSMData


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
        u = torch.rand((self.n, n_evals), generator=generator,
                       device=generator.device, dtype=torch.float64)
        return torch.floor(u.to(dev) * self.start_hi[:, None]).long()

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


class MultiChainTrainer(BatchedTrainer):
    """C independent FFVD chains of one dataset in one batched step
    (``ffvd_tpu/parallel/sharding.py:122-192``, on one device and with no
    mesh): each chain follows the full single-chain protocol."""

    axis_name = "chain"

    def __init__(self, cfg: FFVDConfig, data: SSMData, n_chains: int,
                 pg_fn=None):
        super().__init__(cfg, data, n_chains, data_axis=False, pg_fn=pg_fn)

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
            a = v.detach().expand((self.n,) + tuple(v.shape)).clone()
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
