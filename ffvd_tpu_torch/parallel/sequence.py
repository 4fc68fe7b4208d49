"""Sequence (time-axis) parallelism for long trajectories.

Counterpart of ``ffvd_tpu/parallel/sequence.py``.  The FFVD objective is
parallel over t: every GP term is a batched gram or projection over the N
transitions, and every reduction over t is a sum.  JAX shards the time axis
over an 'sp' mesh axis and lets XLA turn the sums into collectives.  Here
each of the W processes of the 'sp' axis owns transitions [t0, t1) (x row
t1 is its read-only halo; N need not divide by W) and:

- computes the sums over its rows: the H-gram F̃ᵀF̃ and the a-vector F̃ᵀΔx
  of the collapsed bound, its trace, the emission and x-dynamics sums, the
  mask count Y_N (``model/elbo.py``, ``reduce``);
- sums each over 'sp' before anything nonlinear, through a differentiable
  all-reduce, so that every process factors the same H_d and holds the same
  objective;
- runs its backward too: the all-reduce's backward sums the cotangents of
  all W processes, so each process's gradient counts the shared objective
  W times.  The gradients of all leaves are summed over 'sp' and divided by
  W, which gives the gradient of the objective once.

The state stays whole on every process (x is N×D, a few KB): the work that
splits is the (D, M, N) projection and its products.  The draws are the
single process's on every process.  The C6 sweep runs on the whole x on
every process, with the same draws; a deep model's hidden propagation is
row-local; the ds64 segment reduces its sums in float64.  A windowed
objective (``minibatch_size < N``) splits the same way: the window, whose
start every process draws alike and keeps on the device, lies on one or two
processes' rows, each evaluates the part in its rows with the one-process
scales, and the window sums are reduced as the full batch's are
(``model/elbo.py::windowed_elbo_terms``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference.trainer import Trainer, TrainState
from ffvd_tpu_torch.model.params import SSMData
from ffvd_tpu_torch.parallel.distributed import (all_sum_flat, diff_sum,
                                                 mesh_device_type)
from ffvd_tpu_torch.parallel.sharding import (axis_group, axis_index,
                                              axis_size, dim_split)


def make_seq_mesh(n_devices: Optional[int] = None):
    """An ('sp',) ``DeviceMesh`` over every process of the started group
    (one process a device: ``n_devices``, default all, must be its size)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices in a group of {n} "
                         "processes: one process runs each device, and the "
                         "mesh takes them all")
    return init_device_mesh(mesh_device_type(), (n,), mesh_dim_names=("sp",))


def shard_sequence(data: SSMData, mesh) -> Tuple[Tuple[int, int], SSMData]:
    """This process's transitions (t0, t1) of ``data``'s N, as evenly as
    they go, and its rows of y, the controls and the mask (views)."""
    n = data.y.shape[0]
    sp = axis_size(mesh, "sp")
    if n < sp:
        raise ValueError(f"{n} transitions do not spread over sp={sp}")
    t0, t1 = dim_split(n, sp, axis_index(mesh, "sp"))
    return (t0, t1), SSMData(
        y=data.y[t0:t1], control=data.control[t0:t1],
        mask=None if data.mask is None else data.mask[t0:t1])


class RowShareTrainer(Trainer):
    """The training protocol of ``Trainer`` on this process's transitions
    of an 'sp' mesh (see the module docstring)."""

    def __init__(self, cfg: FFVDConfig, data: SSMData, mesh, pg_fn=None):
        super().__init__(cfg, data, pg_fn=pg_fn)
        self.mesh = mesh
        self.rows, _ = shard_sequence(data, mesh)
        self.group = axis_group(mesh, "sp")
        self.width = axis_size(mesh, "sp")
        if self.group is not None:
            self.step_collectives = (("sp", dist.get_backend(self.group)),)
        part = dict(rows=self.rows,
                    reduce=functools.partial(diff_sum, group=self.group))
        self.nll_fn = functools.partial(self.nll_fn, **part)
        if self.window_n is not None:
            self.win_nll_fn = functools.partial(self.win_nll_fn, **part)

    def _reduce_grads(self, paths, grads) -> list:
        if self.group is None:
            return grads
        return [g / self.width for g in all_sum_flat(grads, self.group)]


class SequenceShardedTrainer:
    """``trainer``'s protocol (its config, data and sweep) with the time
    axis split over ``mesh``'s 'sp' axis.  The draws of ``run`` are those
    of ``Trainer.run`` with the same generator, so a sharded run
    reproduces an unsharded one up to the order of the sums."""

    def __init__(self, trainer: Trainer, mesh):
        if trainer.lead:
            raise ValueError("'sp' splits one model's transitions; members "
                             "of a batched trainer go over 'dp'")
        self.trainer = RowShareTrainer(trainer.cfg, trainer.data, mesh,
                                       pg_fn=trainer.pg_fn)
        self.mesh = mesh

    def run(self, state: TrainState, data: SSMData, num_iterations: int,
            chunk_size: int = 500, nan_check: bool = True,
            generator: Optional[torch.Generator] = None, draws=None,
            capture: Optional[bool] = None):
        """``Trainer.run`` on ``data`` (of the trainer's shapes), every
        process holding the whole ``state``.  Returns (state, nll_trace),
        the same on every process.  ``capture`` as in ``Trainer.run``: the
        step all-reduces over 'sp', so by default it is captured on NCCL,
        its graph living until this call returns, and runs eagerly on gloo
        (``inference.trainer.capture_rule``)."""
        if data.y.shape != self.trainer.data.y.shape:
            raise ValueError(f"data of {tuple(data.y.shape)} rows, the "
                             "trainer's of "
                             f"{tuple(self.trainer.data.y.shape)}")
        self.trainer.data = data
        return self.trainer.run(state, num_iterations, chunk_size=chunk_size,
                                nan_check=nan_check, generator=generator,
                                draws=draws, capture=capture)
