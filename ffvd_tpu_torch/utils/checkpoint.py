"""Periodic training checkpoints with an exact resume.

Counterpart of ``ffvd_tpu/utils/checkpoint.py``, with ``torch.save``
instead of orbax.  The reference has no mid-training checkpoint: a crash
loses the run.  A checkpoint here holds the whole ``TrainState`` (params,
the Adam ``state_dict``, the SG-HMC state, the window, its count and the
step; one member or a stacked ``parallel`` state alike) and the state of
the training ``torch.Generator``.  JAX derives every key from (key,
iteration); the port's draws come from one generator stream, so an exact
resume restores that stream with the state.

A run split over processes (a trainer whose ``mesh`` is set:
``MultiChainTrainer`` or ``MultiDatasetTrainer`` over ('dp', 'ep'), the
row-share trainer of a ``SequenceShardedTrainer`` over 'sp') writes ONE
file, the whole state, as JAX hands orbax the global sharded state
(``ffvd_tpu/utils/checkpoint.py:31-80``):

- saving, every process checks that the ranks' generators agree (each
  makes the one-process draws and cuts its share, ``Trainer._share``), the
  trainer gives the whole state (``Trainer._whole_state``), rank 0 writes
  the file and prunes the old ones, and every process waits for it at a
  barrier;
- restoring, every process reads the whole file and keeps its share
  (``Trainer._share``).

The file is what one process of the same trainer without a mesh writes, so
a meshed checkpoint restores into one process and the reverse.  A mesh of
the port spans the whole started process group (``make_mesh``,
``make_seq_mesh``), so the checks and the barrier run on it.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ffvd_tpu_torch.inference.trainer import (TrainState,
                                              adam_steps_in_leaf_dtype)
from ffvd_tpu_torch.utils.graphs import scoped

CHECKPOINT_FORMAT = 1
"""Layout of a saved training state and the meaning of its generator
stream.  Bump it whenever a change makes a resumed run leave the original
trajectory; ``restore`` refuses any other format."""

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """``TrainState`` files keyed by outer iteration, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory, max_to_keep: int = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self._dir / f"ckpt_{step:09d}.pt"

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             generator: Optional[torch.Generator] = None,
             trainer=None) -> None:
        """Write ``state`` (and ``generator``'s state) as checkpoint
        ``step``.  With a meshed ``trainer`` every process of the run must
        call it: the whole state goes to one file (module docstring)."""
        meshed = trainer is not None and trainer.mesh is not None
        if meshed:
            _check_generators_agree(generator, state.params.x.device)
            state = trainer._whole_state(state)
        if not meshed or dist.get_rank() == 0:
            self._write(step, state, generator)
        if meshed:
            dist.barrier()

    def _write(self, step: int, state: TrainState,
               generator: Optional[torch.Generator]) -> None:
        sghmc = (None if state.sghmc is None else
                 {f: getattr(state.sghmc, f) for f in ("xi", "g", "g2", "p")})
        payload = {
            "format": CHECKPOINT_FORMAT,
            "params": {k: v.detach()
                       for k, v in state.params.leaves().items()},
            "adam": None if state.adam is None else state.adam.state_dict(),
            "sghmc": sghmc,
            "window": state.window,
            "window_count": int(state.window_count),
            "step": int(state.step),
            "generator": None if generator is None else generator.get_state(),
        }
        tmp = self._path(step).with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def restore(self, state: TrainState, step: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                trainer=None) -> TrainState:
        """Load checkpoint ``step`` (default: the newest) into ``state``, a
        fresh ``init_state`` of the same trainer: the params are copied into
        its leaves in place, so its Adam stays bound to them.  With
        ``generator``, its state is restored too.  With a ('dp', 'ep')
        meshed ``trainer``, ``state`` is this process's share and takes
        its share of the whole file."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        # Loaded on the host: Adam's load_state_dict moves its moments to
        # the params' device and keeps its step counts on the host.
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        fmt = payload.get("format") if isinstance(payload, dict) else None
        if fmt != CHECKPOINT_FORMAT:
            raise ValueError(
                f"checkpoint {step} under {self._dir} has format {fmt!r}, "
                f"but this build writes {CHECKPOINT_FORMAT}: its training "
                "state or random stream differs, so resuming would leave "
                "the original trajectory. Restart training instead.")
        if trainer is None:
            share = lambda path, t: t
        else:
            share = lambda path, t: trainer._share(t, path).clone()
        with torch.no_grad():
            for k, v in state.params.leaves().items():
                v.copy_(share(k, payload["params"][k]))
        if state.adam is not None:
            state.adam.load_state_dict(_share_adam(payload["adam"], state,
                                                   share))
            adam_steps_in_leaf_dtype(state.adam)
        # In place, so the state keeps its addresses (a captured step of
        # the trainer replays them; Adam's moments above are new tensors,
        # and its next run captures again).
        with torch.no_grad():
            if payload["sghmc"] is not None:
                for f, leaves in payload["sghmc"].items():
                    for k, v in leaves.items():
                        getattr(state.sghmc, f)[k].copy_(share(k, v))
            for k, v in payload["window"].items():
                state.window[k].copy_(share(k, v))
        state.window_count = payload["window_count"]
        state.step = payload["step"]
        if generator is not None:
            generator.set_state(payload["generator"])
        return state

    def close(self) -> None:
        """Nothing to wait for: every save has been written when it
        returns (JAX's ``close`` waits for orbax's asynchronous saves)."""


def _share_adam(sd: dict, state: TrainState, share: Callable) -> dict:
    """Adam's whole ``state_dict`` with each moment cut to this process's
    share (the step counts are one for all members)."""
    paths = state.adam_paths()
    # The restoring Adam keeps its own ``capturable``: on the card the step
    # count lives on the device, on the CPU on the host, and a checkpoint
    # moves between the two.
    groups = [{**g, "capturable": own["capturable"]}
              for g, own in zip(sd["param_groups"],
                                state.adam.param_groups)]
    return {"param_groups": groups,
            "state": {i: {f: (v if f == "step" else share(paths[i], v))
                          for f, v in st.items()}
                      for i, st in sd["state"].items()}}


def _generator_hash(generator: Optional[torch.Generator]) -> int:
    if generator is None:
        return 0
    state = generator.get_state().numpy().tobytes()
    return int.from_bytes(hashlib.blake2b(state, digest_size=7).digest(),
                          "little")


def _check_generators_agree(generator: Optional[torch.Generator],
                            dev) -> None:
    """Raise unless every process's ``generator`` has the same state (one
    all-reduce of a hash and its negation, by maximum)."""
    h = _generator_hash(generator)
    both = torch.tensor([h, -h], dtype=torch.int64, device=dev)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if int(both[0]) != h or int(-both[1]) != h:
        raise RuntimeError(
            f"rank {dist.get_rank()}: the processes' training generators "
            "differ; a meshed run draws with one stream on every process, "
            "so its checkpoint would not resume it")


@scoped
def run_with_checkpoints(trainer, state: TrainState, num_iterations: int,
                         manager: CheckpointManager, every: int = 500,
                         chunk_size: int = 500,
                         generator: Optional[torch.Generator] = None):
    """``trainer.run`` up to iteration ``num_iterations`` (counted from 0,
    so a restored state runs only the rest), saving state and ``generator``
    every ``every`` iterations.  ``trainer`` is a ``Trainer``, a
    ``parallel`` trainer, or the ``trainer`` of a
    ``SequenceShardedTrainer``; a meshed one is run by every process of
    its mesh, and each save writes one file (``CheckpointManager.save``).
    A step captured over NCCL is captured once for the whole call
    (``utils.graphs.graph_scope``).  Returns (state, the trace of this
    call)."""
    traces = []
    done = state.step
    while done < num_iterations:
        n = min(every, chunk_size, num_iterations - done)
        state, nlls = trainer.run(state, n, chunk_size=n, generator=generator)
        traces.append(nlls)
        done += n
        manager.save(done, state, generator, trainer=trainer)
    if not traces:
        return trainer.run(state, 0, generator=generator)
    return state, torch.cat(traces)
