"""Periodic training checkpoints with an exact resume.

Counterpart of ``ffvd_tpu/utils/checkpoint.py``, with ``torch.save``
instead of orbax.  The reference has no mid-training checkpoint: a crash
loses the run.  A checkpoint here holds the whole ``TrainState`` (params,
the Adam ``state_dict``, the SG-HMC state, the window, its count and the
step; one member or a stacked ``parallel`` state alike) and the state of
the training ``torch.Generator``.  JAX derives every key from (key,
iteration); the port's draws come from one generator stream, so an exact
resume restores that stream with the state.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional

import torch

from ffvd_tpu_torch.inference.sghmc import SGHMCState
from ffvd_tpu_torch.inference.trainer import TrainState

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
             generator: Optional[torch.Generator] = None) -> None:
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
                generator: Optional[torch.Generator] = None) -> TrainState:
        """Load checkpoint ``step`` (default: the newest) into ``state``, a
        fresh ``init_state`` of the same trainer: the params are copied into
        its leaves in place, so its Adam stays bound to them.  With
        ``generator``, its state is restored too."""
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
        dev = state.params.x.device
        with torch.no_grad():
            for k, v in state.params.leaves().items():
                v.copy_(payload["params"][k])
        if state.adam is not None:
            state.adam.load_state_dict(payload["adam"])
        if payload["sghmc"] is not None:
            state.sghmc = SGHMCState(**{
                f: {k: v.to(dev) for k, v in leaves.items()}
                for f, leaves in payload["sghmc"].items()})
        state.window = {k: v.to(dev) for k, v in payload["window"].items()}
        state.window_count = payload["window_count"]
        state.step = payload["step"]
        if generator is not None:
            generator.set_state(payload["generator"])
        return state


def run_with_checkpoints(trainer, state: TrainState, num_iterations: int,
                         manager: CheckpointManager, every: int = 500,
                         chunk_size: int = 500,
                         generator: Optional[torch.Generator] = None):
    """``trainer.run`` up to iteration ``num_iterations`` (counted from 0,
    so a restored state runs only the rest), saving state and ``generator``
    every ``every`` iterations.  ``trainer`` is a ``Trainer`` or a
    ``parallel`` trainer.  Returns (state, the trace of this call)."""
    traces = []
    done = state.step
    while done < num_iterations:
        n = min(every, chunk_size, num_iterations - done)
        state, nlls = trainer.run(state, n, chunk_size=n, generator=generator)
        traces.append(nlls)
        done += n
        manager.save(done, state, generator)
    if not traces:
        return trainer.run(state, 0, generator=generator)
    return state, torch.cat(traces)
