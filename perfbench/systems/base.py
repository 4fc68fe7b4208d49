"""What every system under test built on one ``Trainer`` of the port
shares: its training call and the host copies that the check reads."""

from __future__ import annotations

import numpy as np


class TrainerSystem:
    """A system whose ``trainer``, ``state`` and ``generator`` a subclass
    sets; ``work`` holds the shapes the per-layer metrics count."""

    trainer = state = generator = work = None
    members = 0

    def train(self, n: int, chunk_size: int):
        """``n`` iterations of every member; the (n, members) nll trace."""
        return self.trainer.run(self.state, n, chunk_size=chunk_size,
                                generator=self.generator)[1]

    def leaves(self) -> dict:
        """Each leaf as a float64 copy on the host, path → (members, ...)."""
        return {k: v.detach().cpu().numpy().astype(np.float64)
                for k, v in self.state.params.leaves().items()}

    def first_moment(self) -> dict:
        """Adam's first moment of every trained leaf, by path (zeros before
        its first step)."""
        import torch
        adam = self.state.adam
        return {k: adam.state[p].get("exp_avg", torch.zeros_like(p))
                .detach().cpu().numpy().astype(np.float64)
                for k, p in zip(self.state.adam_paths(),
                                adam.param_groups[0]["params"])}
