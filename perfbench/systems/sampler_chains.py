"""Seeds of one dataset side by side under a sampler case: one
``MultiChainTrainer`` of the port whose step runs the SG-HMC phase.

The chains start as in ``systems/multichain.py``: the dataset's warm start
with every leaf perturbed by 1e-3·N(0, 1) from the run's seed.  Training
is ``MultiChainTrainer.run`` with a generator on the card, captured there
by default, so every step draws its sampler normals and its window slot
inside the graph.  The reference follows the same draws: each member's
start carries the training generator's seed and the chain count
(``make_members``).  The reference defines no evaluation of a sampler
case (its thinning), so no evaluation cell runs this system yet.
"""

from __future__ import annotations

from perfbench.systems import multichain
from perfbench.systems.multichain import make_inputs  # noqa: F401


def make_members(cfg: dict, inputs: dict, ref, data_dir) -> list:
    """``multichain.make_members``, each start handed the training
    generator's seed and its chain of ``cfg["chains"]``."""
    members = multichain.make_members(cfg, inputs, ref, data_dir)
    for i, mem in enumerate(members):
        mem["leaves"] = ref.with_draws(mem["leaves"], inputs["train_seed"],
                                       i, cfg["chains"])
    return members


class System(multichain.System):
    def __init__(self, cfg: dict, inputs: dict, device, dtype):
        from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS
        super().__init__(cfg, inputs, device, dtype)
        if not self.trainer.has_sghmc:
            raise ValueError(f"case {self.cfg.case} samples no leaf; "
                             "systems/multichain.py trains it")
        # gradient evaluations an iteration: the sub-steps', then Adam's
        self.work["grad_evals"] = len(SUBSTEP_FLAGS) + 1


def expected(ref, members, trained, call_seed, s, dtype, device):
    raise NotImplementedError("the reference has no thinned evaluation of "
                              "a sampler case: no cell evaluates one yet")


def compare(got, want) -> dict:
    raise NotImplementedError("no evaluation: see expected")
