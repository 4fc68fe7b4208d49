from ffvd_tpu_torch.inference.sghmc import SGHMCState, sghmc_init, sghmc_step
from ffvd_tpu_torch.inference.trainer import Trainer, TrainState

__all__ = ["SGHMCState", "sghmc_init", "sghmc_step", "Trainer", "TrainState"]
