"""ffvd_tpu_torch — the PyTorch/CUDA port of ``ffvd_tpu``.

Free-Form Variational inference for GP state-space models (FFVD, ICML 2023)
on one NVIDIA H100: the same case table, ELBO terms, training protocol,
rollout evaluation and results files as the JAX package, which stays in the
repository as the reference the port is held against.  Plain tensor code is
PyTorch; the fused posterior rollout is a CUDA kernel written for sm_90a
(``csrc/rollout.cu``), built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports nothing of JAX or of ``ffvd_tpu``.
"""

from ffvd_tpu_torch.config import CASE_TABLE, CaseConfig, FFVDConfig
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.elbo import elbo_terms, negative_elbo
from ffvd_tpu_torch.model.params import (GPSSMParams,
                                         init_params_from_warmstart,
                                         params_from_numpy, params_to_numpy)
from ffvd_tpu_torch.version import __version__

__all__ = [
    "FFVDConfig",
    "CaseConfig",
    "CASE_TABLE",
    "GPSSMParams",
    "init_params_from_warmstart",
    "params_from_numpy",
    "params_to_numpy",
    "negative_elbo",
    "elbo_terms",
    "Trainer",
    "__version__",
]
