"""Parameters of the GPSSM and their warm-start initialisation.

Counterpart of ``ffvd_tpu/model/params.py``.  Shapes (ballbeam defaults):

    x          (N+1, D) = (501, 4)   latent trajectory incl. x₀
    u          (M, D)   = (100, 4)   whitened inducing outputs
    z          (M, Din) = (100, 5)   inducing inputs, Din = D + control dim
    kernel     log-variance (D,), log-lengthscales (D, Din)
    log_q      (D,)                  process-noise log-variance
    c          (D, P)                emission matrix
    d          (P,)                  emission offset
    log_rchol  (P, P)                emission noise log-Cholesky

Weights cross between the two packages as numpy arrays keyed by field path
(``params_from_numpy`` / ``params_to_numpy``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ffvd_tpu_torch.ops.kernels import KernelParams

# Field paths of the leaves, in the JAX package's pytree order.
LEAF_PATHS = ("x", "u", "z", "kernel.log_variance", "kernel.log_lengthscales",
              "log_q", "c", "d", "log_rchol")


@dataclasses.dataclass
class GPSSMParams:
    x: torch.Tensor
    u: torch.Tensor
    z: torch.Tensor
    kernel: KernelParams
    log_q: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    log_rchol: torch.Tensor

    @property
    def q(self) -> torch.Tensor:
        return torch.exp(self.log_q)

    @property
    def rchol_diag(self) -> torch.Tensor:
        """Emission noise std-devs (diagonal of the exp-parameterised
        Cholesky)."""
        return torch.exp(torch.diagonal(self.log_rchol))

    @property
    def rchol(self) -> torch.Tensor:
        """Full lower-triangular emission-noise Cholesky L, R = L·Lᵀ:
        diagonal stored in log, strictly-lower triangle stored raw."""
        lower = torch.tril(self.log_rchol, -1)
        return lower + torch.diag(torch.exp(torch.diagonal(self.log_rchol)))

    @property
    def r_var_diag(self) -> torch.Tensor:
        """diag(R) = diag(L·Lᵀ)."""
        l = self.rchol
        return torch.sum(l * l, dim=1)

    @property
    def p_dim(self) -> int:
        return self.c.shape[1]

    @property
    def n_transitions(self) -> int:
        return self.x.shape[0] - 1

    @property
    def x_dim(self) -> int:
        return self.x.shape[1]

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The leaf tensors keyed by field path (``LEAF_PATHS`` order)."""
        return {"x": self.x, "u": self.u, "z": self.z,
                "kernel.log_variance": self.kernel.log_variance,
                "kernel.log_lengthscales": self.kernel.log_lengthscales,
                "log_q": self.log_q, "c": self.c, "d": self.d,
                "log_rchol": self.log_rchol}

    @classmethod
    def from_leaves(cls, leaves: Dict[str, torch.Tensor]) -> "GPSSMParams":
        return cls(x=leaves["x"], u=leaves["u"], z=leaves["z"],
                   kernel=KernelParams(
                       log_variance=leaves["kernel.log_variance"],
                       log_lengthscales=leaves["kernel.log_lengthscales"]),
                   log_q=leaves["log_q"], c=leaves["c"], d=leaves["d"],
                   log_rchol=leaves["log_rchol"])


@dataclasses.dataclass
class SSMData:
    """Observed data: y (N, P) and control inputs (N_total, U); U may be 0.

    ``mask`` (N,), optional: 1.0 for real transitions, 0.0 for padding; the
    ELBO then sums and normalises over real steps only."""

    y: torch.Tensor
    control: torch.Tensor
    mask: Optional[torch.Tensor] = None


def params_from_numpy(tree: Dict[str, np.ndarray], device="cpu",
                      dtype=torch.float64) -> GPSSMParams:
    """Build params from numpy leaves keyed by field path (``LEAF_PATHS``)."""
    missing = [k for k in LEAF_PATHS if k not in tree]
    if missing:
        raise KeyError(f"params tree missing leaves {missing}")
    return GPSSMParams.from_leaves({
        k: torch.tensor(np.asarray(tree[k]), dtype=dtype, device=device)
        for k in LEAF_PATHS})


def params_to_numpy(params: GPSSMParams) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_numpy``."""
    return {k: v.detach().cpu().numpy() for k, v in params.leaves().items()}


def init_params_from_warmstart(ws: dict, device="cpu",
                               dtype=torch.float64) -> GPSSMParams:
    """Build params from a Factnonlin warm-start dict (key semantics follow
    FFVD_Main.py:212-256):

      x₀ = qx1_mu_ini, x₁..N = mean over the sample axis of
      x_samples_training; U = Umu_iniᵀ; log_q = 2·log Q_sqrt_ini;
      C = C_valᵀ; log R = log R_chol_val (diagonal; strictly-lower raw).
    """
    x0 = np.asarray(ws["qx1_mu_ini"])
    x_train = np.mean(np.asarray(ws["x_samples_training"]), axis=1)  # (N, D)
    r_chol = np.atleast_2d(np.asarray(ws["R_chol_val"]))
    tree = {
        "x": np.concatenate([x0[None, :], x_train], axis=0),
        "u": np.asarray(ws["Umu_ini"]).T,
        "z": np.asarray(ws["Z_val"]),
        "kernel.log_variance": np.log(np.asarray(ws["kernel_variance"])),
        "kernel.log_lengthscales": np.log(
            np.asarray(ws["kernel_lengthscales"])),
        "log_q": 2.0 * np.log(np.asarray(ws["Q_sqrt_ini"])),
        "c": np.asarray(ws["C_val"]).T,
        "d": np.asarray(ws["d_val"]),
        "log_rchol": np.tril(r_chol, -1) + np.diag(np.log(np.diagonal(r_chol))),
    }
    return params_from_numpy(tree, device=device, dtype=dtype)
