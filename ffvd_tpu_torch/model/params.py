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
    hidden     deep-transition layers (``model/deep.py``), each with its own
               u (M, D), z (M, Din) and kernel; () for the shallow model

Weights cross between the two packages as numpy arrays keyed by field path
(``params_from_numpy`` / ``params_to_numpy``); a hidden layer i's leaves are
``hidden.{i}.u``, ``hidden.{i}.z``, ``hidden.{i}.kernel.log_variance`` and
``hidden.{i}.kernel.log_lengthscales``, after the head's, in the JAX
package's pytree order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ffvd_tpu_torch.ops.kernels import KernelParams

# Field paths of the head's leaves, in the JAX package's pytree order.
LEAF_PATHS = ("x", "u", "z", "kernel.log_variance", "kernel.log_lengthscales",
              "log_q", "c", "d", "log_rchol")
# A hidden layer's leaves, in the same order, under "hidden.{i}.".
HIDDEN_FIELDS = ("u", "z", "kernel.log_variance", "kernel.log_lengthscales")


def hidden_paths(n_hidden: int) -> Tuple[str, ...]:
    """Leaf paths of ``n_hidden`` hidden layers, layer by layer."""
    return tuple(f"hidden.{i}.{f}" for i in range(n_hidden)
                 for f in HIDDEN_FIELDS)


def count_hidden(paths) -> int:
    """The number of hidden layers among leaf ``paths``."""
    return sum(1 for k in paths
               if k.startswith("hidden.") and k.endswith(".u"))


@dataclasses.dataclass
class HiddenLayerParams:
    """One hidden layer of a deep transition (``model/deep.py``): whitened
    inducing outputs u (M, D), inducing inputs z (M, D + U) and per-dim
    kernel hyperparameters, the head layer's shapes."""

    u: torch.Tensor
    z: torch.Tensor
    kernel: KernelParams


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
    # Hidden layers of the deep transition, outermost first; () is the
    # single-layer model.  The head GP (x/u/z/kernel) is always the last.
    hidden: Tuple[HiddenLayerParams, ...] = ()

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
        """The leaf tensors keyed by field path: ``LEAF_PATHS``, then
        ``hidden_paths``."""
        out = {"x": self.x, "u": self.u, "z": self.z,
               "kernel.log_variance": self.kernel.log_variance,
               "kernel.log_lengthscales": self.kernel.log_lengthscales,
               "log_q": self.log_q, "c": self.c, "d": self.d,
               "log_rchol": self.log_rchol}
        for i, layer in enumerate(self.hidden):
            out.update(zip((f"hidden.{i}.{f}" for f in HIDDEN_FIELDS),
                           (layer.u, layer.z, layer.kernel.log_variance,
                            layer.kernel.log_lengthscales)))
        return out

    @classmethod
    def from_leaves(cls, leaves: Dict[str, torch.Tensor]) -> "GPSSMParams":
        hidden = tuple(
            HiddenLayerParams(u=u, z=z, kernel=KernelParams(lv, ls))
            for u, z, lv, ls in ([leaves[f"hidden.{i}.{f}"]
                                  for f in HIDDEN_FIELDS]
                                 for i in range(count_hidden(leaves))))
        return cls(x=leaves["x"], u=leaves["u"], z=leaves["z"],
                   kernel=KernelParams(
                       log_variance=leaves["kernel.log_variance"],
                       log_lengthscales=leaves["kernel.log_lengthscales"]),
                   log_q=leaves["log_q"], c=leaves["c"], d=leaves["d"],
                   log_rchol=leaves["log_rchol"], hidden=hidden)


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
    """Build params from numpy leaves keyed by field path (``LEAF_PATHS``,
    and ``hidden_paths`` for a deep model)."""
    paths = LEAF_PATHS + hidden_paths(count_hidden(tree))
    missing = [k for k in paths if k not in tree]
    if missing:
        raise KeyError(f"params tree missing leaves {missing}")
    return GPSSMParams.from_leaves({
        k: torch.tensor(np.asarray(tree[k]), dtype=dtype, device=device)
        for k in paths})


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


def adapt_warmstart_xdim(params: GPSSMParams, x_dim: int,
                         control_dim: int = 1, seed: int = 0) -> GPSSMParams:
    """Adapt a warm start (always D=4) to another latent dimension, as
    ``ffvd_tpu/model/params.py::adapt_warmstart_xdim`` does, drawing from
    the same ``np.random.RandomState(seed)`` in the same order.

    Shrink: keep the leading x_dim latent dims everywhere (and the matching
    Z / lengthscale columns).  Grow: append zero latent states and inducing
    outputs, near-zero emission rows, mean kernel hyperparameters, Z
    columns drawn from N(0, 1); the GP-input layout becomes [old latent |
    new latent | control]."""
    d0 = params.x_dim
    if x_dim == d0:
        return params
    if params.hidden:
        raise ValueError("adapt the latent dimension before attaching deep "
                         "hidden layers (their u/z/kernel shapes are tied "
                         "to x_dim)")
    rng = np.random.RandomState(seed)
    dt, dev = params.x.dtype, params.x.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    full = lambda shape, v: torch.full(shape, float(v), dtype=dt, device=dev)
    if x_dim < d0:
        keep = torch.arange(x_dim, device=dev)
        cols = torch.cat([keep, torch.arange(d0, d0 + control_dim,
                                             device=dev)])
        return GPSSMParams(
            x=params.x[:, keep], u=params.u[:, keep], z=params.z[:, cols],
            kernel=KernelParams(
                log_variance=params.kernel.log_variance[keep],
                log_lengthscales=params.kernel.log_lengthscales[keep][:,
                                                                      cols]),
            log_q=params.log_q[keep], c=params.c[keep, :], d=params.d,
            log_rchol=params.log_rchol)
    extra = x_dim - d0
    m, n1 = params.z.shape[0], params.x.shape[0]
    z_new_cols = as_t(rng.randn(m, extra))
    z = torch.cat([params.z[:, :d0], z_new_cols, params.z[:, d0:]], dim=1)
    ls = params.kernel.log_lengthscales
    ls_mean = torch.mean(ls)
    ls_old = torch.cat([ls[:, :d0], ls_mean.expand(d0, extra), ls[:, d0:]],
                       dim=1)
    ls_new = ls_mean.expand(extra, x_dim + control_dim)
    lv = params.kernel.log_variance
    return GPSSMParams(
        x=torch.cat([params.x, full((n1, extra), 0.0)], dim=1),
        u=torch.cat([params.u, full((m, extra), 0.0)], dim=1),
        z=z,
        kernel=KernelParams(
            log_variance=torch.cat([lv, torch.mean(lv).expand(extra)]),
            log_lengthscales=torch.cat([ls_old, ls_new], dim=0)),
        log_q=torch.cat([params.log_q, full((extra,), np.log(0.1))]),
        c=torch.cat([params.c, 1e-3 * as_t(rng.randn(extra,
                                                     params.c.shape[1]))],
                    dim=0),
        d=params.d, log_rchol=params.log_rchol)


def init_hidden_layers(n_hidden: int, head: GPSSMParams,
                       var_scale: float = 1.0,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[HiddenLayerParams, ...]:
    """``n_hidden`` near-identity deep-transition layers from a head layer
    (``ffvd_tpu/model/params.py::init_hidden_layers``): u = 0, so each
    layer's conditional mean is zero and the deep transition starts as the
    shallow one; z = the head's Z plus N(0, 0.01²) jitter drawn from
    ``generator`` (on its device); the head's kernel hyperparameters, the
    signal variance multiplied by ``var_scale``."""
    z0 = head.z
    layers = []
    for _ in range(n_hidden):
        jig = torch.randn(tuple(z0.shape), generator=generator,
                          dtype=z0.dtype,
                          device=generator.device if generator is not None
                          else "cpu").to(z0.device)
        layers.append(HiddenLayerParams(
            u=torch.zeros_like(head.u), z=z0 + 0.01 * jig,
            kernel=KernelParams(
                log_variance=head.kernel.log_variance + float(
                    np.log(var_scale)),
                log_lengthscales=head.kernel.log_lengthscales.clone())))
    return tuple(layers)


def init_params_random(n: int, x_dim: int, m: int, control_dim: int,
                       p: int = 1,
                       generator: Optional[torch.Generator] = None,
                       device="cpu", dtype=torch.float64) -> GPSSMParams:
    """Cold start for data without a warm start
    (``ffvd_tpu/model/params.py::init_params_random``): x ~ 0.1·N(0, 1),
    u = 0, z ~ N(0, 1), log-variance and log Q at log 0.1, unit
    lengthscales and emission, emission noise std √0.1."""
    din = x_dim + control_dim
    gdev = generator.device if generator is not None else "cpu"
    normal = lambda *shape: torch.randn(shape, generator=generator,
                                        dtype=dtype, device=gdev).to(device)
    full = lambda shape, v: torch.full(shape, float(v), dtype=dtype,
                                       device=device)
    return GPSSMParams(
        x=0.1 * normal(n + 1, x_dim),
        u=full((m, x_dim), 0.0),
        z=normal(m, din),
        kernel=KernelParams(log_variance=full((x_dim,), np.log(0.1)),
                            log_lengthscales=full((x_dim, din), 0.0)),
        log_q=full((x_dim,), np.log(0.1)),
        c=full((x_dim, p), 1.0),
        d=full((p,), 0.0),
        log_rchol=torch.eye(p, dtype=dtype, device=device)
        * (0.5 * np.log(0.1)))
