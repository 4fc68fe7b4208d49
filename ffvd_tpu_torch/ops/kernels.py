"""Batched GP kernels, functional style.

Counterpart of ``ffvd_tpu/ops/kernels.py``.  Every kernel op is batched over
the leading latent-dim axis D, producing ``(D, M, M)`` / ``(D, N, M)``
tensors.  Parameterisation matches the reference: log-variance and
log-lengthscales (kernels_multi_output.py:156-161), squared-exponential
``k(x,x') = σ² exp(-r²/2)`` with ARD scaling, and the linear kernel
``k(x,x') = σ² x·x'`` (kernels.py:270-281).  No sqrt/clipping is applied to
the squared distance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class KernelParams:
    """Log-parameterised kernel hyperparameters for D independent GPs.

    log_variance:     (D,)
    log_lengthscales: (D, Din) for SE-ARD; ignored by the linear kernel.
    """

    log_variance: torch.Tensor
    log_lengthscales: torch.Tensor

    @property
    def variance(self) -> torch.Tensor:
        return torch.exp(self.log_variance)

    @property
    def lengthscales(self) -> torch.Tensor:
        return torch.exp(self.log_lengthscales)


# Below this input width, pairwise differences are used instead of the
# norm²−2·dot expansion: exact, with no catastrophic cancellation (all six
# system-id datasets have Din = x_dim + 1 ≤ 7).
_DIRECT_DIST_MAX_DIM = 8


def _scaled_sq_dist(x: torch.Tensor, z: Optional[torch.Tensor],
                    lengthscales: torch.Tensor) -> torch.Tensor:
    """((x - z')/ℓ)² batched over D.

    x: (N, Din), z: (M, Din) or None, lengthscales: (D, Din) → (D, N, M).
    """
    xs = x[None, :, :] / lengthscales[:, None, :]          # (D, N, Din)
    zs = xs if z is None else z[None, :, :] / lengthscales[:, None, :]

    if x.shape[-1] <= _DIRECT_DIST_MAX_DIM:
        diff = xs[:, :, None, :] - zs[:, None, :, :]        # (D, N, M, Din)
        return torch.sum(diff * diff, dim=-1)

    xn = torch.sum(xs * xs, dim=-1)                         # (D, N)
    zn = xn if z is None else torch.sum(zs * zs, dim=-1)    # (D, M)
    dot = torch.einsum("dnk,dmk->dnm", xs, zs)              # (D, N, M)
    return xn[:, :, None] + zn[:, None, :] - 2.0 * dot


def se_gram(params: KernelParams, x: torch.Tensor) -> torch.Tensor:
    """K(X, X) for D SE-ARD kernels → (D, N, N)."""
    r2 = _scaled_sq_dist(x, None, params.lengthscales)
    return params.variance[:, None, None] * torch.exp(-0.5 * r2)


def se_cross(params: KernelParams, x: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """K(X, Z) for D SE-ARD kernels → (D, N, M)."""
    r2 = _scaled_sq_dist(x, z, params.lengthscales)
    return params.variance[:, None, None] * torch.exp(-0.5 * r2)


def se_diag(params: KernelParams, x: torch.Tensor) -> torch.Tensor:
    """diag K(X, X) → (D, N); constant σ² (kernels_multi_output.py:199-200)."""
    return params.variance[:, None].expand(params.variance.shape[0],
                                           x.shape[0])


def linear_gram(params: KernelParams, x: torch.Tensor) -> torch.Tensor:
    """σ²_d · X Xᵀ → (D, N, N) (kernels.py:270-276)."""
    return params.variance[:, None, None] * (x @ x.T)[None, :, :]


def linear_cross(params: KernelParams, x: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    return params.variance[:, None, None] * (x @ z.T)[None, :, :]


def linear_diag(params: KernelParams, x: torch.Tensor) -> torch.Tensor:
    s = torch.sum(x * x, dim=-1)
    return params.variance[:, None] * s[None, :]


_DISPATCH = {
    "SquaredExponential": (se_gram, se_cross, se_diag),
    "LinearK": (linear_gram, linear_cross, linear_diag),
}


def _slice(x: torch.Tensor, active_dims) -> torch.Tensor:
    """Column selection à la Kernel._slice (kernels_multi_output.py:84-106);
    None = all columns."""
    if active_dims is None:
        return x
    return x[..., list(active_dims)]


def gram(kernel_type: str, params: KernelParams, x: torch.Tensor,
         active_dims=None) -> torch.Tensor:
    return _DISPATCH[kernel_type][0](params, _slice(x, active_dims))


def cross(kernel_type: str, params: KernelParams, x: torch.Tensor,
          z: torch.Tensor, active_dims=None) -> torch.Tensor:
    return _DISPATCH[kernel_type][1](params, _slice(x, active_dims),
                                     _slice(z, active_dims))


def diag(kernel_type: str, params: KernelParams, x: torch.Tensor,
         active_dims=None) -> torch.Tensor:
    return _DISPATCH[kernel_type][2](params, _slice(x, active_dims))
