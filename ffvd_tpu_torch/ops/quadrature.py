"""Gauss-Hermite quadrature for Gaussian expectations.

Counterpart of ``ffvd_tpu/ops/quadrature.py`` (the rebuild of the
reference's ``quadrature.py``, a GPflow copy, without its broken
``collections.Iterable`` import and forced float32 cast): dtype and device
follow the inputs.  ``hermgauss`` and ``mvhermgauss`` are numpy, copied.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch


def hermgauss(n: int, dtype=np.float64):
    """Nodes/weights of n-point Gauss-Hermite quadrature (quadrature.py:22-25)."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return x.astype(dtype), w.astype(dtype)


def mvhermgauss(h: int, dim: int, dtype=np.float64):
    """Multivariate GH grid: H^dim points over dim dimensions
    (quadrature.py:28-43)."""
    gh_x, gh_w = hermgauss(h, dtype)
    x = np.array(list(itertools.product(*(gh_x,) * dim)))
    w = np.prod(np.array(list(itertools.product(*(gh_w,) * dim))), axis=1)
    return x, w


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def mvnquad(func: Callable, means: torch.Tensor, covs: torch.Tensor, h: int,
            din: int) -> torch.Tensor:
    """Multivariate Gaussian expectation by the full Gauss-Hermite grid
    (quadrature.py:46-89).  means (N, Din), covs (N, Din, Din)."""
    xn, wn = mvhermgauss(h, din)
    chols = torch.linalg.cholesky(covs)                     # (N, Din, Din)
    # X[n, k, :] = mean_n + sqrt(2) L_n x_k
    pts = means[:, None, :] + math.sqrt(2.0) * torch.einsum(
        "nij,kj->nki", chols, _like(xn, means))
    fx = func(pts)                                          # (N, K, ...)
    w = _like(wn, means) * (math.pi ** (-0.5 * din))
    return torch.tensordot(fx, w, dims=([1], [0])) if fx.dim() > 2 else fx @ w


def ndiag_mc(funcs: Union[Callable, Sequence[Callable]], s: int, fmu, fvar,
             generator: Optional[torch.Generator] = None,
             logspace: bool = False, epsilon=None, **ys):
    """Monte-Carlo counterpart of ``ndiagquad`` (quadrature.py:198-241):
    S-sample Gaussian expectation over diagonal N(fmu, fvar).  ``epsilon``
    (S, *fmu.shape) replaces the normals drawn from ``generator``."""
    single = callable(funcs)
    fns = [funcs] if single else list(funcs)
    fmu = torch.as_tensor(fmu)
    fvar = torch.as_tensor(fvar)
    if epsilon is None:
        epsilon = torch.randn((s,) + tuple(fmu.shape), generator=generator,
                              dtype=fmu.dtype, device=fmu.device)
    xn = fmu[None] + torch.sqrt(torch.clamp(fvar, min=0.0))[None] * epsilon
    ys_b = {k: torch.as_tensor(v)[None] for k, v in ys.items()}
    results = []
    for fn in fns:
        fx = fn(xn, **ys_b)
        if logspace:
            res = torch.logsumexp(fx, dim=0) - math.log(float(s))
        else:
            res = torch.mean(fx, dim=0)
        results.append(res)
    return results[0] if single else results


def ndiagquad(funcs: Union[Callable, Sequence[Callable]], h: int,
              fmu, fvar, logspace: bool = False, **ys):
    """Expectation of f(F) under diagonal Gaussians N(fmu, fvar) by H-point
    Gauss-Hermite (quadrature.py:92-195), in the reference's two input
    forms:

    - tensors ``fmu``/``fvar`` of one shape, (N, 1) or (N,): each func gets
      one positional argument with a trailing quadrature axis of length H;
    - Din-tuples/lists of such tensors (quadrature.py:159-173): Din
      independent latents on the full H**Din grid; each func gets Din
      positional arguments of shape (N, H**Din) and the result has the
      shape of ``fmu[0]``.

    ``ys`` are extra broadcastable arguments passed to each func by keyword.
    """
    single = callable(funcs)
    fns = [funcs] if single else list(funcs)
    if isinstance(fmu, (tuple, list)):
        if not isinstance(fvar, (tuple, list)) or len(fvar) != len(fmu):
            raise ValueError("Fmu and Fvar must be tuples of the same length")
        din = len(fmu)
        first = torch.as_tensor(fmu[0])
        mus = [_like(f, first).reshape(-1) for f in fmu]
        vrs = [_like(f, first).reshape(-1) for f in fvar]
        xn, wn = mvhermgauss(h, din)                 # (H**Din, Din), (H**Din,)
        gh_w = _like(wn * np.pi ** (-0.5 * din), first)
        # Xs[i][n, k] = mu_i[n] + sqrt(2 var_i[n]) x_k[i]  (quadrature.py:172-173)
        xs = [m[:, None] + torch.sqrt(2.0 * torch.clamp(v, min=0.0))[:, None]
              * _like(xn[:, i], first)
              for i, (m, v) in enumerate(zip(mus, vrs))]
        ys_b = {k: torch.as_tensor(v).reshape(-1, 1) for k, v in ys.items()}
        results = []
        for fn in fns:
            fx = fn(*xs, **ys_b)                     # (N, H**Din)
            if logspace:
                res = torch.logsumexp(fx + torch.log(gh_w), dim=-1)
            else:
                res = fx @ gh_w
            results.append(res.reshape(first.shape))
        return results[0] if single else results
    fmu = torch.as_tensor(fmu)
    fvar = torch.as_tensor(fvar)
    gh_x, gh_w = hermgauss(h, np.float64)
    gh_x = _like(gh_x, fmu)
    gh_w = _like(gh_w / np.sqrt(np.pi), fmu)
    # X[..., k] = fmu + sqrt(2 fvar) x_k
    xn = fmu[..., None] + torch.sqrt(
        2.0 * torch.clamp(fvar, min=0.0)[..., None]) * gh_x
    ys_b = {k: torch.as_tensor(v)[..., None] for k, v in ys.items()}
    results = []
    for fn in fns:
        fx = fn(xn, **ys_b)
        if logspace:
            res = torch.logsumexp(fx + torch.log(gh_w), dim=-1)
        else:
            res = torch.sum(fx * gh_w, dim=-1)
        results.append(res)
    return results[0] if single else results
