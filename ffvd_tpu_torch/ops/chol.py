"""Batched Cholesky / triangular-solve helpers with PSD-jitter escalation.

Counterpart of ``ffvd_tpu/ops/chol.py``.  ``torch.linalg.cholesky`` raises on
a non-PD block where JAX's returns NaN, so the factorisation here is
``torch.linalg.cholesky_ex``: a batch element is "bad" when its ``info`` is
non-zero or its factor is non-finite.  The matrix and its two escalated
retries are factorised together, in one ``cholesky_ex`` on the stacked
batch, and each element takes its first good factor (``torch.where``): the
per-element semantics of JAX's ``where`` with no branch, so nothing is read
back to the host and the factorisation can be captured in a CUDA graph.
The cost is two extra factorisations in the same launch.  Under
``torch.func.vmap`` (the chain and dataset axes, ``parallel/``) both
factorisations carry a ``vmap`` rule that runs the impl once on the folded
batch.

The JAX package's ``blocked_tri_inv`` works around the TPU's sequential
triangular solve and is never taken at M < 256; here the triangular inverse
is one ``torch.linalg.solve_triangular``.
"""

from __future__ import annotations

import torch


def _phi(x: torch.Tensor) -> torch.Tensor:
    """tril with halved diagonal — the Φ of the Cholesky differential
    (Murray 2016, arXiv:1602.07527)."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return torch.tril(x) / (1.0 + eye)


def _per_bad(l: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Per batch element: did the factorisation fail?"""
    return (info != 0) | ~torch.isfinite(l).all(dim=-1).all(dim=-1)


def _psd_cholesky_impl(mat: torch.Tensor, retry_jitter: float) -> torch.Tensor:
    """Factorise with two escalated-jitter retries, per batch element:
    first the reference's ABSOLUTE 1e-4 jitter (conditionals_multi_output.py:
    30), then 1e-4·max(mean diag, 1), which restores positive definiteness
    at any diagonal scale.  All three attempts are one ``cholesky_ex`` of the
    stacked batch; the first good one wins, and an element that fails all
    three comes back NaN below the diagonal, as a failed JAX Cholesky
    does."""
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    diag_scale = torch.diagonal(mat, dim1=-2, dim2=-1).mean(dim=-1)
    rel = 1e-4 * torch.clamp(diag_scale, min=1.0)
    tries, info = torch.linalg.cholesky_ex(torch.stack(
        [mat, mat + retry_jitter * eye, mat + rel[..., None, None] * eye]))
    bad = _per_bad(tries, info)[..., None, None]
    failed = torch.full_like(tries[2], torch.nan).tril()   # as JAX's
    l = torch.where(bad[2], failed, tries[2])
    l = torch.where(bad[1], l, tries[1])
    return torch.where(bad[0], l, tries[0])


def _tri_inv(l: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye.expand(l.shape), upper=False)


def _mapped_first(mat: torch.Tensor, dim):
    """(``mat`` with the vmapped dim first, the outputs' mapped dim): one
    call of the batch-polymorphic impl then covers every mapped element."""
    return (mat, None) if dim is None else (mat.movedim(dim, 0), 0)


class _PSDCholesky(torch.autograd.Function):
    """Forward: jitter-escalating factorisation.  Backward: the standard
    Cholesky pullback Σ̄ = L⁻ᵀ Φ(Lᵀ L̄) L⁻¹ from the saved factor, so no NaN
    of a failed first attempt can reach a gradient.  Under
    ``torch.func.vmap`` the rule ``vmap`` folds the mapped dim into the
    batch and factorises once for every mapped element
    (``ffvd_tpu/ops/chol.py::_psd_cholesky_batchsafe``)."""

    @staticmethod
    def forward(mat, retry_jitter):
        return _psd_cholesky_impl(mat, retry_jitter)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, lbar):
        (l,) = ctx.saved_tensors
        p = _phi(l.mT @ lbar)
        lt = l.mT
        tmp = torch.linalg.solve_triangular(lt, p, upper=True)       # L⁻ᵀ P
        sigma_bar = torch.linalg.solve_triangular(
            lt, tmp.mT, upper=True).mT                                 # ·L⁻¹
        return 0.5 * (sigma_bar + sigma_bar.mT), None

    @staticmethod
    def vmap(info, in_dims, mat, retry_jitter):
        mat, out = _mapped_first(mat, in_dims[0])
        return _PSDCholesky.apply(mat, retry_jitter), out


def psd_cholesky(mat: torch.Tensor, retry_jitter: float = 1e-4) -> torch.Tensor:
    """Cholesky of a batch of PSD matrices ``(..., M, M)`` with escalated
    jitter retries."""
    return _PSDCholesky.apply(mat, retry_jitter)


class _CholAndInv(torch.autograd.Function):
    """(L, L⁻¹) with a backward made only of matmuls:

        d(L⁻¹) = −L⁻¹ dL L⁻¹         ⇒  L̄_eff = L̄ − L⁻ᵀ (L⁻¹)‾ L⁻ᵀ
        Σ̄ = L⁻ᵀ Φ(Lᵀ L̄_eff) L⁻¹      (with the saved explicit L⁻¹)

    Φ(LᵀX) reads only tril(X), so upper-triangle cotangent junk is ignored.
    Under ``torch.func.vmap`` it factorises the folded batch once, as
    ``_PSDCholesky`` does.
    """

    @staticmethod
    def forward(mat, retry_jitter):
        l = _psd_cholesky_impl(mat, retry_jitter)
        return l, _tri_inv(l)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*output)

    @staticmethod
    def backward(ctx, lbar, linvbar):
        l, l_inv = ctx.saved_tensors
        l_invT = l_inv.mT
        lbar_eff = lbar - l_invT @ linvbar @ l_invT
        p = _phi(l.mT @ lbar_eff)
        sigma_bar = l_invT @ p @ l_inv
        return 0.5 * (sigma_bar + sigma_bar.mT), None

    @staticmethod
    def vmap(info, in_dims, mat, retry_jitter):
        mat, out = _mapped_first(mat, in_dims[0])
        return _CholAndInv.apply(mat, retry_jitter), (out, out)


def chol_and_inv(mat: torch.Tensor, retry_jitter: float = 1e-4):
    """(L, L⁻¹) of a batch of PSD matrices with jitter-escalating retries."""
    return _CholAndInv.apply(mat, retry_jitter)


def tri_solve(chol: torch.Tensor, rhs: torch.Tensor, *, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Batched triangular solve: op(chol) X = rhs, op = transpose if
    ``trans``.  chol: (..., M, M), rhs: (..., M, K)."""
    if trans:
        return torch.linalg.solve_triangular(chol.mT, rhs, upper=lower)
    return torch.linalg.solve_triangular(chol, rhs, upper=not lower)


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """log|A| from chol(A): 2 Σ log diag(L).  (..., M, M) → (...)."""
    return 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def chol_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A⁻¹ rhs from chol(A) via two triangular solves."""
    y = tri_solve(chol, rhs)
    return tri_solve(chol, y, trans=True)
