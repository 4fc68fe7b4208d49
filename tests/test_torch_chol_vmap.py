"""The port's Cholesky factorisations under ``torch.func.vmap``, the way the
chain and dataset axes (``ffvd_tpu_torch/parallel/``) call them.

``psd_cholesky`` and ``chol_and_inv`` carry a ``vmap`` rule that folds the
mapped dim into the batch and runs the jitter-escalating impl once, the
counterpart of ``ffvd_tpu/ops/chol.py::_psd_cholesky_batchsafe``: one
factorisation and one host read for every mapped element, a retry only
where an element failed.  Held against the unbatched call per element at
rtol 1e-14 (fp64), values and gradients; a spy counts the impl calls.
"""

import warnings

import numpy as np
import pytest
import torch
import torch._C._functorch as functorch

from ffvd_tpu_torch.ops import chol

torch.set_num_threads(2)

C, D, M = 3, 2, 7


def _batch(seed, singular_at=None):
    """(C, D, M, M) SPD matrices; element ``singular_at`` is PSD of rank 3,
    which the first factorisation refuses and the 1e-4 jitter repairs."""
    rng = np.random.RandomState(seed)
    b = rng.randn(C, D, M, M)
    a = b @ np.swapaxes(b, -1, -2) + 0.5 * np.eye(M)
    if singular_at is not None:
        low = rng.randn(M, 3)
        a[singular_at] = low @ low.T
    return torch.tensor(a)


def _weights(seed):
    return torch.tensor(np.random.RandomState(seed).randn(C, D, M, M))


@pytest.fixture
def fallback_raises():
    """functorch's per-element fallback warning, raised as an error."""
    functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="There is a performance drop")
        yield
    functorch._set_vmap_fallback_warning_enabled(False)


def _close(a, b, what):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               rtol=1e-14, atol=1e-14, err_msg=what)


@pytest.mark.parametrize("singular_at", [None, (1, 0)],
                         ids=["healthy", "one-retry"])
def test_psd_cholesky_under_vmap_equals_the_unbatched_call(
        singular_at, fallback_raises):
    a = _batch(0, singular_at).requires_grad_(True)
    w = _weights(1)
    l = torch.func.vmap(chol.psd_cholesky)(a)
    g, = torch.autograd.grad((l * w).sum(), a)
    for i in range(C):
        ai = a[i].detach().requires_grad_(True)
        li = chol.psd_cholesky(ai)
        gi, = torch.autograd.grad((li * w[i]).sum(), ai)
        _close(l[i], li, f"L[{i}]")
        _close(g[i], gi, f"grad[{i}]")
    assert torch.isfinite(l).all()
    if singular_at is not None:
        # the failed element took the first retry, the rest no jitter
        eye = torch.eye(M, dtype=a.dtype)
        _close(l[singular_at], torch.linalg.cholesky(
            a[singular_at].detach() + 1e-4 * eye), "retried element")
        mask = torch.ones(C, D, dtype=torch.bool)
        mask[singular_at] = False
        _close(l[mask], torch.linalg.cholesky(a[mask].detach()),
               "healthy elements")


@pytest.mark.parametrize("singular_at", [None, (2, 1)],
                         ids=["healthy", "one-retry"])
def test_chol_and_inv_under_vmap_equals_the_unbatched_call(
        singular_at, fallback_raises):
    a = _batch(2, singular_at).requires_grad_(True)
    w, v = _weights(3), _weights(4)
    l, l_inv = torch.func.vmap(chol.chol_and_inv)(a)
    g, = torch.autograd.grad((l * w).sum() + (l_inv * v).sum(), a)
    for i in range(C):
        ai = a[i].detach().requires_grad_(True)
        li, li_inv = chol.chol_and_inv(ai)
        gi, = torch.autograd.grad((li * w[i]).sum() + (li_inv * v[i]).sum(),
                                  ai)
        _close(l[i], li, f"L[{i}]")
        _close(l_inv[i], li_inv, f"L^-1[{i}]")
        _close(g[i], gi, f"grad[{i}]")


@pytest.mark.parametrize("fn", ["psd_cholesky", "chol_and_inv"])
def test_one_impl_call_per_vmapped_call(fn, monkeypatch, fallback_raises):
    calls = []
    impl = chol._psd_cholesky_impl

    def spy(mat, retry_jitter):
        calls.append(tuple(mat.shape))
        return impl(mat, retry_jitter)

    monkeypatch.setattr(chol, "_psd_cholesky_impl", spy)
    a = _batch(5, (0, 1)).requires_grad_(True)
    out = torch.func.vmap(getattr(chol, fn))(a)
    out = out if isinstance(out, torch.Tensor) else out[0]
    torch.autograd.grad(out.sum(), a)
    assert calls == [(C, D, M, M)]


def test_vmap_over_an_unmapped_matrix(fallback_raises):
    """A factorisation that does not depend on the mapped input (a shared
    Kmm) stays unbatched inside vmap."""
    a = _batch(6)[0]
    x = torch.arange(1.0, 4.0, dtype=a.dtype)
    out = torch.func.vmap(lambda s: chol.psd_cholesky(a) * s)(x)
    ref = chol.psd_cholesky(a)
    for i in range(3):
        _close(out[i], ref * x[i], f"row {i}")
