"""The branch-free Cholesky retry of ``ffvd_tpu_torch/ops/chol.py``.

The port factorises a matrix and its two escalated retries (+1e-4·I, then
+1e-4·max(mean diag, 1)·I) in one ``cholesky_ex`` of the stacked batch and
takes each element's first good factor with ``torch.where``, so nothing
is read back to the host.  Held against ``ffvd_tpu.ops.chol.psd_cholesky``
in fp64 at rtol 1e-12, values and gradients, on a batch whose elements
take each attempt: healthy, the absolute retry, the relative retry (a
rank-deficient block on a diagonal of about 1e12, pushed indefinite), and
one that fails all three and comes back NaN (below the diagonal, as
JAX's).  Under ``torch.func.vmap``
too, and under a guard that raises on any host read from the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.ops import chol as jchol

from ffvd_tpu_torch.inference.trainer import TrainState
from ffvd_tpu_torch.model.params import GPSSMParams
from ffvd_tpu_torch.ops import chol
from tests.torch_host_guard import no_host_reads

torch.set_num_threads(2)

M = 6
TOL = dict(rtol=1e-12, atol=1e-12)


def _rotated(rng, eigs):
    q, _ = np.linalg.qr(rng.randn(M, M))
    return (q * np.asarray(eigs)) @ q.T


def _batch(seed):
    """(5, M, M): element 0 and 4 healthy, 1 needs the absolute retry
    (an eigenvalue of −1e-8), 2 the relative one (eigenvalues 1e12 and −1:
    +1e-4 leaves it indefinite), 3 fails all three (−1e3·I)."""
    rng = np.random.RandomState(seed)
    b = rng.randn(M, M)
    healthy = b @ b.T + 0.5 * np.eye(M)
    return np.stack([
        healthy,
        _rotated(rng, [1.0] * (M - 1) + [-1e-8]),
        _rotated(rng, [1e12] * (M - 1) + [-1.0]),
        -1e3 * np.eye(M),
        healthy + np.diag(rng.rand(M)),
    ])


_jax_chol = jax.jit(jchol.psd_cholesky)


def test_each_element_takes_its_attempt():
    a = _batch(0)
    l = chol.psd_cholesky(torch.tensor(a))
    eye = np.eye(M)
    rel = 1e-4 * max(np.mean(np.diag(a[2])), 1.0)
    want = [np.linalg.cholesky(a[0]), np.linalg.cholesky(a[1] + 1e-4 * eye),
            np.linalg.cholesky(a[2] + rel * eye)]
    for i, w in enumerate(want):
        np.testing.assert_allclose(l[i].numpy(), w, **TOL,
                                   err_msg=f"element {i}")
    # the first and the absolute attempts fail where they should
    assert torch.linalg.cholesky_ex(torch.tensor(a[1]))[1] != 0
    assert torch.linalg.cholesky_ex(torch.tensor(a[2] + 1e-4 * eye))[1] != 0
    # all three fail: NaN below the diagonal, zeros above, as in JAX
    low = torch.ones(M, M, dtype=torch.bool).tril()
    assert torch.isnan(l[3][low]).all() and (l[3][~low] == 0).all()


def test_values_match_jax():
    a = _batch(1)
    got = chol.psd_cholesky(torch.tensor(a)).numpy()
    want = np.asarray(_jax_chol(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, **TOL)     # NaN where JAX's is
    assert np.isnan(got[3]).any() and np.isfinite(np.delete(got, 3, 0)).all()


@pytest.mark.parametrize("fn", ["psd_cholesky", "chol_and_inv"])
def test_gradients_match_jax(fn):
    a = np.delete(_batch(2), 3, axis=0)          # every element finite
    w = np.random.RandomState(3).randn(*a.shape)
    v = np.random.RandomState(4).randn(*a.shape)

    def jloss(m):
        l = jchol.psd_cholesky(m)
        out = jnp.sum(l * w)
        if fn == "chol_and_inv":
            eye = jnp.broadcast_to(jnp.eye(M), l.shape)
            l_inv = jax.scipy.linalg.solve_triangular(l, eye, lower=True)
            out = out + jnp.sum(l_inv * v)
        return out

    t = torch.tensor(a, requires_grad=True)
    if fn == "psd_cholesky":
        loss = (chol.psd_cholesky(t) * torch.tensor(w)).sum()
    else:
        l, l_inv = chol.chol_and_inv(t)
        loss = (l * torch.tensor(w)).sum() + (l_inv * torch.tensor(v)).sum()
    g, = torch.autograd.grad(loss, t)
    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(a)))
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12, atol=1e-10)


def test_vmap_matches_jax_vmap():
    a = np.stack([_batch(5), _batch(6)])         # (2, 5, M, M)
    got = torch.func.vmap(chol.psd_cholesky)(torch.tensor(a)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jchol.psd_cholesky))(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, **TOL)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], chol.psd_cholesky(torch.tensor(a[i])).numpy())


def test_reads_nothing_back():
    a = torch.tensor(_batch(7)[[0, 1, 2, 4]], requires_grad=True)
    with no_host_reads():
        l = chol.psd_cholesky(a)
        l2, l_inv = chol.chol_and_inv(a)
        g, = torch.autograd.grad(l.sum() + l_inv.sum(), a)
        under_vmap = torch.func.vmap(chol.psd_cholesky)(a[None])
    assert torch.isfinite(g).all() and torch.equal(l, l2)
    assert torch.equal(under_vmap[0], l)


def test_the_guard_sees_a_read_from_the_port():
    """The guard is live: a state's step count read as an int raises."""
    x = torch.zeros(3, 2)
    state = TrainState(params=GPSSMParams(x=x, u=x, z=x, kernel=None,
                                          log_q=x, c=x, d=x, log_rchol=x),
                       adam=None)
    with no_host_reads(), pytest.raises(AssertionError, match="host read"):
        state.step
    assert state.step == 0
