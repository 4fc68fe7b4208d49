"""Port parity (b): kernels, densities and the Cholesky helpers against the
JAX package, in fp64 on small random inputs made with numpy.

Tolerances: the kernels and densities do the same arithmetic in another
library, so they agree to rounding (rtol 1e-12).  The factorisations go
through LAPACK in both, in possibly different blockings: forward rtol 1e-10,
backward rtol 1e-8 (the backward multiplies by two explicit inverses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.ops import chol as jchol
from ffvd_tpu.ops import densities as jdens
from ffvd_tpu.ops import kernels as jk

from ffvd_tpu_torch.ops import chol as tchol
from ffvd_tpu_torch.ops import densities as tdens
from ffvd_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

RNG_SEED = 20


def _kp(rng, d, din):
    lv = np.log(rng.rand(d) + 0.3)
    ls = np.log(rng.rand(d, din) + 0.5)
    return (jk.KernelParams(jnp.asarray(lv), jnp.asarray(ls)),
            tk.KernelParams(torch.as_tensor(lv), torch.as_tensor(ls)))


def _spd(rng, b, m):
    a = rng.randn(b, m, m)
    return a @ a.transpose(0, 2, 1) / m + 0.5 * np.eye(m)


@pytest.mark.parametrize("kernel_type", ["SquaredExponential", "LinearK"])
@pytest.mark.parametrize("din", [3, 11])      # direct-difference / expansion
def test_kernels_match(kernel_type, din):
    rng = np.random.RandomState(RNG_SEED + din)
    jkp, tkp = _kp(rng, 3, din)
    x, z = rng.randn(7, din), rng.randn(5, din)
    jx, jz = jnp.asarray(x), jnp.asarray(z)
    tx, tz = torch.as_tensor(x), torch.as_tensor(z)
    pairs = [
        (jk.gram(kernel_type, jkp, jx), tk.gram(kernel_type, tkp, tx)),
        (jk.cross(kernel_type, jkp, jx, jz), tk.cross(kernel_type, tkp, tx, tz)),
        (jk.diag(kernel_type, jkp, jx), tk.diag(kernel_type, tkp, tx)),
    ]
    if kernel_type == "LinearK":    # SE lengthscales span all Din columns
        pairs.append((jk.cross(kernel_type, jkp, jx, jz, active_dims=[0, 2]),
                      tk.cross(kernel_type, tkp, tx, tz, active_dims=[0, 2])))
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-14)


def test_densities_match():
    rng = np.random.RandomState(RNG_SEED)
    y, mu = rng.randn(6, 3), rng.randn(6, 3)
    sd = rng.rand(3) + 0.2
    low = np.tril(rng.randn(3, 3), -1) + np.diag(rng.rand(3) + 0.5)
    ty, tmu, tsd, tl = map(torch.as_tensor, (y, mu, sd, low))
    np.testing.assert_allclose(
        tdens.logdensity_norm_diag_nonvec(ty, tmu, tsd).numpy(),
        np.asarray(jdens.logdensity_norm_diag_nonvec(y, mu, sd)), rtol=1e-12)
    np.testing.assert_allclose(
        tdens.logdensity_norm_diag(ty, tmu, tsd).numpy(),
        np.asarray(jdens.logdensity_norm_diag(y, mu, sd)), rtol=1e-12)
    np.testing.assert_allclose(
        tdens.logdensity_norm(ty, tmu, tl).numpy(),
        np.asarray(jax.jit(jdens.logdensity_norm)(y, mu, low)), rtol=1e-12)


@pytest.mark.parametrize("batch,m", [(4, 10), (2, 33)])
def test_chol_and_inv_forward_backward_match(batch, m):
    rng = np.random.RandomState(RNG_SEED + m)
    a = _spd(rng, batch, m)
    gl, gli = rng.randn(batch, m, m), rng.randn(batch, m, m)

    def jfwd(mat):
        return jchol.chol_and_inv(mat)
    (jl, jli), vjp = jax.vjp(jax.jit(jfwd), jnp.asarray(a))
    (jbar,) = vjp((jnp.asarray(gl), jnp.asarray(gli)))

    ta = torch.as_tensor(a).requires_grad_(True)
    tl, tli = tchol.chol_and_inv(ta)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(tli.detach().numpy(), np.asarray(jli),
                               rtol=1e-10, atol=1e-13)
    (tbar,) = torch.autograd.grad((tl, tli), ta,
                                  (torch.as_tensor(gl), torch.as_tensor(gli)))
    np.testing.assert_allclose(tbar.numpy(), np.asarray(jbar), rtol=1e-8,
                               atol=1e-11)


def test_psd_cholesky_backward_matches():
    rng = np.random.RandomState(RNG_SEED)
    a = _spd(rng, 3, 8)
    g = rng.randn(3, 8, 8)
    jl, vjp = jax.vjp(jax.jit(jchol.psd_cholesky), jnp.asarray(a))
    (jbar,) = vjp(jnp.asarray(g))
    ta = torch.as_tensor(a).requires_grad_(True)
    tl = tchol.psd_cholesky(ta)
    (tbar,) = torch.autograd.grad(tl, ta, torch.as_tensor(g))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(tbar.numpy(), np.asarray(jbar), rtol=1e-8,
                               atol=1e-11)


def test_chol_and_inv_gradcheck():
    """torch.autograd.gradcheck through a symmetric parameterisation (the
    factorisation reads one triangle, the backward returns the symmetrised
    cotangent, as jnp.linalg.cholesky's rule does)."""
    rng = np.random.RandomState(RNG_SEED)
    x = torch.as_tensor(rng.randn(2, 5, 5)).requires_grad_(True)
    eye = torch.eye(5, dtype=torch.float64)

    def f(x):
        l, li = tchol.chol_and_inv(x @ x.mT + eye)
        return l, li
    assert torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda x: tchol.psd_cholesky(x @ x.mT + eye), (x,), eps=1e-6,
        atol=1e-6)


def test_rank_deficient_block_takes_retry_without_nan():
    """A rank-1 block fails the plain factorisation (cholesky_ex info != 0);
    the 1e-4 retry repairs it, matching JAX's retry, and no NaN reaches the
    gradient.  The healthy block keeps its plain factor."""
    rng = np.random.RandomState(RNG_SEED)
    v = rng.randn(6, 1)
    a = np.stack([_spd(rng, 1, 6)[0], v @ v.T])
    _, info = torch.linalg.cholesky_ex(torch.as_tensor(a))
    assert int(info[0]) == 0 and int(info[1]) != 0   # takes the retry path
    ta = torch.as_tensor(a).requires_grad_(True)
    l, li = tchol.chol_and_inv(ta)
    jl, jli = jax.jit(jchol.chol_and_inv)(jnp.asarray(a))
    np.testing.assert_allclose(l.detach().numpy(), np.asarray(jl),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        l[1].detach().numpy(),
        np.linalg.cholesky(a[1] + 1e-4 * np.eye(6)), rtol=1e-10)
    np.testing.assert_allclose(
        l[0].detach().numpy(), np.linalg.cholesky(a[0]), rtol=1e-12)
    loss = (li ** 2).sum() + l.sum()
    (g,) = torch.autograd.grad(loss, ta)
    assert torch.isfinite(g).all()


def test_relative_jitter_second_stage():
    """A block too large for the absolute 1e-4 jitter takes the relative
    1e-4·mean(diag) stage, in both packages; one that fails every stage
    comes back NaN, like JAX's."""
    rng = np.random.RandomState(RNG_SEED)
    v = rng.randn(5, 2) * 1e8
    big = v @ v.T                                   # rank 2, diag ~1e16
    np_bad = -np.eye(5)                             # not PSD at any jitter
    a = np.stack([big, np_bad])
    l = tchol.psd_cholesky(torch.as_tensor(a))
    jl = np.asarray(jax.jit(jchol.psd_cholesky)(jnp.asarray(a)))
    assert torch.isfinite(l[0]).all()
    low = np.tril_indices(5)
    assert torch.isnan(l[1][low]).all() and np.isnan(jl[1][low]).all()
    np.testing.assert_allclose(l[0].numpy(), jl[0], rtol=1e-9)


def test_triangular_helpers():
    rng = np.random.RandomState(RNG_SEED)
    a = _spd(rng, 2, 6)
    rhs = rng.randn(2, 6, 3)
    l = torch.linalg.cholesky(torch.as_tensor(a))
    trhs = torch.as_tensor(rhs)
    jl = jnp.asarray(l.numpy())
    np.testing.assert_allclose(tchol.chol_solve(l, trhs).numpy(),
                               np.linalg.solve(a, rhs), rtol=1e-10)
    np.testing.assert_allclose(
        tchol.tri_solve(l, trhs, trans=True).numpy(),
        np.asarray(jax.jit(lambda c, r: jchol.tri_solve(c, r, trans=True))(
            jl, jnp.asarray(rhs))), rtol=1e-10)
    np.testing.assert_allclose(tchol.chol_logdet(l).numpy(),
                               np.linalg.slogdet(a)[1], rtol=1e-12)
