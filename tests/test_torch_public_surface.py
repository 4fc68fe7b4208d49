"""The port's public surface against the JAX package's.

- every name in the ``__all__`` of ``ffvd_tpu`` and of each of its
  subpackages resolves in the port's matching package, except
  ``enable_compilation_cache`` (the one ``nvcc`` build already persists in
  ``_build/``, so the port has no compilation cache to enable);
- ``__version__`` is JAX's;
- ``conditional`` (a fresh Kmm factorisation, then the whitened
  conditional) and ``whitened_conditional_full_cov`` match JAX's at rtol
  1e-12 in fp64, with and without a q(U) factor, for both kernels; the full
  covariance's diagonal is ``whitened_conditional``'s variance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ffvd_tpu
from ffvd_tpu.model import conditionals as jcond
from ffvd_tpu.ops.kernels import KernelParams as JKP

import ffvd_tpu_torch
from ffvd_tpu_torch.model import conditionals as cond
from ffvd_tpu_torch.ops.kernels import KernelParams

NO_COUNTERPART = {"enable_compilation_cache"}
PACKAGES = ["", ".ops", ".model", ".inference", ".utils", ".eval", ".data",
            ".parallel"]


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_every_exported_name_resolves_in_the_port(sub):
    jax_pkg = importlib.import_module("ffvd_tpu" + sub)
    port = importlib.import_module("ffvd_tpu_torch" + sub)
    names = set(jax_pkg.__all__) - NO_COUNTERPART
    assert names
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing
    assert names <= set(port.__all__)


def test_version_is_jax_packages():
    assert ffvd_tpu_torch.__version__ == ffvd_tpu.__version__


def _inputs(kernel_type, with_q, seed=0, d=3, m=5, n=9, din=5):
    """m ≤ din, so LinearK's Kmm = σ²ZZᵀ has full rank."""
    rng = np.random.RandomState(seed)
    a = dict(lv=np.log(rng.rand(d) + 0.3),
             ll=np.log(rng.rand(d, din) + 0.5),
             z=rng.randn(m, din), u=rng.randn(m, d), x=rng.randn(n, din),
             q=(np.tril(0.3 * rng.randn(d, m, m)) + np.eye(m)) if with_q
             else None)
    t = lambda v: None if v is None else torch.tensor(v)
    j = lambda v: None if v is None else jnp.asarray(v)
    port = (KernelParams(t(a["lv"]), t(a["ll"])), t(a["z"]), t(a["u"]),
            t(a["x"]), t(a["q"]))
    ref = (JKP(j(a["lv"]), j(a["ll"])), j(a["z"]), j(a["u"]), j(a["x"]),
           j(a["q"]))
    return port, ref


CASES = [(k, q) for k in ("SquaredExponential", "LinearK")
         for q in (False, True)]
IDS = [f"{k}-{'qsqrt' if q else 'noq'}" for k, q in CASES]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("kernel_type,with_q", CASES, ids=IDS)
def test_conditional_matches_jax(kernel_type, with_q):
    (kp, z, u, x, q), (jkp, jz, ju, jx, jq) = _inputs(kernel_type, with_q)
    mean, var = cond.conditional(kernel_type, kp, z, u, x, q_sqrt=q)
    jf = jax.jit(lambda *a: jcond.conditional(kernel_type, *a[:4],
                                              q_sqrt=a[4]))
    jmean, jvar = jf(jkp, jz, ju, jx, jq)
    _close(mean, jmean)
    _close(var, jvar)


@pytest.mark.parametrize("kernel_type,with_q", CASES, ids=IDS)
def test_full_cov_matches_jax_and_its_diagonal_is_the_variance(kernel_type,
                                                               with_q):
    (kp, z, u, x, q), (jkp, jz, ju, jx, jq) = _inputs(kernel_type, with_q, 1)
    pre = cond.kernel_precal(kernel_type, kp, z)
    mean, cov = cond.whitened_conditional_full_cov(kernel_type, kp, pre, z,
                                                   u, x, q_sqrt=q)
    def jfull(kp_, z_, u_, x_, q_):
        jpre = jcond.kernel_precal(kernel_type, kp_, z_)
        return jcond.whitened_conditional_full_cov(kernel_type, kp_, jpre,
                                                   z_, u_, x_, q_sqrt=q_)

    jmean, jcov = jax.jit(jfull)(jkp, jz, ju, jx, jq)
    assert cov.shape == (3, 9, 9)
    _close(mean, jmean)
    _close(cov, jcov)
    m2, var = cond.whitened_conditional(kernel_type, kp, pre, z, u, x,
                                        q_sqrt=q)
    _close(torch.diagonal(cov, dim1=-2, dim2=-1).T, var.numpy())
    _close(m2, mean.numpy())
