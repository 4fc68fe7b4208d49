"""Port parity: Gauss-Hermite quadrature (``ops/quadrature.py``), Gaussian
sampling (``ops/sampling.py``) and the probit-Bernoulli likelihood
(``model/likelihoods.py``) against the JAX package, fp64, inputs from
numpy seeds.

- ``ndiagquad`` in both input forms (arrays; Din-tuples), linear and log
  space, one and several functions; ``mvnquad``; ``ndiag_mc`` with the
  same injected ε: rtol 1e-12 against JAX.
- ``Bernoulli``: against the reference's golden values
  (tests/golden/func_ref_golden.npz) at the tolerances of
  tests/test_multidim_emission.py:149-177, and every method against JAX at
  rtol 1e-12.
- ``get_rand`` by its moments (tests/test_eval_and_data.py:222-235).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.model import likelihoods as jlik
from ffvd_tpu.ops import quadrature as jq

from ffvd_tpu_torch.model.likelihoods import Bernoulli, inv_probit
from ffvd_tpu_torch.ops import quadrature as tq
from ffvd_tpu_torch.ops.sampling import get_rand

torch.set_num_threads(2)

T = torch.tensor
J = jnp.asarray
GOLDEN = Path(__file__).parent / "golden" / "func_ref_golden.npz"


def _close(ours, ref):
    if isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _close(a, b)
        return
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)


def _gauss(seed, shape):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape), 0.1 + rng.rand(*shape), rng.randn(*shape)


@pytest.mark.parametrize("shape", [(7, 1), (7,)])
@pytest.mark.parametrize("logspace", [False, True])
def test_ndiagquad_arrays_match_jax(shape, logspace):
    mu, var, y = _gauss(0, shape)
    fns_t = [lambda f, Y: -0.5 * (f - Y) ** 2, lambda f, Y: torch.sin(f) * Y]
    fns_j = [lambda f, Y: -0.5 * (f - Y) ** 2, lambda f, Y: jnp.sin(f) * Y]
    _close(tq.ndiagquad(fns_t, 20, T(mu), T(var), logspace=logspace, Y=T(y)),
           jq.ndiagquad(fns_j, 20, J(mu), J(var), logspace=logspace, Y=J(y)))
    _close(tq.ndiagquad(fns_t[0], 11, T(mu), T(var), Y=T(y)),
           jq.ndiagquad(fns_j[0], 11, J(mu), J(var), Y=J(y)))


@pytest.mark.parametrize("logspace", [False, True])
def test_ndiagquad_tuples_match_jax(logspace):
    """Din = 2 independent latents on the H² grid (quadrature.py:159-173)."""
    (m1, v1, y), (m2, v2, _) = _gauss(1, (6, 1)), _gauss(2, (6, 1))
    ft = lambda a, b, Y: -(a * b - Y) ** 2
    fj = lambda a, b, Y: -(a * b - Y) ** 2
    ours = tq.ndiagquad(ft, 7, (T(m1), T(m2)), [T(v1), T(v2)],
                        logspace=logspace, Y=T(y))
    ref = jq.ndiagquad(fj, 7, (J(m1), J(m2)), [J(v1), J(v2)],
                       logspace=logspace, Y=J(y))
    assert ours.shape == (6, 1)
    _close(ours, ref)
    with pytest.raises(ValueError):
        tq.ndiagquad(ft, 7, (T(m1), T(m2)), T(v1))


def test_mvnquad_matches_jax():
    rng = np.random.RandomState(3)
    n, din = 5, 2
    means = rng.randn(n, din)
    a = rng.randn(n, din, din)
    covs = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(din)
    ft = lambda x: torch.sum(x ** 2, dim=-1)                # (N, K)
    fj = lambda x: jnp.sum(x ** 2, axis=-1)
    _close(tq.mvnquad(ft, T(means), T(covs), 8, din),
           jq.mvnquad(fj, J(means), J(covs), 8, din))
    gt = lambda x: torch.stack([x[..., 0], x[..., 0] * x[..., 1]], -1)
    gj = lambda x: jnp.stack([x[..., 0], x[..., 0] * x[..., 1]], -1)
    ours = tq.mvnquad(gt, T(means), T(covs), 8, din)
    assert ours.shape == (n, 2)
    _close(ours, jq.mvnquad(gj, J(means), J(covs), 8, din))
    # E[x x'] = μ μ' + Σ: the quadrature is exact for this polynomial
    np.testing.assert_allclose(ours[:, 1].numpy(),
                               means[:, 0] * means[:, 1] + covs[:, 0, 1],
                               rtol=1e-10)


@pytest.mark.parametrize("logspace", [False, True])
def test_ndiag_mc_matches_jax_with_injected_epsilon(logspace):
    mu, var, y = _gauss(4, (5, 3))
    eps = np.random.RandomState(5).randn(64, 5, 3)
    fns_t = [lambda f, Y: -(f - Y) ** 2, lambda f, Y: torch.cos(f)]
    fns_j = [lambda f, Y: -(f - Y) ** 2, lambda f, Y: jnp.cos(f)]
    ours = tq.ndiag_mc(fns_t, 64, T(mu), T(var), logspace=logspace,
                       epsilon=T(eps), Y=T(y))
    ref = jq.ndiag_mc(fns_j, 64, J(mu), J(var), jax.random.key(0),
                      logspace=logspace, epsilon=J(eps), Y=J(y))
    _close(ours, ref)
    drawn = tq.ndiag_mc(lambda f: torch.cos(f), 64, T(mu), T(var),
                        generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (5, 3) and bool(torch.isfinite(drawn).all())


def test_hermgauss_copies_match_jax():
    for h, dim in ((5, 1), (4, 3)):
        for a, b in zip(tq.mvhermgauss(h, dim), jq.mvhermgauss(h, dim)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tq.hermgauss(9), jq.hermgauss(9)):
        np.testing.assert_array_equal(a, b)


def test_bernoulli_matches_reference_golden():
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    b = Bernoulli()
    fmu, fvar, y = T(g["bern_fmu"]), T(g["bern_fvar"]), T(g["bern_y"])
    np.testing.assert_allclose(
        b.variational_expectations(fmu, fvar, y).numpy(), g["bern_ve"],
        rtol=1e-5, atol=1e-7)
    pm, pv = b.predict_mean_and_var(fmu, fvar)
    np.testing.assert_allclose(pm.numpy(), g["bern_pmean"], rtol=1e-10)
    np.testing.assert_allclose(pv.numpy(), g["bern_pvar"], rtol=1e-10)
    np.testing.assert_allclose(b.predict_density(fmu, fvar, y).numpy(),
                               g["bern_pdens"], rtol=1e-10)


def test_bernoulli_matches_jax():
    rng = np.random.RandomState(6)
    f = 2.0 * rng.randn(8, 2)
    fvar = 0.05 + rng.rand(8, 2)
    y = (rng.rand(8, 2) > 0.5).astype(np.float64)
    b, jb = Bernoulli(num_gauss_hermite_points=15), jlik.Bernoulli(15)
    _close(inv_probit(T(f)), jlik.inv_probit(J(f)))
    _close(b.logp(T(f), T(y)), jb.logp(J(f), J(y)))
    _close(b.conditional_mean(T(f)), jb.conditional_mean(J(f)))
    _close(b.conditional_variance(T(f)), jb.conditional_variance(J(f)))
    _close(b.predict_mean_and_var(T(f), T(fvar)),
           jb.predict_mean_and_var(J(f), J(fvar)))
    _close(b.predict_density(T(f), T(fvar), T(y)),
           jb.predict_density(J(f), J(fvar), J(y)))
    _close(b.variational_expectations(T(f), T(fvar), T(y)),
           jb.variational_expectations(J(f), J(fvar), J(y)))


def test_get_rand_moments():
    g = torch.Generator().manual_seed(0)
    mean = torch.zeros((2000, 2), dtype=torch.float64)
    var = torch.tensor(np.tile([[0.25, 4.0]], (2000, 1)))
    s = get_rand(g, mean, var)
    np.testing.assert_allclose(s.std(dim=0).numpy(), [0.5, 2.0], rtol=0.05)
    # full covariance path: (D, N, N), the reference's 1e-7 jitter
    cov = torch.tensor(np.stack([np.eye(50) * 0.25, np.eye(50) * 4.0]))
    draws = torch.stack([get_rand(g, torch.zeros((50, 2), dtype=torch.float64),
                                  cov, full_cov=True) for _ in range(40)])
    assert draws.shape == (40, 50, 2) and bool(torch.isfinite(draws).all())
    np.testing.assert_allclose(draws.reshape(-1, 2).std(dim=0).numpy(),
                               [0.5, 2.0], rtol=0.05)
