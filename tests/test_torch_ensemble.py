"""Port parity: ensemble pooling (``eval/ensemble.py``) against the JAX
package, fp64 on the CPU.

- ``pool_moments`` (with and without the spread term) and ``_metrics`` on
  random chains from a numpy seed: rtol 1e-12 against JAX's.
- ``ensemble_evaluate``: each chain's metrics equal that model's
  ``evaluate()`` given the same injected rollout noise (rtol 1e-12), and
  the pooled moments equal JAX's ``pool_moments`` of the port's chains.
- ``fit_ensemble`` on C4: with ``init_jitter=0`` the chains are bit for bit
  identical (full-batch Adam is deterministic; JAX pins the same,
  ``ffvd_tpu/eval/ensemble.py:160-163``); with a jitter chain 0 keeps the
  exact warm start and chain 1 starts from the warm start plus
  jitter·N(0, 1) drawn from a generator seeded with ``seed ^ 0x5EED``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ffvd_tpu.eval import ensemble as jens

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.eval import ensemble as ens
from ffvd_tpu_torch.model.elbo import negative_elbo
from ffvd_tpu_torch.model.params import GPSSMParams

torch.set_num_threads(2)

CFG = FFVDConfig(dataset="ballbeam", case=4, num_posterior_samples=3)


def _chains(seed, c=3, s=4, t=40, p=2):
    rng = np.random.RandomState(seed)
    return [(rng.randn(s, t, p), 0.1 + rng.rand(s, t, p), 0.01 + rng.rand(p))
            for _ in range(c)]


@pytest.mark.parametrize("spread", [True, False])
def test_pool_moments_and_metrics_match_jax(spread):
    chains = _chains(0)
    py, pv = ens.pool_moments(chains, include_spread=spread)
    jpy, jpv = jens.pool_moments(chains, include_spread=spread)
    np.testing.assert_allclose(py, jpy, rtol=1e-12)
    np.testing.assert_allclose(pv, jpv, rtol=1e-12)
    y = np.random.RandomState(1).randn(40, 2)
    np.testing.assert_allclose(ens._metrics(py, pv, y, 2.5, 30),
                               jens._metrics(jpy, jpv, y, 2.5, 30),
                               rtol=1e-12)


def test_ensemble_evaluate_per_chain_equals_evaluate():
    models = ens.fit_ensemble(CFG, 2, device="cpu", init_jitter=1e-3,
                              num_iterations=3)
    t_len = models[0].dataset.n_test
    g = torch.Generator().manual_seed(2)
    noise = [torch.randn((3, t_len, 4), generator=g, dtype=torch.float64)
             for _ in models]
    res = ens.ensemble_evaluate(models, noise=noise)
    assert len(res["per_chain"]) == 2
    for m, n, pc in zip(models, noise, res["per_chain"]):
        single = m.evaluate(noise=n)
        np.testing.assert_allclose(pc["rmse"], single["rmse"], rtol=1e-12)
        np.testing.assert_allclose(pc["nll"], single["nll"], rtol=1e-12)
    chains = [ens.chain_moments(m, n) for m, n in zip(models, noise)]
    jpy, jpv = jens.pool_moments(chains)
    np.testing.assert_allclose(res["predict_y"], jpy, rtol=1e-12)
    np.testing.assert_allclose(res["predict_y_var"], jpv, rtol=1e-12)
    assert res["nll_no_spread"] != res["nll"] and np.isfinite(res["rmse"])


def test_fit_ensemble_without_jitter_gives_identical_c4_chains():
    a, b = ens.fit_ensemble(CFG, 2, device="cpu", num_iterations=3)
    assert (a.cfg.seed, b.cfg.seed) == (0, 1)
    assert torch.equal(a.nll_trace, b.nll_trace)
    for k, v in a.params.leaves().items():
        assert torch.equal(v, b.params.leaves()[k]), k


def test_fit_ensemble_jitter_perturbs_chains_after_the_first():
    jitter, seeds = 1e-3, [4, 9]
    c0, c1 = ens.fit_ensemble(CFG, 2, device="cpu", seeds=seeds,
                              init_jitter=jitter, num_iterations=2)
    plain = FFVDModel(dataclasses.replace(CFG, seed=4), device="cpu").fit(2)
    assert torch.equal(c0.nll_trace, plain.nll_trace)
    start = FFVDModel(dataclasses.replace(CFG, seed=9), device="cpu")
    g = torch.Generator().manual_seed(9 ^ 0x5EED)
    with torch.no_grad():
        moved = GPSSMParams.from_leaves({
            k: v + jitter * torch.randn(v.shape, generator=g, dtype=v.dtype)
            for k, v in start.params.leaves().items()})
        first = negative_elbo(moved, start.data)
    assert float(c1.nll_trace[0]) == float(first)
    assert float(c1.nll_trace[0]) != float(c0.nll_trace[0])
