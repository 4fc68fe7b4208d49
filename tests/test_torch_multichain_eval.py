"""Port parity, multichain posterior moments:
``eval/ensemble.py::multichain_moments`` against the JAX package's, on a
chain-stacked ``MultiChainTrainer`` state (ballbeam, 2 chains, fp64).

The JAX chains train two iterations; their params (and, for C5, sampler
state and window) are carried into the port.  JAX splits the moments key
into one key per chain and runs ``build_collect`` per chain; the test
rebuilds each chain's thinning and rollout normals with JAX's calls (per
sample k: ``k_thin, k_roll = split(k)`` for a thinned chain; the rollout's
``normal(split(k_roll, T)[t], (D,))``) and injects them.  The port thins
both chains on the batched gradient and rolls all C×S rows out in one
``rollout_batched`` call.  Per-chain (y_s, v_s, r2) and the returned chain
agree at rtol 1e-10 (C4) and 1e-8 (C5, thinned).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.eval.ensemble import multichain_moments as j_moments
from ffvd_tpu.inference.sghmc import _tree_normals
from ffvd_tpu.inference.trainer import SubsetOps as JSubsetOps
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init
from ffvd_tpu.parallel.sharding import MultiChainTrainer as JMultiChain

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.eval.ensemble import multichain_moments, pool_moments
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                         init_hidden_layers,
                                         init_params_from_warmstart,
                                         params_from_numpy)
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.parallel import MultiChainTrainer

torch.set_num_threads(2)

C, S, SPACING, T = 2, 3, 2, 30


def by_path(tree):
    return dict(zip(LEAF_PATHS, map(np.asarray, jax.tree.leaves(tree))))


def _jax_chain_draws(key, sub, d, thinned):
    """One chain's draws from its moments key: thinning normals (S, SPACING,
    ...) per SG-HMC leaf, in path order, and rollout normals (S, T, D)."""
    def roll(k):
        return jax.vmap(lambda kt: jax.random.normal(kt, (d,), jnp.float64))(
            jax.random.split(k, T))

    def per_sample(k):
        if not thinned:
            return roll(k)
        k_thin, k_roll = jax.random.split(k)
        thin = jax.vmap(lambda kk: _tree_normals(kk, sub))(
            jax.random.split(k_thin, SPACING))
        return thin, roll(k_roll)
    return jax.jit(jax.vmap(per_sample))(jax.random.split(key, S))


@pytest.fixture
def rollout_calls(monkeypatch):
    calls = []
    fn = ro.rollout_batched

    def spy(*a, **kw):
        calls.append(kw["x0"].shape[0])
        return fn(*a, **kw)

    monkeypatch.setattr(ro, "rollout_batched", spy)
    return calls


@pytest.mark.parametrize("case,tol", [(4, 1e-10), (5, 1e-8)],
                         ids=["C4", "C5-thinned"])
def test_multichain_moments_match_jax(case, tol, rollout_calls):
    kw = dict(dataset="ballbeam", case=case, num_posterior_samples=S,
              posterior_sample_spacing=SPACING)
    ds = j_create_dataset("ballbeam")
    jmct = JMultiChain(JConfig(**kw), JSSMData(
        y=jnp.asarray(ds.y_train), control=jnp.asarray(ds.control)), C)
    stacked = jmct.stack_params(j_init(j_load_warmstart("ballbeam")),
                                jitter_key=jax.random.key(3))
    jstate, _ = jmct.run(jmct.init_state(stacked), 2, jax.random.key(1))
    key = jax.random.key(5)
    jchains, jnew = j_moments(jmct, jstate, T, key)

    thinned = case == 5
    params_c = jax.tree.map(lambda a: a[0], jstate.params)
    ops = JSubsetOps(jmct.base.labels, params_c)
    paths = [LEAF_PATHS[i] for i in ops.idx]
    per = [_jax_chain_draws(k, ops.split(params_c), 4, thinned)
           for k in jax.random.split(key, C)]
    noise = torch.tensor(np.stack([np.asarray(p[1] if thinned else p)
                                   for p in per]))
    thin = ({p: torch.tensor(np.stack([np.asarray(c[0][i]) for c in per]))
             for i, p in enumerate(paths)} if thinned else None)

    tds = create_dataset("ballbeam")
    mct = MultiChainTrainer(FFVDConfig(**kw), SSMData(
        y=torch.as_tensor(tds.y_train), control=torch.as_tensor(tds.control)),
        C)
    state = mct.init_state(params_from_numpy(by_path(jstate.params)))
    if thinned:
        state = mct.chain_from_numpy(
            state, {f: by_path(getattr(jstate.sghmc, f))
                    for f in ("xi", "g", "g2", "p")},
            by_path(jstate.window), int(jstate.window_count[0]))
    chains, new = multichain_moments(mct, state, T, noise=noise,
                                     thin_noise=thin)
    assert rollout_calls == [C * S]            # one call, rows c·S+s

    rt = dict(rtol=tol, atol=1e-12)
    assert len(chains) == C
    for (y_s, v_s, r2), (jy, jv, jr2) in zip(chains, jchains):
        assert y_s.shape == (S, T, 1)
        np.testing.assert_allclose(y_s, jy, **rt)
        np.testing.assert_allclose(v_s, jv, **rt)
        np.testing.assert_allclose(r2, jr2, **rt)
    jl = by_path(jnew.params)
    for k, v in new.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jl[k], err_msg=k, **rt)
    py, pv = pool_moments(chains)
    assert np.isfinite(py).all() and (pv > 0).all()
    if thinned:   # the chains moved; the stacked state carries them
        assert not torch.equal(new.params.kernel.log_variance,
                               state.params.kernel.log_variance)


@pytest.mark.parametrize("kw", [
    dict(case=4, kernel_type="LinearK"),
    dict(case=5, n_layers=2, posterior_sample_spacing=1)],
    ids=["LinearK-C4", "deep-C5"])
def test_linear_and_deep_chains_take_the_recursion(kw, rollout_calls):
    tds = create_dataset("ballbeam")
    data = SSMData(y=torch.as_tensor(tds.y_train),
                   control=torch.as_tensor(tds.control))
    p0 = init_params_from_warmstart(load_warmstart("ballbeam"))
    cfg = FFVDConfig(dataset="ballbeam", **kw)
    g = torch.Generator().manual_seed(0)
    if cfg.n_layers > 1:
        p0 = dataclasses.replace(p0, hidden=init_hidden_layers(1, p0, 1.0, g))
    mct = MultiChainTrainer(cfg, data, C)
    state = mct.init_state(mct.stack_params(p0, g))
    chains, new = multichain_moments(mct, state, T, num=S, generator=g,
                                     thin_generator=g)
    assert rollout_calls == [] and len(chains) == C
    assert all(np.isfinite(c[0]).all() and c[0].shape == (S, T, 1)
               for c in chains)
    if mct.has_sghmc:      # both chains thinned, and apart
        assert not torch.equal(new.params.kernel.log_variance,
                               state.params.kernel.log_variance)
        assert not np.allclose(chains[0][0], chains[1][0])
