"""Port parity, the SG-HMC trainer: C2, C3, C5, C7 and C4 with
hyperparameter sampling against the JAX ``Trainer``.

Both start from the ballbeam warm start in fp64.  The port cannot
reproduce threefry, so the test computes the JAX trainer's own draws with
JAX's calls (per outer iteration: ``k_sghmc, k_feed, _ = split(key, 3)``,
the 21 sub-steps' normals ``vmap(_tree_normals)(split(k_sghmc, 21))`` over
the SG-HMC subset, and the feed index ``randint(k_feed, (), 0, count)``)
and injects them into ``Trainer.run(draws=...)``.  Over 3 outer iterations
the nll trace, every parameter leaf, the sampler state, the window and its
count agree at rtol 1e-9 (the same arithmetic in another summation order;
measured agreement is near 1e-13).  C5 runs with ``window_size=2``, so its
third snapshot wraps the ring.
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
from ffvd_tpu.inference.sghmc import _tree_normals
from ffvd_tpu.inference.trainer import SubsetOps as JSubsetOps
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                         init_params_from_warmstart)

torch.set_num_threads(2)

ITERS = 3
CASES = [
    dict(case=2), dict(case=3), dict(case=5, window_size=2), dict(case=7),
    dict(case=4, hyperparameter_sampling=True),
]


def by_path(tree):
    """A JAX pytree's leaves (GPSSMParams order) as numpy keyed by path."""
    return dict(zip(LEAF_PATHS, map(np.asarray, jax.tree.leaves(tree))))


def _jax_run(kw, n):
    """n jitted JAX outer steps, with the draws each one makes."""
    cfg = JConfig(dataset="ballbeam", **kw)
    ds = j_create_dataset(cfg.dataset)
    tr = JTrainer(cfg, JSSMData(y=jnp.asarray(ds.y_train),
                                control=jnp.asarray(ds.control)))
    state = tr.init_state(j_init(j_load_warmstart(cfg.dataset)))
    ops = JSubsetOps(tr.labels, state.params)
    paths = [LEAF_PATHS[i] for i in ops.idx]
    sub0 = ops.split(state.params)
    normals = jax.jit(lambda k: jax.vmap(lambda kk: _tree_normals(kk, sub0))(
        jax.random.split(k, len(SUBSTEP_FLAGS))))
    step = jax.jit(tr.outer_step)
    draws, nlls = [], []
    for key in jax.random.split(jax.random.key(7), n):
        k_sghmc, k_feed, _ = jax.random.split(key, 3)
        count = min(int(state.window_count) + 1, cfg.window_size)
        feed = int(jax.random.randint(k_feed, (), 0, max(count, 1)))
        draws.append({
            "noise": {p: torch.tensor(np.asarray(a))
                      for p, a in zip(paths, normals(k_sghmc))},
            "feed": feed})
        state, nll = step(state, key)
        nlls.append(float(nll))
    return state, np.asarray(nlls), draws, paths


def _port(kw):
    cfg = FFVDConfig(dataset="ballbeam", **kw)
    ds = create_dataset(cfg.dataset)
    tr = Trainer(cfg, SSMData(y=torch.as_tensor(ds.y_train),
                              control=torch.as_tensor(ds.control)))
    return tr, tr.init_state(init_params_from_warmstart(
        load_warmstart(cfg.dataset)))


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9,
                               atol=1e-12, err_msg=what)


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_sghmc_trainer_matches_jax(kw):
    jstate, jtrace, draws, paths = _jax_run(kw, ITERS)
    tr, state = _port(kw)
    assert list(tr.subset.paths) == paths
    init = {k: v.detach().clone() for k, v in state.params.leaves().items()}
    state, trace = tr.run(state, ITERS, draws=draws)

    _close(trace.numpy(), jtrace, "nll trace")
    jparams = by_path(jstate.params)
    for k, v in state.params.leaves().items():
        _close(v.detach().numpy(), jparams[k], k)
    for field in ("xi", "g", "g2", "p"):
        jleaves = by_path(getattr(jstate.sghmc, field))
        for k in paths:
            _close(getattr(state.sghmc, field)[k].numpy(), jleaves[k],
                   f"sghmc.{field}.{k}")
    jwindow = by_path(jstate.window)
    for k in paths:
        _close(state.window[k].numpy(), jwindow[k], f"window.{k}")
    assert state.window_count == int(jstate.window_count) \
        == min(ITERS, tr.cfg.window_size)
    assert state.step == ITERS
    # leaves that neither Adam nor the sampler owns never move
    for k, label in tr.labels.items():
        if label == "frozen":
            assert torch.equal(state.params.leaves()[k], init[k]), k
        else:
            assert not torch.equal(state.params.leaves()[k], init[k]), k


def test_ring_buffer_wraps():
    """window_size=2 over 3 iterations: slot 0 holds the third snapshot,
    slot 1 the second; the count stops at 2."""
    tr, state = _port(dict(case=5, window_size=2))
    gen = torch.Generator().manual_seed(3)
    snaps = []
    for _ in range(3):
        tr.outer_step(state, gen)
        snaps.append(state.params.kernel.log_variance.clone())
    w = state.window["kernel.log_variance"]
    assert torch.equal(w[0], snaps[2]) and torch.equal(w[1], snaps[1])
    assert state.window_count == 2 and state.step == 3


def test_c7_has_no_adam_and_keeps_frozen_leaves_bit_identical():
    tr, state = _port(dict(case=7))
    assert state.adam is None and tr.has_sghmc and not tr.has_adam
    frozen = {k: v.clone() for k, v in state.params.leaves().items()
              if tr.labels[k] == "frozen"}
    assert set(frozen) == {"z", "kernel.log_variance",
                           "kernel.log_lengthscales", "log_q", "c", "d",
                           "log_rchol"}
    state, trace = tr.run(state, 2, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(trace).all()
    for k, v in frozen.items():
        assert torch.equal(state.params.leaves()[k], v), k


def test_same_seed_same_trace():
    cfg = FFVDConfig(dataset="ballbeam", case=5)
    a = FFVDModel(cfg, device="cpu").fit(2)
    b = FFVDModel(cfg, device="cpu").fit(2)
    c = FFVDModel(dataclasses.replace(cfg, seed=1), device="cpu").fit(2)
    assert torch.equal(a.nll_trace, b.nll_trace)
    assert torch.equal(a.params.kernel.log_variance,
                       b.params.kernel.log_variance)
    assert not torch.equal(a.nll_trace, c.nll_trace)


def test_sampler_without_draws_or_generator_raises():
    tr, state = _port(dict(case=2))
    with pytest.raises(ValueError, match="Generator"):
        tr.outer_step(state)
