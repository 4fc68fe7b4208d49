"""The particle-Gibbs sweep of case C6 batched over a member axis:
``particle_gibbs.batched_sweep`` under ``parallel.BatchedTrainer._pg``.

The C sweeps of a ``MultiChainTrainer`` (or the datasets of a
``MultiDatasetTrainer``) run as one sweep under ``torch.func.vmap``, with
each member's draws made first, in member order.  Held here, fp64 on the
CPU, small models (n=24, D=2, M=6, P=8):

- against C single-member ``pg_fn`` sweeps one after another (the trainer's
  path before the sweep was batched), at rtol 1e-12: both sweep styles,
  shallow and deep (``n_layers=2``), chains and datasets, from one
  generator and from injected draws; and three whole C6 iterations;
- against JAX's vmapped C6 ``MultiChainTrainer``
  (``ffvd_tpu/parallel/sharding.py:120-182``) over 3 iterations at rtol
  1e-9, each chain's sweep fed JAX's draws from that chain's key
  (``jax_pg_draws``);
- a batched C6 step reads nothing back to the host
  (``tests/torch_host_guard.py``), and an op without a batching rule in the
  sweep raises instead of looping.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.inference.particle_gibbs import make_pg_fn as j_make_pg_fn
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.parallel.sharding import MultiChainTrainer as JMultiChain

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference import particle_gibbs as pg
from ffvd_tpu_torch.model.params import SSMData, params_from_numpy
from ffvd_tpu_torch.parallel import MultiChainTrainer
from ffvd_tpu_torch.parallel.sharding import (BatchedTrainer, member,
                                              stack_members)
from tests.test_torch_deep import D, M, by_path, deep_model, jax_deep_params
from tests.test_torch_multichain import stack_leaves
from tests.test_torch_particle_gibbs import jax_pg_draws, to_torch_draws
from tests.torch_host_guard import no_host_reads

torch.set_num_threads(2)

C, N, P = 3, 24, 8
TOL = dict(rtol=1e-12, atol=1e-14)


def _cfg(ancestor, n_hidden, **kw):
    return FFVDConfig(dataset="flutter", case=6, num_inducing=M, x_dim=D,
                      pg_particles=P, n_layers=n_hidden + 1,
                      pg_ancestor_trace=ancestor, **kw)


def _members(n_hidden, datasets):
    """C members' stacked params and data: chains of one dataset, each
    start moved apart, or (``datasets``) C small datasets of one shape."""
    models = [deep_model(20 + i if datasets else 20, n=N, n_hidden=n_hidden)
              for i in range(C)]
    leaves = stack_leaves([m[0] for m in models])
    rng = np.random.RandomState(5)
    leaves["x"] = leaves["x"] + 0.1 * rng.randn(*leaves["x"].shape)
    y = np.stack([m[1] for m in models])
    control = np.stack([m[2] for m in models])
    if not datasets:
        y, control = y[0], control[0]
    return (params_from_numpy(leaves),
            SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control)))


def per_member_sweeps(trainer, params, generator, pg_list):
    """The C sweeps one after another, as ``BatchedTrainer._pg`` ran them
    before the batch: ``pg_fn`` on each member with its data and draws."""
    return torch.stack([trainer.pg_fn(
        member(params, i), generator, trainer.member_data(i),
        draws=None if pg_list is None else pg_list[i]).x
        for i in range(trainer.n)])


class PerMemberTrainer(MultiChainTrainer):
    """A ``MultiChainTrainer`` whose C6 sweeps run one member at a time."""

    def _pg(self, params, generator, pg_list):
        return dataclasses.replace(params, x=per_member_sweeps(
            self, params, generator, pg_list))


@pytest.mark.parametrize("source", ["generator", "injected"])
@pytest.mark.parametrize("axis", ["chains", "datasets"])
@pytest.mark.parametrize("n_hidden", [0, 1], ids=["shallow", "deep"])
@pytest.mark.parametrize("ancestor", [True, False],
                         ids=["ancestor", "reference"])
def test_batched_sweep_equals_per_member_sweeps(ancestor, n_hidden, axis,
                                                source):
    cfg = _cfg(ancestor, n_hidden)
    datasets = axis == "datasets"
    params, data = _members(n_hidden, datasets)
    tr = BatchedTrainer(cfg, data, C, data_axis=datasets,
                        pg_fn=pg.make_pg_fn(cfg))
    draws = None
    if source == "injected":
        g = torch.Generator().manual_seed(3)
        draws = [pg.pg_draws(cfg, member(params, 0), g) for _ in range(C)]
    ga, gb = (torch.Generator().manual_seed(4) for _ in range(2))
    want = per_member_sweeps(tr, params, ga, draws)
    got = tr._pg(params, gb, draws).x
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # every member swept, and the generators advanced alike
    assert not torch.equal(got, params.x)
    assert torch.equal(ga.get_state(), gb.get_state())
    for i in range(C):
        assert not torch.equal(got[i], params.x[i])


def test_three_c6_iterations_equal_the_per_member_trainer():
    cfg = _cfg(True, 0)
    params, data = _members(0, False)
    run = {}
    for name, cls in (("batched", MultiChainTrainer),
                      ("per_member", PerMemberTrainer)):
        tr = cls(cfg, data, C, pg_fn=pg.make_pg_fn(cfg))
        state = tr.init_state(params)
        _, trace = tr.run(state, 3, generator=torch.Generator().manual_seed(6))
        run[name] = (state, trace)
    (a, ta), (b, tb) = run["batched"], run["per_member"]
    np.testing.assert_allclose(ta.numpy(), tb.numpy(), **TOL)
    for x, y in zip(a.tensors(), b.tensors()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   **TOL)
    assert not torch.equal(a.params.x[0], a.params.x[1])


def _jax_c6_chains(kw, leaves, y, control, n_iter, seed):
    """JAX's MultiChainTrainer.run of C6 over chain-stacked ``leaves``, and
    each iteration's per-chain sweep draws, derived from that chain's step
    key as the single-chain trainer splits it (k_pg, the third of three)."""
    cfg = JConfig(**kw)
    c = leaves["x"].shape[0]
    mct = JMultiChain(cfg, JSSMData(y=jnp.asarray(y),
                                    control=jnp.asarray(control)), c,
                      pg_fn=j_make_pg_fn(cfg))
    key = jax.random.key(seed)
    _, sub = jax.random.split(key)
    keys = jax.random.split(sub, n_iter * c).reshape(n_iter, c)
    n, d = leaves["x"].shape[1] - 1, leaves["x"].shape[2]
    draws = [{"pg": [to_torch_draws(jax_pg_draws(
        jax.random.split(keys[t, i], 3)[2], n, cfg.pg_particles, d,
        cfg.pg_ancestor_trace)) for i in range(c)]} for t in range(n_iter)]
    state, nlls = mct.run(mct.init_state(jax_deep_params(leaves)), n_iter,
                          key, chunk_size=n_iter)
    return state, np.asarray(nlls), draws


@pytest.mark.parametrize("ancestor", [True, False],
                         ids=["ancestor", "reference"])
def test_c6_chains_match_jax_over_3_iterations(ancestor):
    kw = dict(dataset="flutter", case=6, num_inducing=M, x_dim=D,
              pg_particles=16, pg_ancestor_trace=ancestor)
    base, y, control = deep_model(31, n=N, n_hidden=0)
    rng = np.random.RandomState(7)
    leaves = stack_leaves([base] * C)
    leaves = {k: v + 1e-3 * rng.randn(*v.shape) for k, v in leaves.items()}
    jstate, jtrace, draws = _jax_c6_chains(kw, leaves, y, control, 3, 9)

    cfg = FFVDConfig(**kw)
    mct = MultiChainTrainer(cfg, SSMData(y=torch.as_tensor(y),
                                         control=torch.as_tensor(control)),
                            C, pg_fn=pg.make_pg_fn(cfg))
    state = mct.init_state(params_from_numpy(leaves))
    x0 = state.params.x.clone()
    state, trace = mct.run(state, 3, draws=draws)
    tol = dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(trace.numpy(), jtrace, **tol)
    jleaves = by_path(jstate.params)
    for k, v in state.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jleaves[k],
                                   err_msg=k, **tol)
    for i in range(C):
        assert not torch.equal(state.params.x[i], x0[i])


@pytest.mark.parametrize("axis", ["chains", "datasets"])
def test_a_batched_c6_step_reads_nothing_back(axis):
    cfg = _cfg(True, 1)
    datasets = axis == "datasets"
    params, data = _members(1, datasets)
    tr = BatchedTrainer(cfg, data, C, data_axis=datasets,
                        pg_fn=pg.make_pg_fn(cfg))
    state = tr.init_state(params)
    x0 = state.params.x.clone()
    g = torch.Generator().manual_seed(8)
    with no_host_reads():
        nlls = [tr.outer_step(state, g) for _ in range(2)]
    assert all(n.shape == (C,) and torch.isfinite(n).all() for n in nlls)
    assert not torch.equal(state.params.x, x0)


def test_the_sweep_raises_on_an_op_without_a_batching_rule(monkeypatch):
    cfg = _cfg(True, 0)
    params, data = _members(0, False)
    tr = MultiChainTrainer(cfg, data, C, pg_fn=pg.make_pg_fn(cfg))
    weights = pg._weights
    monkeypatch.setattr(pg, "_weights", lambda p, pool, *a: weights(
        p, pool, *a) + 0.0 * torch.histc(pool, 4).sum())
    with pytest.raises(RuntimeError, match="vmap fallback"):
        tr._pg(params, torch.Generator().manual_seed(0), None)


def test_pg_compat_noop_sweeps_nothing_and_draws_nothing():
    cfg = _cfg(None, 0, pg_compat_noop=True)
    params, data = _members(0, False)
    tr = MultiChainTrainer(cfg, data, C, pg_fn=pg.make_pg_fn(cfg))
    g = torch.Generator().manual_seed(0)
    before = g.get_state()
    assert tr._pg(params, g, None).x is params.x
    assert torch.equal(g.get_state(), before)


def test_stack_draws_puts_the_member_axis_first():
    cfg = _cfg(False, 1)
    params, _ = _members(1, False)
    g = torch.Generator().manual_seed(2)
    per = [pg.pg_draws(cfg, member(params, 0), g) for _ in range(C)]
    st = pg.stack_draws(per)
    assert set(st) == set(per[0])
    for k, v in st.items():
        assert v.shape == (C,) + per[0][k].shape
        assert all(torch.equal(v[i], per[i][k]) for i in range(C))
    assert stack_members([member(params, i) for i in range(C)]).x.shape \
        == params.x.shape
