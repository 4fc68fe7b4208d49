"""Port parity, the chain axis: ``parallel/sharding.py::MultiChainTrainer``
against the JAX package's ``MultiChainTrainer`` (``mesh=None``, on the CPU).

The port's batched step puts only the objective under ``torch.func.vmap``
and draws every random number outside it, with a chain axis.  The port
cannot reproduce threefry, so the sampler tests rebuild JAX's per-chain
draws with JAX's own calls: ``run`` splits ``key → (key, sub)`` and ``sub``
into T×C step keys, and each chain's step key gives its draws as in the
single-chain trainer (``jax_step_draws``, tests/test_torch_deep.py).

- C4 on ballbeam, 3 chains from JAX's perturbed ``stack_params``, 50
  iterations (no draws): trace and leaves at rtol 1e-10.
- C2, C5 and deep C4/C5 with injected draws: in
  tests/test_torch_multichain_draws.py.
- Identical chains reproduce the port's single-chain ``Trainer`` at rtol
  1e-12 (``tests/test_sharding.py:24-47``).

Every batched step runs with functorch's per-chain fallback warning turned
into an error, so no op loops over the chains unnoticed.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._C._functorch as functorch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init
from ffvd_tpu.parallel.sharding import MultiChainTrainer as JMultiChain

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                         init_params_from_warmstart,
                                         params_from_numpy, params_to_numpy)
from ffvd_tpu_torch.parallel import MultiChainTrainer, stack_warmstarts
from ffvd_tpu_torch.parallel.sharding import member, stack_members
from tests.test_torch_deep import (D, M, by_path, deep_model, jax_deep_params,
                                   jax_step_draws)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fallback_raises():
    """functorch's 'There is a performance drop …' warning, which marks a
    per-example loop inside vmap, raised as an error."""
    functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="There is a performance drop")
        yield
    functorch._set_vmap_fallback_warning_enabled(False)


def stack_leaves(per_chain):
    return {k: np.stack([p[k] for p in per_chain]) for k in per_chain[0]}


def stack_draws(per_chain):
    """One iteration's per-chain ``outer_step`` keywords, chain axis first."""
    first, out = per_chain[0], {}
    if "noise" in first:
        out["noise"] = {p: torch.stack([d["noise"][p] for d in per_chain])
                        for p in first["noise"]}
    if "feed" in first:
        out["feed"] = [d["feed"] for d in per_chain]
    if "starts" in first:
        out["starts"] = torch.stack([d["starts"] for d in per_chain])
    if "prop" in first:
        out["prop"] = [torch.stack([d["prop"][i] for d in per_chain])
                       for i in range(len(first["prop"]))]
    return out


def jax_multichain(kw, leaves, y, control, n_iter, seed=7, mesh=None):
    """JAX's MultiChainTrainer.run over ``leaves`` (chain-stacked numpy),
    one chunk, with the port's injected draws of every iteration; on
    ``mesh`` (a JAX ('dp', 'ep') mesh) when given."""
    cfg = JConfig(**kw)
    c = leaves["x"].shape[0]
    mct = JMultiChain(cfg, JSSMData(y=jnp.asarray(y),
                                    control=jnp.asarray(control)), c,
                      mesh=mesh)
    params = jax_deep_params(leaves)
    mct.base._params0 = jax.tree.map(lambda a: a[0], params)
    state = mct.init_state(params)
    key = jax.random.key(seed)
    _, sub = jax.random.split(key)
    keys = jax.random.split(sub, n_iter * c).reshape(n_iter, c)
    draws = [stack_draws([jax_step_draws(
        mct.base, keys[t, i], min(t + 1, cfg.window_size),
        len(params.hidden), params.x.shape[-1]) for i in range(c)])
        for t in range(n_iter)]
    state, nlls = mct.run(state, n_iter, key, chunk_size=n_iter)
    return state, np.asarray(nlls), draws


def port_multichain(kw, leaves, y, control, n_iter, draws=None, gen=None):
    cfg = FFVDConfig(**kw)
    c = leaves["x"].shape[0]
    mct = MultiChainTrainer(cfg, SSMData(y=torch.as_tensor(y),
                                         control=torch.as_tensor(control)),
                            c, pg_fn=make_pg_fn(cfg) if cfg.case == 6
                            else None)
    state = mct.init_state(params_from_numpy(leaves))
    state, trace = mct.run(state, n_iter, draws=draws, generator=gen)
    return mct, state, trace


def assert_state_matches(mct, state, trace, jstate, jtrace, tol):
    np.testing.assert_allclose(trace.numpy(), jtrace, **tol)
    jleaves = by_path(jstate.params)
    for k, v in state.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jleaves[k],
                                   err_msg=k, **tol)
    paths = mct.subset.paths
    for f in ("xi", "g", "g2", "p") if paths else ():
        jf = by_path(getattr(jstate.sghmc, f))
        for k in paths:
            np.testing.assert_allclose(getattr(state.sghmc, f)[k].numpy(),
                                       jf[k], err_msg=f"{f}.{k}", **tol)
    jwin = by_path(jstate.window)
    for k in paths:
        np.testing.assert_allclose(state.window[k].numpy(), jwin[k],
                                   err_msg=f"window.{k}", **tol)
    assert state.window_count == int(np.asarray(jstate.window_count)[0])
    assert state.step == int(np.asarray(jstate.step)[0])


def test_c4_three_chains_match_jax_over_50_iterations():
    jcfg = JConfig(dataset="ballbeam", case=4)
    ds = j_create_dataset("ballbeam")
    jdata = JSSMData(y=jnp.asarray(ds.y_train),
                     control=jnp.asarray(ds.control))
    jmct = JMultiChain(jcfg, jdata, 3)
    jkey = jax.random.key(11)
    jp = j_init(j_load_warmstart("ballbeam"))
    stacked = jmct.stack_params(jp, jitter_key=jkey)
    # JAX's perturbation normals: one key per stacked leaf
    jl = jax.tree.leaves(jax.tree.map(lambda a: jnp.stack([a] * 3), jp))
    normals = {p: np.asarray(jax.random.normal(k, a.shape, a.dtype))
               for p, k, a in zip(LEAF_PATHS, jax.random.split(jkey, len(jl)),
                                  jl)}
    jstate, jtrace = jmct.run(jmct.init_state(stacked), 50,
                              jax.random.key(0), chunk_size=50)

    cfg = FFVDConfig(dataset="ballbeam", case=4)
    tds = create_dataset("ballbeam")
    mct = MultiChainTrainer(cfg, SSMData(y=torch.as_tensor(tds.y_train),
                                         control=torch.as_tensor(
                                             tds.control)), 3)
    p = mct.stack_params(init_params_from_warmstart(
        load_warmstart("ballbeam")), normals=normals)
    jstacked = by_path(stacked)
    for k, v in p.leaves().items():
        np.testing.assert_allclose(v.numpy(), jstacked[k], rtol=1e-15,
                                   atol=1e-15, err_msg=k)
    state, trace = mct.run(mct.init_state(p), 50, chunk_size=20)
    assert trace.shape == (50, 3)
    assert_state_matches(mct, state, trace, jstate, np.asarray(jtrace),
                         dict(rtol=1e-10, atol=1e-13))
    assert len(set(trace[-1].tolist())) == 3        # the chains differ
    assert np.isfinite(mct.rhat(trace))


def _single_draws(tr, n_iter, seed):
    """Random per-iteration draws in the single trainer's layout."""
    g = torch.Generator().manual_seed(seed)
    p0 = tr._p0
    out = []
    for t in range(n_iter):
        d = {}
        if tr.has_sghmc:
            d["noise"] = {k: torch.randn((len(SUBSTEP_FLAGS),) + v.shape,
                                         generator=g, dtype=v.dtype)
                          for k, v in tr.subset.split(p0).items()}
            d["feed"] = int(torch.randint(0, min(t + 1, tr.cfg.window_size),
                                          (), generator=g))
        d.update(tr.grad_draws(22 if tr.has_sghmc else 1, g, p0.x))
        out.append(d)
    return out


@pytest.mark.parametrize("kw", [
    dict(case=4), dict(case=2, window_size=4),
    dict(case=4, minibatch_size=12), dict(case=5, n_layers=2),
    dict(case=5, collapse_precision="ds64")],
    ids=["C4", "C2", "C4-window", "deep-C5", "C5-ds64"])
def test_identical_chains_reproduce_the_single_chain_trainer(kw):
    n_hidden = kw.get("n_layers", 1) - 1
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, **kw)
    leaves, y, control = deep_model(8, n=32, n_hidden=n_hidden)
    cfg = FFVDConfig(**kw)
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    tr = Trainer(cfg, data)
    tr._p0 = params_from_numpy(leaves)
    draws = _single_draws(tr, 3, 1)
    state, trace = tr.run(tr.init_state(tr._p0), 3, draws=draws)

    mct = MultiChainTrainer(cfg, data, 2)
    mdraws = [stack_draws([d, d]) for d in draws]
    mstate, mtrace = mct.run(mct.init_state(mct.stack_params(tr._p0)), 3,
                             draws=mdraws)
    tol = dict(rtol=1e-12, atol=1e-14)
    for i in range(2):
        np.testing.assert_allclose(mtrace[:, i].numpy(), trace.numpy(),
                                   **tol)
        for k, v in member(mstate.params, i).leaves().items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       state.params.leaves()[k].detach()
                                       .numpy(), err_msg=k, **tol)
        for k, w in mstate.window.items():
            np.testing.assert_allclose(w[i].numpy(), state.window[k].numpy(),
                                       err_msg=k, **tol)


def test_deep_chains_train_finitely_from_the_generator():
    """``tests/test_deep.py:132-145``'s counterpart: 2 deep chains of C4 and
    C2, drawing every start and normal from the generator."""
    for kw in (dict(case=4), dict(case=2, minibatch_size=16)):
        kw = dict(dataset="flutter", num_inducing=M, x_dim=D, n_layers=2,
                  **kw)
        leaves, y, control = deep_model(9, n=32)
        mct, state, trace = port_multichain(
            kw, stack_leaves([leaves, leaves]), y, control, 4,
            gen=torch.Generator().manual_seed(0))
        assert trace.shape == (4, 2) and torch.isfinite(trace).all()
        assert not torch.equal(trace[:, 0], trace[:, 1])


def test_c6_chains_sweep_one_at_a_time():
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=6,
              pg_particles=8)
    leaves, y, control = deep_model(2, n=24, n_hidden=0)
    mct, state, trace = port_multichain(
        kw, stack_leaves([leaves, leaves]), y, control, 2,
        gen=torch.Generator().manual_seed(0))
    assert trace.shape == (2, 2) and torch.isfinite(trace).all()
    # each chain got its own sweep: the trajectories differ
    assert not torch.equal(state.params.x[0], state.params.x[1])


def test_an_op_without_a_batching_rule_raises(monkeypatch):
    leaves, y, control = deep_model(1, n=16, n_hidden=0)
    mct, state, _ = port_multichain(
        dict(dataset="flutter", num_inducing=M, x_dim=D, case=4),
        stack_leaves([leaves, leaves]), y, control, 0)
    nll = mct.member_nll
    monkeypatch.setattr(mct, "member_nll", lambda p, *a: nll(p, *a)
                        + 0.0 * torch.histc(p.x, 4).sum())
    with pytest.raises(RuntimeError, match="vmap fallback"):
        mct.outer_step(state)


def test_nan_check_names_the_chain_and_iteration():
    leaves, y, control = deep_model(1, n=16, n_hidden=0)
    leaves = stack_leaves([leaves, leaves])
    leaves["log_q"][1, 0] = np.nan
    with pytest.raises(FloatingPointError, match="iteration 0 in chain 1"):
        port_multichain(dict(dataset="flutter", num_inducing=M, x_dim=D,
                             case=4), leaves, y, control, 2)


def test_weights_carry_across_with_a_chain_axis():
    base = init_params_from_warmstart(load_warmstart("ballbeam"))
    stacked = stack_warmstarts("ballbeam", [3, 3])
    for k, v in stacked.leaves().items():
        assert torch.equal(v[0], base.leaves()[k]) and v.shape[0] == 2
    tree = params_to_numpy(stacked)
    assert tree["x"].shape == (2, 501, 4)
    back = params_from_numpy(tree)
    assert all(torch.equal(back.leaves()[k], v)
               for k, v in stacked.leaves().items())
    assert torch.equal(stack_members([member(back, 0), member(back, 1)]).z,
                       stacked.z)
