"""Port parity, the deep trainer and sweep: C4, C1, C5, C2 and C6 with
hidden layers against the JAX ``Trainer``, 3 outer iterations with JAX's
draws injected (``jax_step_draws``, key layout in tests/test_torch_deep.py),
trace and every leaf at rtol 1e-9; the hidden leaves' labels; the
layer-count check; one deep sweep per style against ``make_pg_fn`` with
identical resampling indices and x at rtol 1e-12.
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.inference.particle_gibbs import make_pg_fn as j_make_pg_fn
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference import particle_gibbs as pg
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.conditionals import kernel_precal
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData, hidden_paths,
                                         params_from_numpy)
from tests.test_torch_deep import (D, M, assert_trainer_matches, by_path,
                                   deep_model, jax_deep_params,
                                   jax_deep_pg_draws, jax_step_draws)
from tests.test_torch_particle_gibbs import (  # noqa: F401 (fixture)
    STAT_KEYS, categorical_spy, jax_categorical_keys, to_torch_draws)

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(case=4), dict(case=1), dict(case=5, window_size=2),
    dict(case=5, deep_sample_hidden=True),
    dict(case=2, deep_sample_hidden=True)],
    ids=["C4", "C1", "C5", "C5-sample-hidden", "C2-sample-hidden"])
def test_deep_trainer_matches_jax(kw):
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, n_layers=2, **kw)
    leaves, y, control = deep_model(5, n=40)
    tr, _ = assert_trainer_matches(kw, leaves, y, control)
    assert tr.stochastic and tr.window_n is None


def test_label_tree_covers_hidden_leaves_like_jax():
    from ffvd_tpu.inference.trainer import label_tree as j_label_tree
    from ffvd_tpu_torch.inference.trainer import label_tree
    for case in range(1, 8):
        for sample_hidden in (False, True):
            kw = dict(case=case, n_layers=3, deep_sample_hidden=sample_hidden)
            labels = label_tree(FFVDConfig(**kw))
            j = j_label_tree(JConfig(**kw))
            assert list(labels) == list(LEAF_PATHS + hidden_paths(2))
            assert list(labels.values()) == jax.tree.leaves(j), kw


def test_init_state_checks_the_hidden_layer_count():
    leaves, y, control = deep_model(6)
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    tr = Trainer(FFVDConfig(case=4, num_inducing=M, x_dim=D, n_layers=3),
                 data)
    with pytest.raises(ValueError, match="1 hidden layers"):
        tr.init_state(params_from_numpy(leaves))
    with pytest.raises(ValueError, match="Generator"):
        tr2 = Trainer(FFVDConfig(case=4, num_inducing=M, x_dim=D,
                                 n_layers=2), data)
        tr2.outer_step(tr2.init_state(params_from_numpy(leaves)))


def test_deep_c6_trainer_matches_jax():
    """Three deep C6 iterations: the sweep's draws from JAX's k_pg, the
    Adam gradient's inter-layer normals from k_feed's split."""
    n, p = 24, 8
    leaves, y, control = deep_model(14, n=n)
    kw = dict(dataset="flutter", case=6, num_inducing=M, x_dim=D,
              pg_particles=p, n_layers=2)
    jcfg = JConfig(**kw)
    jtr = JTrainer(jcfg, JSSMData(y=jnp.asarray(y),
                                  control=jnp.asarray(control)),
                   pg_fn=j_make_pg_fn(jcfg))
    jtr._params0 = jax_deep_params(leaves)
    state = jtr.init_state(jtr._params0)
    step = jax.jit(jtr.outer_step)
    draws, jtrace = [], []
    for key in jax.random.split(jax.random.key(4), 3):
        dr = jax_step_draws(jtr, key, 1, 1, D)
        dr["pg"] = to_torch_draws(jax_deep_pg_draws(
            jax.random.split(key, 3)[2], n, p, D, 1, True))
        draws.append(dr)
        state, nll = step(state, key)
        jtrace.append(float(nll))
    tr = Trainer(FFVDConfig(**kw), SSMData(y=torch.as_tensor(y),
                                           control=torch.as_tensor(control)),
                 pg_fn=pg.make_pg_fn(FFVDConfig(**kw)))
    pstate, trace = tr.run(tr.init_state(params_from_numpy(leaves)), 3,
                           draws=draws)
    tol = dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(trace.numpy(), jtrace, **tol)
    jleaves = by_path(state.params)
    for k, v in pstate.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jleaves[k],
                                   err_msg=k, **tol)


@pytest.mark.parametrize("ancestor", [True, False],
                         ids=["ancestor", "reference"])
def test_deep_sweep_matches_jax(categorical_spy, ancestor):
    n, p = 32, 16
    leaves, y, control = deep_model(13, n=n)
    kw = dict(dataset="flutter", case=6, num_inducing=M, x_dim=D,
              pg_particles=p, pg_ancestor_trace=ancestor, n_layers=2)
    key = jax.random.key(21)
    draws = to_torch_draws(jax_deep_pg_draws(key, n, p, D, 1, ancestor))
    jdata = JSSMData(y=jnp.asarray(y), control=jnp.asarray(control))
    jparams, jstats = jax.jit(j_make_pg_fn(JConfig(**kw), jdata,
                                           with_stats=True))(
        jax_deep_params(leaves), key)
    jax.effects_barrier()
    j_idx = [categorical_spy(k)
             for k in jax_categorical_keys(key, n, ancestor)]

    cfg = FFVDConfig(**kw)
    params = params_from_numpy(leaves)
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    out, stats = pg.make_pg_fn(cfg, data, with_stats=True)(params,
                                                           draws=draws)
    style = pg.pg_ancestor_style if ancestor else pg.pg_reference_style
    pre = kernel_precal(cfg.kernel_type, params.kernel, params.z, cfg.jitter)
    _, _, picks = style(cfg, params, pre, data, draws)
    if ancestor:
        np.testing.assert_array_equal(picks["ancestors"][:, :p - 1].numpy(),
                                      np.stack(j_idx[:n]))
        assert int(picks["final"][0]) == int(j_idx[n])
    else:
        np.testing.assert_array_equal(picks["resampled"].numpy(),
                                      np.stack(j_idx))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(jparams.x),
                               rtol=1e-12, atol=1e-14)
    for k in STAT_KEYS:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-14, err_msg=k)
    # the hidden layers changed the sweep: without them it differs
    shallow = dataclasses.replace(params, hidden=())
    sx = pg.make_pg_fn(dataclasses.replace(cfg, n_layers=1), data)(
        shallow, draws={k: v for k, v in draws.items() if k != "hidden"})
    assert not torch.allclose(sx.x, out.x)
    dr = pg.pg_draws(cfg, params, torch.Generator().manual_seed(0))
    assert dr["hidden"].shape == (n, 1, p - 1, D)
