"""Port parity (d): the Adam-only trainer against the JAX ``Trainer``.

C4 training draws no random numbers, so in fp64 the port's nll trace is
held against the JAX trainer's step by step.  Measured agreement over 200
ballbeam iterations is ~1e-15 relative (the same arithmetic, summed in
another order; torch.optim.Adam and optax.adam are one formula), so the
test holds it at rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.inference.trainer import label_tree as j_label_tree
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.inference.trainer import (Trainer, label_tree,
                                              sanitize_grads)
from ffvd_tpu_torch.model.params import SSMData, init_params_from_warmstart

torch.set_num_threads(2)

ANCHOR_NLL = -2.410755   # ballbeam C4 warm start (TF golden fixture)


def _port(cfg):
    ds = create_dataset(cfg.dataset)
    data = SSMData(y=torch.as_tensor(ds.y_train),
                   control=torch.as_tensor(ds.control))
    tr = Trainer(cfg, data)
    return tr, tr.init_state(init_params_from_warmstart(
        load_warmstart(cfg.dataset)))


def _jax_trace(cfg, n):
    ds = j_create_dataset(cfg.dataset)
    data = JSSMData(y=jnp.asarray(ds.y_train), control=jnp.asarray(ds.control))
    tr = JTrainer(cfg, data)
    state, nlls = tr.run(tr.init_state(j_init(j_load_warmstart(cfg.dataset))),
                         n, jax.random.key(0), chunk_size=100)
    return state, np.asarray(nlls)


def test_c4_nll_trace_matches_jax_trainer():
    tr, state = _port(FFVDConfig(dataset="ballbeam", case=4))
    u0 = state.params.u.detach().clone()
    state, trace = tr.run(state, 200, chunk_size=100)
    jstate, jtrace = _jax_trace(JConfig(dataset="ballbeam", case=4), 200)
    trace = trace.numpy()
    assert trace.shape == (200,)
    np.testing.assert_allclose(trace[0], ANCHOR_NLL, rtol=1e-6)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-12)
    # u is frozen in C4 (collapsed): Adam never touches it.
    assert torch.equal(state.params.u, u0)
    assert state.step == 200
    np.testing.assert_allclose(state.params.x.detach().numpy(),
                               np.asarray(jstate.params.x), rtol=1e-9,
                               atol=1e-12)


def test_c1_trace_matches_jax_trainer():
    """C1 (uncollapsed, u trained by Adam) over 20 iterations."""
    tr, state = _port(FFVDConfig(dataset="ballbeam", case=1))
    u0 = state.params.u.detach().clone()
    _, trace = tr.run(state, 20, chunk_size=20)
    _, jtrace = _jax_trace(JConfig(dataset="ballbeam", case=1), 20)
    np.testing.assert_allclose(trace.numpy(), jtrace, rtol=1e-12)
    assert not torch.equal(state.params.u, u0)


@pytest.mark.parametrize("case", range(1, 8))
def test_label_tree_matches_jax(case):
    labels = label_tree(FFVDConfig(case=case))
    j = j_label_tree(JConfig(case=case))
    assert labels == {"x": j.x, "u": j.u, "z": j.z,
                      "kernel.log_variance": j.kernel.log_variance,
                      "kernel.log_lengthscales": j.kernel.log_lengthscales,
                      "log_q": j.log_q, "c": j.c, "d": j.d,
                      "log_rchol": j.log_rchol}


@pytest.mark.parametrize("kw,item", [
    ({"case": 2}, "item 6"), ({"case": 3}, "item 6"), ({"case": 5}, "item 6"),
    ({"case": 6}, "item 7"), ({"case": 7}, "item 6"),
    ({"case": 4, "hyperparameter_sampling": True}, "item 6"),
    ({"case": 4, "n_layers": 2}, "item 8"),
    ({"case": 4, "minibatch_size": 64}, "item 8"),
    ({"case": 4, "collapse_precision": "ds64"}, "item 9")])
def test_unported_cases_raise_at_construction(kw, item):
    data = SSMData(y=torch.zeros(500, 1), control=torch.zeros(1000, 1))
    with pytest.raises(NotImplementedError, match=item):
        Trainer(FFVDConfig(**kw), data)


def test_sanitize_grads():
    g = [torch.tensor([1.0, float("nan"), float("inf"), -3e7, 2e6])]
    (out,) = sanitize_grads(g, 1e6)
    assert out.tolist() == [1.0, 0.0, 0.0, -1e6, 1e6]
    assert sanitize_grads(g, None)[0] is g[0]


def test_nan_check_raises_with_iteration():
    tr, state = _port(FFVDConfig(dataset="ballbeam", case=4))
    with torch.no_grad():
        state.params.log_q.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="iteration 0"):
        tr.run(state, 3, chunk_size=3)
