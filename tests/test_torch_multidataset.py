"""Port parity, the dataset axis: ``parallel/multidataset.py`` against the
JAX package's (``pad_dataset``, ``stack_datasets``, ``_resize_inducing``,
``MultiDatasetTrainer``), and the inducing resize behind
``FFVDModel(num_inducing≠100)``.

- ``_resize_inducing`` draws from ``np.random.RandomState(seed)`` in JAX's
  order: Z and U equal JAX's exactly, shrinking (m=60) and growing
  (m=130).
- ``pad_dataset`` and ``stack_datasets`` equal JAX's exactly on drive and
  gas_furnace (N=250 and 148, padded to 250).
- ``MultiDatasetTrainer`` C4 on those two at M=12 (resized), 5 iterations:
  trace and leaves at rtol 1e-9 (fp64).
- A windowed multidataset run draws every start inside its own dataset's
  real prefix (``tests/test_minibatch.py:171-191``).
- ``FFVDModel(num_inducing=130)``'s first nll equals JAX's at rtol 1e-12.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._C._functorch as functorch

from ffvd_tpu.api import FFVDModel as JFFVDModel
from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init
from ffvd_tpu.parallel import multidataset as jmd

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.eval.rollout import (collect_posterior, predict_summary,
                                         rmse_nll)
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                         init_params_from_warmstart)
from ffvd_tpu_torch.parallel import (MultiDatasetTrainer, pad_dataset,
                                     stack_datasets)
from ffvd_tpu_torch.parallel.multidataset import _resize_inducing
from ffvd_tpu_torch.parallel.sharding import member

torch.set_num_threads(2)

NAMES = ("drive", "gas_furnace")


def by_path(tree):
    return dict(zip(LEAF_PATHS, map(np.asarray, jax.tree.leaves(tree))))


@pytest.fixture(autouse=True)
def fallback_raises():
    functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="There is a performance drop")
        yield
    functorch._set_vmap_fallback_warning_enabled(False)


@pytest.mark.parametrize("m", [60, 130])
def test_resize_inducing_equals_jax(m):
    jp = jmd._resize_inducing(j_init(j_load_warmstart("ballbeam")), m, 4)
    p = _resize_inducing(init_params_from_warmstart(
        load_warmstart("ballbeam")), m, 4)
    assert p.z.shape == (m, 5) and p.u.shape == (m, 4)
    np.testing.assert_array_equal(p.z.numpy(), np.asarray(jp.z))
    np.testing.assert_array_equal(p.u.numpy(), np.asarray(jp.u))


def test_resize_refuses_hidden_layers():
    p = init_params_from_warmstart(load_warmstart("ballbeam"))
    with pytest.raises(ValueError, match="hidden"):
        _resize_inducing(dataclasses.replace(p, hidden=(object(),)), 50, 0)


def test_pad_and_stack_equal_jax():
    jdata, jparams, jlens = jmd.stack_datasets(NAMES, dtype=jnp.float64)
    data, params, lens = stack_datasets(NAMES)
    assert lens == jlens and lens == [250, 148]
    for f in ("y", "control", "mask"):
        np.testing.assert_array_equal(getattr(data, f).numpy(),
                                      np.asarray(getattr(jdata, f)), f)
    jl = by_path(jparams)
    for k, v in params.leaves().items():
        np.testing.assert_array_equal(v.numpy(), jl[k], k)
    # padded x rows repeat the last real state; the mask marks real steps
    assert torch.equal(params.x[1, 149:], params.x[1, 148].expand(102, 4))
    assert data.mask[1].sum() == 148 and data.control.shape[1] == 500
    # one dataset alone against JAX's pad_dataset
    ds = create_dataset("gas_furnace")
    jd, jp = jmd.pad_dataset(
        JSSMData(y=jnp.asarray(ds.y_train), control=jnp.asarray(ds.control)),
        j_init(j_load_warmstart("gas_furnace")), 160)
    d, p = pad_dataset(SSMData(y=torch.as_tensor(ds.y_train),
                               control=torch.as_tensor(ds.control)),
                       init_params_from_warmstart(
                           load_warmstart("gas_furnace")), 160)
    for f in ("y", "control", "mask"):
        np.testing.assert_array_equal(getattr(d, f).numpy(),
                                      np.asarray(getattr(jd, f)), f)
    np.testing.assert_array_equal(p.x.numpy(), np.asarray(jp.x))
    with pytest.raises(ValueError, match="n_pad"):
        pad_dataset(d, p, 100)


def test_multidataset_c4_matches_jax():
    jdata, jparams, _ = jmd.stack_datasets(NAMES, dtype=jnp.float64, m=12)
    jcfg = JConfig(dataset="drive", case=4, num_inducing=12)
    jmt = jmd.MultiDatasetTrainer(jcfg, jdata)
    jstate, jtrace = jmt.run(jmt.init_state(jparams), 5, jax.random.key(0),
                             chunk_size=5)

    data, params, _ = stack_datasets(NAMES, m=12)
    mt = MultiDatasetTrainer(FFVDConfig(dataset="drive", case=4,
                                        num_inducing=12), data)
    state, trace = mt.run(mt.init_state(params), 5, chunk_size=2)
    tol = dict(rtol=1e-9, atol=1e-12)
    assert trace.shape == (5, 2)
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), **tol)
    jl = by_path(jstate.params)
    for k, v in state.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jl[k], err_msg=k,
                                   **tol)


def test_windowed_starts_stay_in_each_real_prefix():
    data, params, lens = stack_datasets(NAMES, m=12)
    cfg = FFVDConfig(dataset="drive", case=5, num_inducing=12,
                     minibatch_size=100, window_size=4)
    mt = MultiDatasetTrainer(cfg, data)
    assert mt.window_n == 100
    g = torch.Generator().manual_seed(0)
    starts = torch.cat([mt.grad_draws(22, g, params.x)["starts"]
                        for _ in range(40)], dim=1)
    for i, n in enumerate(lens):
        assert int(starts[i].min()) >= 0
        assert int(starts[i].max()) == n - 100       # reaches the bound
    state, trace = mt.run(mt.init_state(params), 2, generator=g)
    assert trace.shape == (2, 2) and torch.isfinite(trace).all()


def test_evaluate_runs_each_dataset_through_a_single_trainer():
    data, params, lens = stack_datasets(NAMES, m=12)
    cfg = FFVDConfig(dataset="drive", case=4, num_inducing=12,
                     num_posterior_samples=3)
    mt = MultiDatasetTrainer(cfg, data)
    state, _ = mt.run(mt.init_state(params), 2)
    dss = [create_dataset(n) for n in NAMES]
    g = torch.Generator().manual_seed(1)
    noise = [torch.randn(3, ds.n_test, 4, generator=g, dtype=torch.float64)
             for ds in dss]
    res = mt.evaluate(state, dss, lens, noise=noise)
    with torch.no_grad():
        for i, (ds, n) in enumerate(zip(dss, lens)):
            p = member(state.params, i)
            p = dataclasses.replace(p, x=p.x[:n + 1])
            tr = Trainer(cfg, SSMData(y=torch.as_tensor(ds.y_train),
                                      control=torch.as_tensor(ds.control)))
            xs, vs, _ = collect_posterior(tr, tr.init_state(p), ds.n_test,
                                          noise=noise[i])
            py, pv, _ = predict_summary(p, xs, vs)
            rmse, nll = rmse_nll(torch.as_tensor(ds.y_test), py, pv,
                                 ds.y_train_std)
            assert res[ds.name] == {"rmse": float(rmse), "nll": float(nll)}
            assert np.isfinite(res[ds.name]["rmse"])
    mt5 = MultiDatasetTrainer(dataclasses.replace(cfg, case=5), data)
    with pytest.warns(UserWarning, match="restarts the SGHMC"):
        mt5.evaluate(mt5.init_state(params), dss[:1], lens[:1],
                     thin_generator=torch.Generator().manual_seed(0))


def test_num_inducing_130_first_nll_equals_jax():
    jm = JFFVDModel(JConfig(dataset="ballbeam", case=4, num_inducing=130))
    m = FFVDModel(FFVDConfig(dataset="ballbeam", case=4, num_inducing=130),
                  device="cpu")
    assert m.params.z.shape == (130, 5)
    np.testing.assert_array_equal(m.params.z.detach().numpy(),
                                  np.asarray(jm.state.params.z))
    jnll = float(jax.jit(jm.trainer.nll_fn)(jm.state.params, jm.data))
    with torch.no_grad():
        nll = float(m.trainer.nll_fn(m.params, m.data))
    np.testing.assert_allclose(nll, jnll, rtol=1e-12)
    m.fit(2)
    assert torch.isfinite(m.nll_trace).all()
