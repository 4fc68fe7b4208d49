"""Port parity: deep parameters, the latent-dimension adapter, cold starts
and the synthetic datasets.

- ``adapt_warmstart_xdim`` to x_dim 2 and 6 against the JAX function: the
  same ``np.random.RandomState(seed)`` draws in the same order, so every
  leaf is identical.  The one exception is a mean the grown dims are
  filled with (mean log-lengthscale, mean log-variance): XLA sums in its
  own order, which can end one ulp away from torch's (ballbeam's
  lengthscale mean does); those blocks are held to 1 ulp, all else exact.
- ``generate_kink`` / ``generate_linear``: identical arrays.
- The leaf paths of a deep model follow the JAX pytree order, and
  ``params_from_numpy`` / ``params_to_numpy`` carry hidden layers.
- ``init_hidden_layers`` starts as the shallow model: u = 0, so the
  mean-propagated deep objective is the shallow one plus the hidden
  priors, in both packages.
- ``init_params_random``: the JAX function's shapes and constants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.data import synthetic as j_synth
from ffvd_tpu.model import params as jparams

from ffvd_tpu_torch.data import load_warmstart, synthetic
from ffvd_tpu_torch.model import params as tparams
from ffvd_tpu_torch.model.elbo import elbo_terms
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData, hidden_paths,
                                         params_from_numpy, params_to_numpy)

torch.set_num_threads(2)

MEAN_FILLED = ("kernel.log_lengthscales", "kernel.log_variance")


def jax_leaves(params):
    """A JAX GPSSMParams' leaves as numpy, keyed by the port's paths."""
    paths = LEAF_PATHS + hidden_paths(len(params.hidden))
    return dict(zip(paths, map(np.asarray, jax.tree.leaves(params))))


@pytest.mark.parametrize("dataset", ["flutter", "ballbeam"])
@pytest.mark.parametrize("x_dim", [2, 6])
def test_adapt_warmstart_xdim_matches_jax(dataset, x_dim):
    jp = jparams.adapt_warmstart_xdim(
        jparams.init_params_from_warmstart(j_load_warmstart(dataset)), x_dim,
        control_dim=1, seed=3)
    tp = tparams.adapt_warmstart_xdim(
        tparams.init_params_from_warmstart(load_warmstart(dataset)), x_dim,
        control_dim=1, seed=3)
    want, got = jax_leaves(jp), params_to_numpy(tp)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        if dataset == "ballbeam" and k in MEAN_FILLED and x_dim > 4:
            np.testing.assert_array_max_ulp(v, want[k], maxulp=1)
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert tp.x_dim == x_dim and tp.z.shape[1] == x_dim + 1


def test_adapt_warmstart_xdim_identity_and_refuses_deep():
    tp = tparams.init_params_from_warmstart(load_warmstart("flutter"))
    assert tparams.adapt_warmstart_xdim(tp, 4) is tp
    import dataclasses
    deep = dataclasses.replace(tp, hidden=tparams.init_hidden_layers(
        1, tp, generator=torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="hidden"):
        tparams.adapt_warmstart_xdim(deep, 3)


@pytest.mark.parametrize("kw", [dict(n=60, seed=0), dict(n=24, seed=5),
                                dict(n=40, process_noise_std=0.1, x0=-0.3)])
def test_generate_kink_identical(kw):
    a, b = synthetic.generate_kink(**kw), j_synth.generate_kink(**kw)
    for f in ("y_train", "y_test", "control"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.y_train_std, a.y_train_mean) == (b.y_train_std, b.y_train_mean)
    assert a.name == b.name == "kink" and a.n_test == b.n_test
    np.testing.assert_array_equal(synthetic.kink_fn(np.linspace(-2, 2, 9)),
                                  j_synth.kink_fn(np.linspace(-2, 2, 9)))


@pytest.mark.parametrize("kw", [dict(), dict(n=30, x_dim=3, y_dim=2,
                                             r_corr=0.5, seed=4)])
def test_generate_linear_identical(kw):
    (a, ta), (b, tb) = synthetic.generate_linear(**kw), \
        j_synth.generate_linear(**kw)
    for f in ("y_train", "y_test", "control"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert set(ta) == set(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def _deep_pair(n_hidden=2, seed=0):
    """The flutter warm start with ``n_hidden`` hidden layers drawn in the
    port, and the same leaves as a JAX GPSSMParams."""
    import dataclasses
    tp = tparams.init_params_from_warmstart(load_warmstart("flutter"))
    tp = dataclasses.replace(tp, hidden=tparams.init_hidden_layers(
        n_hidden, tp, var_scale=0.25,
        generator=torch.Generator().manual_seed(seed)))
    leaves = params_to_numpy(tp)
    jp = jparams.init_params_from_warmstart(j_load_warmstart("flutter"))
    hidden = tuple(
        jparams.HiddenLayerParams(
            u=jnp.asarray(leaves[f"hidden.{i}.u"]),
            z=jnp.asarray(leaves[f"hidden.{i}.z"]),
            kernel=type(jp.kernel)(
                jnp.asarray(leaves[f"hidden.{i}.kernel.log_variance"]),
                jnp.asarray(leaves[f"hidden.{i}.kernel.log_lengthscales"])))
        for i in range(n_hidden))
    return tp, dataclasses.replace(jp, hidden=hidden), leaves


def test_deep_leaf_paths_follow_the_jax_pytree_and_round_trip():
    tp, jp, leaves = _deep_pair()
    assert list(leaves) == list(LEAF_PATHS + hidden_paths(2))
    want = jax_leaves(jp)
    assert list(want) == list(leaves)
    for k in leaves:
        np.testing.assert_array_equal(leaves[k], want[k], err_msg=k)
    back = params_from_numpy(leaves)
    assert len(back.hidden) == 2
    for k, v in back.leaves().items():
        assert torch.equal(v, tp.leaves()[k]), k
    # the log leaves keep "log" in their path (the SG-HMC log clip)
    assert [k for k in leaves if "log" in k and k.startswith("hidden")] == [
        f"hidden.{i}.kernel.{f}" for i in range(2)
        for f in ("log_variance", "log_lengthscales")]
    with pytest.raises(KeyError, match="hidden.1.z"):
        params_from_numpy({k: v for k, v in leaves.items()
                           if k != "hidden.1.z"})


def test_init_hidden_layers_starts_as_the_shallow_model():
    tp, jp, _ = _deep_pair(n_hidden=1)
    layer = tp.hidden[0]
    assert torch.equal(layer.u, torch.zeros_like(tp.u))
    dz = (layer.z - tp.z).abs()
    assert 0 < float(dz.max()) < 0.06
    torch.testing.assert_close(layer.kernel.log_variance,
                               tp.kernel.log_variance + np.log(0.25))
    assert torch.equal(layer.kernel.log_lengthscales,
                       tp.kernel.log_lengthscales)
    # the same generator seed gives the same layers
    again = tparams.init_hidden_layers(
        1, tp, var_scale=0.25, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again[0].z, layer.z)
    # u = 0: the mean-propagated deep objective is the shallow one plus
    # the hidden layer's prior, in the port and in JAX
    from ffvd_tpu.data import create_dataset as j_create_dataset
    from ffvd_tpu.model.elbo import elbo_terms as j_elbo_terms
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.model.deep import hidden_priors
    ds = create_dataset("flutter")
    data = SSMData(y=torch.as_tensor(ds.y_train),
                   control=torch.as_tensor(ds.control))
    import dataclasses
    deep = elbo_terms(tp, data)
    shallow = elbo_terms(dataclasses.replace(tp, hidden=()), data)
    n = tp.n_transitions
    prior = hidden_priors("SquaredExponential", "normal", tp.hidden)
    np.testing.assert_allclose(float(deep["nll_part_prior"]),
                               float(shallow["nll_part_prior"] - prior / n),
                               rtol=1e-12)
    for k in ("later_term1", "later_term2", "nll_reg_trace_inverse_Q_B",
              "nll_log_likelihood", "x_t_prior_Q"):
        assert float(deep[k]) == float(shallow[k]), k
    jds = j_create_dataset("flutter")
    jt = jax.jit(j_elbo_terms)(jp, jparams.SSMData(
        y=jnp.asarray(jds.y_train), control=jnp.asarray(jds.control)))
    for k, v in deep.items():
        np.testing.assert_allclose(float(v), float(jt[k]), rtol=1e-12,
                                   err_msg=k)


def test_init_params_random_follows_jax_layout():
    g = torch.Generator().manual_seed(0)
    tp = tparams.init_params_random(30, 3, 7, 2, p=2, generator=g)
    jp = jax.jit(jparams.init_params_random, static_argnums=(1, 2, 3, 4, 5))(
        jax.random.key(0), 30, 3, 7, 2, 2)
    got, want = params_to_numpy(tp), jax_leaves(jp)
    assert list(got) == list(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        if k not in ("x", "z"):          # the only random leaves
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert abs(float(np.std(got["x"])) - 0.1) < 0.04
    again = tparams.init_params_random(
        30, 3, 7, 2, p=2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.z, tp.z) and torch.equal(again.x, tp.x)
