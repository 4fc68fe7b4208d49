"""Port parity, the deep rollout (``eval/rollout.py::recursion_rollout``
after ``model/deep.py::propagate_step``) against the JAX package's
``_rollout_one`` / ``build_collect``, with JAX's draws rebuilt from its key
layout and injected: per step ``k, k_prop = split(k)``, the head's normal
from k, layer i's from ``fold_in(k_prop, i)``; thinning sub-step
``kk, k_prop = split(kk)``.  fp64, rtol 1e-10 (iid) and 1e-8 (thinned).
The helpers and the small model are tests/test_torch_deep.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.eval.rollout import build_collect
from ffvd_tpu.inference.sghmc import _tree_normals
from ffvd_tpu.inference.trainer import SubsetOps as JSubsetOps
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.eval.rollout import collect_posterior
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import SSMData, params_from_numpy
from ffvd_tpu_torch.ops import rollout as ro
from tests.test_torch_deep import D, M, by_path, deep_model, jax_deep_params

torch.set_num_threads(2)

S, T, SPACING = 3, 12, 2


def jax_roll_noise(k_roll, n_hidden):
    """``_rollout_one``'s draws for one sample: head (T, D) and one (T, D)
    per hidden layer."""
    def per_step(k):
        k, k_prop = jax.random.split(k)
        return (jax.random.normal(k, (D,), jnp.float64),
                jnp.stack([jax.random.normal(jax.random.fold_in(k_prop, i),
                                             (1, D), jnp.float64)[0]
                           for i in range(n_hidden)]))
    head, hid = jax.vmap(per_step)(jax.random.split(k_roll, T))
    return head, jnp.moveaxis(hid, 1, 0)          # (T, D), (L-1, T, D)


def _trainers(case, leaves, y, control, **kw):
    kw = dict(dataset="flutter", case=case, num_inducing=M, x_dim=D,
              n_layers=2, num_posterior_samples=S,
              posterior_sample_spacing=SPACING, **kw)
    jtr = JTrainer(JConfig(**kw), JSSMData(y=jnp.asarray(y),
                                           control=jnp.asarray(control)))
    tr = Trainer(FFVDConfig(**kw), SSMData(y=torch.as_tensor(y),
                                           control=torch.as_tensor(control)))
    return jtr, tr


@pytest.mark.parametrize("case", [4, 1])
def test_deep_iid_rollout_matches_jax(case):
    leaves, y, control = deep_model(7)
    jtr, tr = _trainers(case, leaves, y, control)
    jstate = jtr.init_state(jax_deep_params(leaves))
    key = jax.random.key(9)
    head, hid = jax.jit(jax.vmap(lambda k: jax_roll_noise(k, 1)))(
        jax.random.split(key, S))
    jxs, jvs, _ = jax.jit(build_collect(jtr, T, S, SPACING))(
        jstate, key, jtr.data)
    state = tr.init_state(params_from_numpy(leaves))
    before = ro.rollout.launches
    xs, vs, _ = collect_posterior(
        tr, state, T, num=S, noise=torch.tensor(np.asarray(head)),
        hidden_noise=list(torch.tensor(np.asarray(hid)).unbind(1)))
    assert ro.rollout.launches == before          # the recursion, no kernel
    tol = dict(rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **tol)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **tol)
    assert not torch.allclose(xs[0], xs[1])


def test_deep_thinned_rollout_matches_jax():
    """C5, deep: thinning draws a propagation normal per sub-step."""
    leaves, y, control = deep_model(8)
    n = y.shape[0]
    jtr, tr = _trainers(5, leaves, y, control)
    jstate = jtr.init_state(jax_deep_params(leaves))
    ops = JSubsetOps(jtr.labels, jstate.params)
    paths = [list(by_path(jstate.params))[i] for i in ops.idx]
    sub = ops.split(jstate.params)

    def per_sample(k):
        k_thin, k_roll = jax.random.split(k)

        def thin(kk):
            kk, k_prop = jax.random.split(kk)
            return (_tree_normals(kk, sub),
                    jax.random.normal(jax.random.fold_in(k_prop, 0), (n, D),
                                      jnp.float64))
        noise, prop = jax.vmap(thin)(jax.random.split(k_thin, SPACING))
        return noise, prop, jax_roll_noise(k_roll, 1)
    key = jax.random.key(12)
    noise, prop, (head, hid) = jax.jit(jax.vmap(per_sample))(
        jax.random.split(key, S))
    jxs, jvs, _ = jax.jit(build_collect(jtr, T, S, SPACING))(
        jstate, key, jtr.data)

    state = tr.init_state(params_from_numpy(leaves))
    xs, vs, moved = collect_posterior(
        tr, state, T, num=S, noise=torch.tensor(np.asarray(head)),
        hidden_noise=list(torch.tensor(np.asarray(hid)).unbind(1)),
        thin_noise={p: torch.tensor(np.asarray(a))
                    for p, a in zip(paths, noise)},
        thin_prop=[torch.tensor(np.asarray(prop))])
    tol = dict(rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **tol)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **tol)
    assert not torch.equal(moved.params.kernel.log_variance,
                           state.params.kernel.log_variance)


def test_deep_rollout_draws_from_the_generator():
    leaves, y, control = deep_model(9)
    _, tr = _trainers(4, leaves, y, control)
    state = tr.init_state(params_from_numpy(leaves))
    run = lambda seed: collect_posterior(
        tr, state, T, num=S, generator=torch.Generator().manual_seed(seed))[0]
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (S, T, D) and torch.isfinite(a).all()
