"""Port parity, the random-window minibatch objective
(``model/elbo.py::windowed_elbo_terms``) against the JAX package.  The
trainer's windowed branches are held in
tests/test_torch_minibatch_trainer.py.

- ``windowed_elbo_terms`` at several starts, masked and unmasked, collapsed
  and uncollapsed, shallow and deep (layer normals ``normal(fold_in(key,
  i), (W, D))``): every term and gradient at rtol 1e-12.  At W = N,
  start 0 it is ``elbo_terms`` bit for bit (the JAX package pins the same
  identity, tests/test_minibatch.py).
- A start on the device gathers its window without a read-back.

Data: the kink benchmark (``generate_kink``, no control) at N=48 and the
small controlled model of tests/test_torch_particle_gibbs.py at N=40.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.model.elbo import windowed_elbo_terms as j_win_terms
from ffvd_tpu.model.elbo import windowed_negative_elbo as j_win_nll
from ffvd_tpu.model.params import SSMData as JSSMData

from ffvd_tpu_torch.data import generate_kink
from ffvd_tpu_torch.model.elbo import (elbo_terms, window_rows,
                                       windowed_elbo_terms)
from ffvd_tpu_torch.model.params import (SSMData, init_params_random,
                                         params_from_numpy, params_to_numpy)
from tests.test_torch_deep import (by_path, deep_model, jax_deep_params,
                                   layer_normals)

torch.set_num_threads(2)

W = 12


def kink_model(n=48, m=8, d=2, n_hidden=0, seed=0):
    """Kink observations (no control) and a perturbed cold start."""
    ds = generate_kink(n=n, seed=seed)
    p = init_params_random(n, d, m, 0, generator=torch.Generator()
                           .manual_seed(seed))
    leaves = params_to_numpy(p)
    rng = np.random.RandomState(seed)
    leaves["u"] = 0.3 * rng.randn(m, d)
    leaves["log_q"] = np.log(0.05 + 0.1 * rng.rand(d))
    if n_hidden:
        deep, _, _ = deep_model(seed, n=n, n_hidden=n_hidden, u_dim=0, m=m,
                                d=d)
        leaves.update({k: v for k, v in deep.items()
                       if k.startswith("hidden.")})
    return leaves, ds.y_train, ds.control


def port_win_terms_and_grads(params, data, start, **kw):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.leaves().items()}
    terms = windowed_elbo_terms(type(params).from_leaves(leaves), data,
                                start, W, **kw)
    grads = torch.autograd.grad(terms["nll"], list(leaves.values()),
                                allow_unused=True)
    return ({k: float(v.detach()) for k, v in terms.items()},
            {k: np.zeros(tuple(v.shape)) if g is None else g.numpy()
             for (k, v), g in zip(leaves.items(), grads)})


_j_terms = jax.jit(j_win_terms, static_argnames=("window_n", "u_collapse"))
_j_grad = jax.jit(jax.grad(j_win_nll),
                  static_argnames=("window_n", "u_collapse"))


@pytest.mark.parametrize("u_collapse", [True, False],
                         ids=["collapsed", "uncollapsed"])
@pytest.mark.parametrize("model,masked,deep", [
    ("kink", False, False), ("controls", False, False),
    ("controls", True, False), ("kink", False, True)],
    ids=["kink", "controls", "controls-masked", "kink-deep"])
def test_windowed_elbo_matches_jax(u_collapse, model, masked, deep):
    if model == "kink":
        leaves, y, control = kink_model(n_hidden=int(deep))
    else:
        leaves, y, control = deep_model(2, n=40, n_hidden=int(deep))
        if not deep:
            leaves = {k: v for k, v in leaves.items()
                      if not k.startswith("hidden.")}
    n, d = y.shape[0], leaves["x"].shape[1]
    mask = None
    if masked:                   # a padded suffix, one start inside it
        mask = np.ones(n)
        mask[n - 7:] = 0.0
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control),
                   mask=None if mask is None else torch.as_tensor(mask))
    jdata = JSSMData(y=jnp.asarray(y), control=jnp.asarray(control),
                     mask=None if mask is None else jnp.asarray(mask))
    params, jp = params_from_numpy(leaves), jax_deep_params(leaves)
    for i, start in enumerate((0, 5, n - W)):
        key = jax.random.key(30 + i) if deep else None
        eps = ([torch.tensor(e) for e in layer_normals(key, 1, (W, d))]
               if deep else None)
        terms, grads = port_win_terms_and_grads(
            params, data, torch.tensor(start), u_collapse=u_collapse,
            eps=eps)
        jt = _j_terms(jp, jdata, jnp.asarray(start), window_n=W,
                      u_collapse=u_collapse, key=key)
        assert set(terms) == set(jt.keys())
        for k in jt:
            np.testing.assert_allclose(terms[k], float(jt[k]), rtol=1e-12,
                                       err_msg=f"{start} {k}")
        jg = by_path(_j_grad(jp, jdata, jnp.asarray(start), window_n=W,
                             u_collapse=u_collapse, key=key))
        for k in jg:
            np.testing.assert_allclose(
                grads[k], jg[k], rtol=1e-12,
                atol=1e-13 * np.max(np.abs(jg[k])), err_msg=f"{start} {k}")
        # the x rows outside the window get no gradient but through x₀'s
        # prior
        rows = np.abs(grads["x"]).sum(axis=1) > 0
        outside = np.ones(n + 1, bool)
        outside[start:start + W + 1] = False
        outside[0] = False
        assert not rows[outside].any()


@pytest.mark.parametrize("masked", [False, True])
def test_full_window_is_the_full_batch_objective(masked):
    leaves, y, control = deep_model(3, n=30, n_hidden=0)
    leaves = {k: v for k, v in leaves.items() if not k.startswith("hidden")}
    mask = None
    if masked:
        mask = torch.ones(30, dtype=torch.float64)
        mask[25:] = 0.0
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control),
                   mask=mask)
    params = params_from_numpy(leaves)
    for u_collapse in (True, False):
        full = elbo_terms(params, data, u_collapse=u_collapse)
        win = windowed_elbo_terms(params, data, 0, 30, u_collapse=u_collapse)
        assert set(full) == set(win)
        for k in full:
            assert torch.equal(full[k], win[k]), k


def test_window_rows_takes_a_device_start():
    t = torch.arange(20.0).reshape(10, 2)
    for start in (0, 3, torch.tensor(3), torch.tensor([6])):
        s = int(start) if not torch.is_tensor(start) else int(start.sum())
        assert torch.equal(window_rows(t, start, 4), t[s:s + 4])
