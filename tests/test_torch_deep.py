"""Port parity, deep transitions (``model/deep.py``): the objective and
the entry points of a model with hidden layers, against the JAX package.
The rollout's parity is in tests/test_torch_deep_rollout.py, the
trainer's and the particle-Gibbs sweep's in
tests/test_torch_deep_trainer.py; both share the helpers here.

The port cannot reproduce threefry, so each test rebuilds JAX's draws with
JAX's own calls and key layout and injects them:

- ELBO: layer i's normals are ``normal(fold_in(key, i), (N, D))``;
- trainer (``jax_step_draws``): per outer step ``k_sghmc, k_feed, k_pg =
  split(key, 3)``, then ``k_feed, k_win = split(k_feed)``; SG-HMC sub-step
  k draws its noise from ``split(k)[0]`` and its gradient from
  ``k_win = split(k)[1]``; a windowed gradient splits ``k_start, k_prop =
  split(k_win)`` and draws ``randint(k_start, (), 0, N − W + 1)``;
- rollout: per step ``k, k_prop = split(k)``, the head's normal from k, layer
  i's from ``fold_in(k_prop, i)``; thinning sub-step ``kk, k_prop =
  split(kk)``;
- sweep: the step's ``k_prop`` splits into ``(k_prop, k_h)``, layer i's
  particle normals from ``fold_in(k_h, i)``.

Tolerances (fp64): ELBO terms and gradients rtol 1e-12; trainer trace and
leaves rtol 1e-9 over 3 iterations; rollout rtol 1e-10 (iid) and 1e-8
(thinned); sweep identical resampling indices and x at rtol 1e-12.  Small
model: D=2, one control, M=6, N=32-40, one or two hidden layers.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.inference.sghmc import _tree_normals
from ffvd_tpu.inference.trainer import SubsetOps as JSubsetOps
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.elbo import elbo_terms as j_elbo_terms
from ffvd_tpu.model.elbo import negative_elbo as j_negative_elbo
from ffvd_tpu.model.params import HiddenLayerParams as JHidden
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.ops.kernels import KernelParams as JKP

from ffvd_tpu_torch.api import FFVDModel, _warn_deep_usage
from ffvd_tpu_torch.cli import main as cli_main
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
from ffvd_tpu_torch.model.elbo import elbo_terms
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData, count_hidden,
                                         hidden_paths, params_from_numpy)
from tests.test_torch_elbo import port_terms_and_grads
from tests.test_torch_particle_gibbs import jax_params, small_model

torch.set_num_threads(2)

D, M = 2, 6


def deep_model(seed, n=32, n_hidden=1, u_dim=1, m=M, d=D):
    """``small_model``'s leaves plus ``n_hidden`` hidden layers with
    non-zero inducing outputs, so every layer moves its input."""
    leaves, y, control = small_model(seed, n=n, m=m, d=d, u_dim=u_dim)
    rng = np.random.RandomState(seed + 1000)
    for i in range(n_hidden):
        leaves[f"hidden.{i}.u"] = 0.5 * rng.randn(m, d)
        leaves[f"hidden.{i}.z"] = rng.randn(m, d + u_dim)
        leaves[f"hidden.{i}.kernel.log_variance"] = np.log(
            0.3 * rng.rand(d) + 0.1)
        leaves[f"hidden.{i}.kernel.log_lengthscales"] = np.log(
            rng.rand(d, d + u_dim) + 0.7)
    return leaves, y, control


def jax_deep_params(leaves):
    hidden = tuple(JHidden(
        u=jnp.asarray(leaves[f"hidden.{i}.u"]),
        z=jnp.asarray(leaves[f"hidden.{i}.z"]),
        kernel=JKP(jnp.asarray(leaves[f"hidden.{i}.kernel.log_variance"]),
                   jnp.asarray(leaves[f"hidden.{i}.kernel.log_lengthscales"])))
        for i in range(count_hidden(leaves)))
    return dataclasses.replace(jax_params(leaves), hidden=hidden)


def by_path(tree):
    """A JAX GPSSMParams-shaped pytree's leaves, keyed by the port's paths."""
    paths = LEAF_PATHS + hidden_paths(len(tree.hidden))
    return dict(zip(paths, map(np.asarray, jax.tree.leaves(tree))))


def layer_normals(key, n_hidden, shape):
    """``propagate_hidden``'s draws for ``key``: one array per layer."""
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape,
                                         jnp.float64))
            for i in range(n_hidden)]


def jax_step_draws(jtr, key, count, n_hidden, d):
    """The port's ``outer_step`` keywords that reproduce JAX's outer step
    ``jtr.outer_step(state, key)``; ``count`` is the window count after
    this step's snapshot."""
    k_sghmc, k_feed, _ = jax.random.split(key, 3)
    rnd = jtr.window_n is not None or jtr.stochastic
    out, wins = {}, []
    if jtr.has_sghmc:
        keys = jax.random.split(k_sghmc, len(SUBSTEP_FLAGS))
        pairs = jax.vmap(jax.random.split)(keys)           # (21, 2)
        noise_keys = pairs[:, 0] if rnd else keys
        sub0 = JSubsetOps(jtr.labels, jtr._params0).split(jtr._params0)
        paths = [list(by_path(jtr._params0))[i]
                 for i in JSubsetOps(jtr.labels, jtr._params0).idx]
        normals = jax.jit(jax.vmap(lambda k: _tree_normals(k, sub0)))(
            noise_keys)
        out["noise"] = {p: torch.tensor(np.asarray(a))
                        for p, a in zip(paths, normals)}
        if rnd:
            wins += list(pairs[:, 1])
    if jtr.has_adam:
        if rnd:
            k_feed, k_win = jax.random.split(k_feed)
            wins.append(k_win)
        if jtr.has_sghmc:
            out["feed"] = int(jax.random.randint(k_feed, (), 0,
                                                 max(count, 1)))
    if not rnd:
        return out
    n = jtr.data.y.shape[0]
    rows = jtr.window_n or n
    starts, prop = [], [[] for _ in range(n_hidden)]
    for k_win in wins:
        k_prop = k_win
        if jtr.window_n is not None:
            k_start = k_win
            if jtr.stochastic:
                k_start, k_prop = jax.random.split(k_win)
            starts.append(int(jax.random.randint(
                k_start, (), 0, n - jtr.window_n + 1)))
        if jtr.stochastic:
            for i, e in enumerate(layer_normals(k_prop, n_hidden, (rows, d))):
                prop[i].append(e)
    if jtr.window_n is not None:
        out["starts"] = torch.tensor(starts)
    if jtr.stochastic:
        out["prop"] = [torch.tensor(np.stack(p)) for p in prop]
    return out


def jax_trainer_run(kw, leaves, y, control, n_iter, seed=7):
    """n_iter jitted JAX outer steps from ``leaves``, with the port's
    injected draws of each."""
    cfg = JConfig(**kw)
    jtr = JTrainer(cfg, JSSMData(y=jnp.asarray(y),
                                 control=jnp.asarray(control)))
    jtr._params0 = jax_deep_params(leaves)
    state = jtr.init_state(jtr._params0)
    n_hidden, d = len(jtr._params0.hidden), jtr._params0.x_dim
    step = jax.jit(jtr.outer_step)
    draws, nlls = [], []
    for key in jax.random.split(jax.random.key(seed), n_iter):
        count = min(int(state.window_count) + 1, cfg.window_size)
        draws.append(jax_step_draws(jtr, key, count, n_hidden, d))
        state, nll = step(state, key)
        nlls.append(float(nll))
    return state, np.asarray(nlls), draws


def port_trainer_run(kw, leaves, y, control, draws):
    tr = Trainer(FFVDConfig(**kw), SSMData(y=torch.as_tensor(y),
                                           control=torch.as_tensor(control)))
    state = tr.init_state(params_from_numpy(leaves))
    init = {k: v.detach().clone() for k, v in state.params.leaves().items()}
    state, trace = tr.run(state, len(draws), draws=draws)
    return tr, state, trace, init


def assert_trainer_matches(kw, leaves, y, control, n_iter=3):
    jstate, jtrace, draws = jax_trainer_run(kw, leaves, y, control, n_iter)
    tr, state, trace, init = port_trainer_run(kw, leaves, y, control, draws)
    tol = dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(trace.numpy(), jtrace, **tol)
    jleaves = by_path(jstate.params)
    for k, v in state.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jleaves[k],
                                   err_msg=k, **tol)
    for k, label in tr.labels.items():
        moved = not torch.equal(state.params.leaves()[k], init[k])
        assert moved == (label != "frozen"), k
    return tr, state


# -- the objective ---------------------------------------------------------

_j_terms = jax.jit(j_elbo_terms, static_argnames=("u_collapse",))
_j_grad = jax.jit(jax.grad(j_negative_elbo), static_argnames=("u_collapse",))


@pytest.mark.parametrize("u_collapse", [True, False],
                         ids=["collapsed", "uncollapsed"])
@pytest.mark.parametrize("sampled,n_hidden", [(False, 1), (True, 1),
                                              (True, 2)],
                         ids=["means", "sampled", "sampled-L3"])
def test_deep_elbo_terms_and_grads_match_jax(u_collapse, sampled, n_hidden):
    leaves, y, control = deep_model(3, n_hidden=n_hidden)
    n = y.shape[0]
    key = jax.random.key(11) if sampled else None
    eps = ([torch.tensor(e) for e in layer_normals(key, n_hidden, (n, D))]
           if sampled else None)
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    jdata = JSSMData(y=jnp.asarray(y), control=jnp.asarray(control))
    jp = jax_deep_params(leaves)
    terms, grads = port_terms_and_grads(params_from_numpy(leaves), data,
                                        u_collapse=u_collapse, eps=eps)
    jt = _j_terms(jp, jdata, u_collapse=u_collapse, key=key)
    assert set(terms) == set(jt.keys())
    for k in jt:
        np.testing.assert_allclose(terms[k], float(jt[k]), rtol=1e-12,
                                   err_msg=k)
    jg = by_path(_j_grad(jp, jdata, u_collapse=u_collapse, key=key))
    assert list(grads) == list(jg)
    for k in jg:
        scale = np.max(np.abs(jg[k]))
        np.testing.assert_allclose(grads[k], jg[k], rtol=1e-12,
                                   atol=1e-13 * scale, err_msg=k)
        if k.startswith("hidden."):
            assert scale > 0, k   # every hidden leaf enters the objective
    if sampled:                   # the draw moves the objective
        mean_nll = elbo_terms(params_from_numpy(leaves), data,
                              u_collapse=u_collapse)["nll"]
        assert float(mean_nll) != terms["nll"]


def test_propagation_floors_the_variance_before_the_sqrt():
    """A zero conditional variance takes sqrt(1e-16), not sqrt(0): the
    sampled term stays finite and so does its gradient."""
    from ffvd_tpu_torch.model.deep import propagate_hidden
    leaves, _, _ = deep_model(4)
    p = params_from_numpy(leaves)
    z = p.hidden[0].z
    # inputs on the inducing points: Kdiag − ΣA² ≈ jitter-level, ≥ 0 or not
    h = z[:, :D].clone().requires_grad_(True)
    eps = [torch.ones(M, D, dtype=torch.float64)]
    out = propagate_hidden("SquaredExponential", 0.0, p.hidden, h,
                           z[:, D:], eps)
    (g,) = torch.autograd.grad(out.sum(), h)
    assert torch.isfinite(out).all() and torch.isfinite(g).all()


# -- the particle-Gibbs sweep -------------------------------------------------

def jax_deep_pg_draws(key, n, p, d, n_hidden, ancestor):
    """``make_pg_fn``'s draws for a deep model, in the port's layout."""
    def f(key):
        k_init, k_scan, k_choice = jax.random.split(key, 3)

        def per_step(k):
            a, b = jax.random.split(k)
            k_g, k_prop = (a, b) if ancestor else (b, a)
            k_prop, k_h = jax.random.split(k_prop)
            hid = jnp.stack([jax.random.normal(jax.random.fold_in(k_h, i),
                                               (p - 1, d), jnp.float64)
                             for i in range(n_hidden)])
            return (jax.random.normal(k_prop, (p - 1, d), jnp.float64),
                    jax.random.gumbel(k_g, (p - 1, p), jnp.float64), hid)
        normals, gumbels, hidden = jax.vmap(per_step)(
            jax.random.split(k_scan, n))
        final = (jax.random.gumbel(k_choice, (p,), jnp.float64) if ancestor
                 else jax.random.randint(k_choice, (1,), 0, p))
        return {"particles0": jax.random.normal(k_init, (p - 1, d),
                                                jnp.float64),
                "normals": normals, "gumbels": gumbels, "final": final,
                "hidden": hidden}
    return {k: np.asarray(v) for k, v in jax.jit(f)(key).items()}


# -- the entry points ---------------------------------------------------------

def test_ffvd_model_deep_flutter_fits_and_evaluates():
    m = FFVDModel(FFVDConfig("flutter", case=4, n_layers=2,
                             num_posterior_samples=3), device="cpu")
    assert len(m.params.hidden) == 1
    assert torch.equal(m.params.hidden[0].u, torch.zeros_like(m.params.u))
    m.fit(5)
    res = m.evaluate()
    assert np.isfinite(res["rmse"]) and np.isfinite(res["nll"])
    assert torch.isfinite(m.nll_trace).all() and m.nll_trace.shape == (5,)
    assert float(m.params.hidden[0].u.detach().abs().sum()) > 0


def test_deep_usage_warning_matches_jax():
    from ffvd_tpu.api import _warn_deep_usage as j_warn
    for dataset, warns in (("actuator", True), ("ballbeam", True),
                           ("flutter", False), ("drive", False)):
        got = []
        for fn, cfg in ((_warn_deep_usage, FFVDConfig(dataset, n_layers=2)),
                        (j_warn, JConfig(dataset, n_layers=2))):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                fn(cfg)
            got.append([str(x.message) for x in w])
        assert got[0] == got[1] and bool(got[0]) == warns, dataset
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _warn_deep_usage(FFVDConfig("actuator", n_layers=1))
    assert not w


def test_cli_runs_deep_and_saves_hidden_layers(tmp_path):
    out = cli_main(["--file_index", "4", "--case_val", "4", "--n_layers",
                    "2", "--iterations", "2", "--samples", "2",
                    "--platform", "cpu", "--results_dir", str(tmp_path)])
    assert np.isfinite(out["rmse"])
    (path,) = tmp_path.glob("flutter/*.npz")
    with np.load(path, allow_pickle=True) as z:
        assert z["hidden0_U_val"].shape == (100, 4)
        assert z["hidden0_Z_val"].shape == (100, 5)
        assert z["hidden0_k_lengthscales"].shape == (4, 5)
        assert z["hidden0_k_log_variances"].shape == (4,)
        assert "hidden1_U_val" not in z.files
