"""Port parity, the LinearK rollout: the torch recursion of
``gp_transition`` (``eval/rollout.py::recursion_rollout``) against the JAX
package's ``_rollout_one`` (``ffvd_tpu/eval/rollout.py:44-83``), fed the
normals JAX draws itself; and LinearK training against the JAX trainer.

- iid (C4): ``collect_posterior`` against JAX ``build_collect``, whose
  samples are ``vmap(_rollout_one)`` over ``split(key, S)``: fp64, rtol
  1e-10.
- per sample (C5 with LinearK): each of S distinct parameter sets and its
  collapsed q(U) through ``recursion_rollout`` against ``_rollout_one`` for
  the same set, rtol 1e-10; and thinned ``collect_posterior`` against
  ``build_collect`` with JAX's thinning draws, rtol 1e-8 as the SE thinned
  test holds it (tests/test_torch_eval_sghmc.py).
- The SE kernel path is chosen by ``cfg.kernel_type`` alone.

Small model: D=2, one control, M=6, n=20; jitter 1e-3, since a LinearK
Kmm = σ²ZZᵀ has rank Din=3 < M and the jitter sets its conditioning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.eval.rollout import _rollout_one, build_collect
from ffvd_tpu.inference.sghmc import _tree_normals
from ffvd_tpu.inference.trainer import SubsetOps as JSubsetOps
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.conditionals import collapsed_u_posterior as j_collapse
from ffvd_tpu.model.conditionals import kernel_precal as j_precal
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.eval.rollout import (collect_posterior,
                                         recursion_rollout, rollout_controls)
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                         init_params_from_warmstart,
                                         params_from_numpy)
from ffvd_tpu_torch.ops import rollout as ro
from tests.test_torch_particle_gibbs import jax_params, small_model

torch.set_num_threads(2)

KT = "LinearK"
S, T, SPACING, D = 3, 15, 2, 2
KW = dict(dataset="ballbeam", kernel_type=KT, num_inducing=6, x_dim=D,
          jitter=1e-3, num_posterior_samples=S,
          posterior_sample_spacing=SPACING)
TOL = dict(rtol=1e-10, atol=1e-13)


def by_path(tree):
    return dict(zip(LEAF_PATHS, map(np.asarray, jax.tree.leaves(tree))))


def _setup(case, seed=0):
    leaves, y, control = small_model(seed, n=20, m=6, d=D)
    jcfg, cfg = JConfig(case=case, **KW), FFVDConfig(case=case, **KW)
    jtr = JTrainer(jcfg, JSSMData(y=jnp.asarray(y),
                                  control=jnp.asarray(control)))
    tr = Trainer(cfg, SSMData(y=torch.as_tensor(y),
                              control=torch.as_tensor(control)))
    return leaves, jtr, tr


def _roll_noise(k_roll):
    """``_rollout_one``'s normals for ``k_roll``: (T, D)."""
    return jax.vmap(lambda kt: jax.random.normal(kt, (D,), jnp.float64))(
        jax.random.split(k_roll, T))


def test_iid_collect_matches_jax():
    leaves, jtr, tr = _setup(4)
    jstate = jtr.init_state(jax_params(leaves))
    key = jax.random.key(8)
    noise = jax.jit(jax.vmap(_roll_noise))(jax.random.split(key, S))
    jxs, jvs, _ = jax.jit(build_collect(jtr, T, S, SPACING))(
        jstate, key, jtr.data)

    state = tr.init_state(params_from_numpy(leaves))
    before = ro.rollout.launches
    xs, vs, out = collect_posterior(tr, state, T, num=S,
                                    noise=torch.tensor(np.asarray(noise)))
    assert ro.rollout.launches == before and out is state
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **TOL)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **TOL)
    assert (vs > 0).all() and not torch.allclose(xs[0], xs[1])


def test_per_sample_recursion_matches_rollout_one():
    """S parameter sets perturbed from one model, each with its collapsed
    q(U) (q_sqrt on): ``recursion_rollout`` per set against ``_rollout_one``."""
    leaves, _, tr = _setup(5)
    rng = np.random.RandomState(3)
    controls = rollout_controls(tr.data, T)
    for s in range(S):
        lv = dict(leaves)
        lv["kernel.log_variance"] = leaves["kernel.log_variance"] \
            + 0.2 * rng.randn(D)
        lv["z"] = leaves["z"] + 0.05 * rng.randn(*leaves["z"].shape)
        lv["log_q"] = leaves["log_q"] + 0.3 * rng.randn(D)
        lv["x"] = leaves["x"] + 0.1 * rng.randn(*leaves["x"].shape)
        jp = jax_params(lv)
        n = jp.n_transitions
        xc = jnp.concatenate([jp.x[:n], jnp.asarray(tr.data.control[:n])],
                             axis=1)
        pre = jax.jit(j_precal, static_argnums=(0, 3))(KT, jp.kernel, jp.z,
                                                       KW["jitter"])
        u_val, q_sqrt = jax.jit(j_collapse, static_argnums=0)(
            KT, jp.kernel, pre, jp.z, jp.x, xc, jp.q)
        key = jax.random.key(20 + s)
        jxs, jvs = jax.jit(_rollout_one, static_argnums=(0, 1))(
            KT, KW["jitter"], jp.kernel, jp.z, u_val, q_sqrt, jp.q,
            jp.x[-1], jnp.asarray(controls.numpy()), key)
        noise = torch.tensor(np.asarray(_roll_noise(key)))[None]
        xs, vs = recursion_rollout(tr, params_from_numpy(lv), controls, noise)
        np.testing.assert_allclose(xs[0].numpy(), np.asarray(jxs), **TOL)
        np.testing.assert_allclose(vs[0].numpy(), np.asarray(jvs), **TOL)


def test_thinned_collect_matches_jax():
    leaves, jtr, tr = _setup(5)
    jstate = jtr.init_state(jax_params(leaves))
    ops = JSubsetOps(jtr.labels, jstate.params)
    paths = [LEAF_PATHS[i] for i in ops.idx]
    sub = ops.split(jstate.params)

    def per_sample(k):
        k_thin, k_roll = jax.random.split(k)
        thin = jax.vmap(lambda kk: _tree_normals(kk, sub))(
            jax.random.split(k_thin, SPACING))
        return thin, _roll_noise(k_roll)
    key = jax.random.key(6)
    thin, roll = jax.jit(jax.vmap(per_sample))(jax.random.split(key, S))
    jxs, jvs, _ = jax.jit(build_collect(jtr, T, S, SPACING))(
        jstate, key, jtr.data)

    state = tr.init_state(params_from_numpy(leaves))
    state = tr.chain_from_numpy(
        state, {f: by_path(getattr(jstate.sghmc, f))
                for f in ("xi", "g", "g2", "p")},
        by_path(jstate.window), int(jstate.window_count))
    xs, vs, _ = collect_posterior(
        tr, state, T, num=S, noise=torch.tensor(np.asarray(roll)),
        thin_noise={p: torch.tensor(np.asarray(a))
                    for p, a in zip(paths, thin)})
    tol = dict(rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **tol)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **tol)


def test_linear_rollout_draws_from_the_generator():
    leaves, _, tr = _setup(4)
    state = tr.init_state(params_from_numpy(leaves))
    a = collect_posterior(tr, state, T, num=S,
                          generator=torch.Generator().manual_seed(1))[0]
    b = collect_posterior(tr, state, T, num=S,
                          generator=torch.Generator().manual_seed(1))[0]
    c = collect_posterior(tr, state, T, num=S,
                          generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (S, T, D) and torch.isfinite(a).all()


def test_linear_kernel_trains_like_jax():
    """The linear kernel ignores its lengthscales: their gradient is zero
    (``jax.grad``), not missing, and Adam leaves them where they are.
    Ballbeam C4 with LinearK, 3 iterations against the JAX trainer."""
    cfg_kw = dict(dataset="ballbeam", case=4, kernel_type=KT)
    ds = j_create_dataset("ballbeam")
    jtr = JTrainer(JConfig(**cfg_kw), JSSMData(
        y=jnp.asarray(ds.y_train), control=jnp.asarray(ds.control)))
    jstate = jtr.init_state(j_init(j_load_warmstart("ballbeam")))
    step = jax.jit(jtr.outer_step)
    jtrace = []
    for k in jax.random.split(jax.random.key(0), 3):
        jstate, nll = step(jstate, k)
        jtrace.append(float(nll))

    tds = create_dataset("ballbeam")
    tr = Trainer(FFVDConfig(**cfg_kw), SSMData(
        y=torch.as_tensor(tds.y_train), control=torch.as_tensor(tds.control)))
    state = tr.init_state(init_params_from_warmstart(
        load_warmstart("ballbeam")))
    ls0 = state.params.kernel.log_lengthscales.clone()
    state, trace = tr.run(state, 3)
    np.testing.assert_allclose(trace.numpy(), jtrace, rtol=1e-9)
    assert torch.equal(state.params.kernel.log_lengthscales, ls0)
    jleaves = by_path(jstate.params)
    for k, v in state.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jleaves[k],
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("kernel_type,uses_kernel",
                         [("SquaredExponential", True), (KT, False)])
def test_path_follows_kernel_type(monkeypatch, kernel_type, uses_kernel):
    """The kernel path is taken for SE and only for SE: a LinearK config
    never calls the kernel's wrapper, an SE config never the recursion."""
    called = []
    monkeypatch.setattr(ro, "rollout",
                        lambda *a, **k: called.append("kernel") or
                        ro.rollout_reference(*a, **k))
    import ffvd_tpu_torch.eval.rollout as ev
    real = ev.recursion_rollout
    monkeypatch.setattr(ev, "recursion_rollout",
                        lambda *a, **k: called.append("linear") or
                        real(*a, **k))
    leaves, _, _ = small_model(0, n=20, m=6, d=D)
    cfg = FFVDConfig(case=4, **dict(KW, kernel_type=kernel_type))
    tr = Trainer(cfg, SSMData(y=torch.randn(20, 1, dtype=torch.float64),
                              control=torch.randn(40, 1,
                                                  dtype=torch.float64)))
    ev.collect_posterior(tr, tr.init_state(params_from_numpy(leaves)), T,
                         num=S, generator=torch.Generator().manual_seed(0))
    assert called == (["kernel"] if uses_kernel else ["linear"])
