"""The LinearK and deep rollouts as one batched recursion, and its step as
the card captures it (``eval/rollout.py::recursion_rollout``,
``_RolloutGraph``).

``recursion_rollout`` runs each step of ``gp_transition`` (after the
hidden layers' ``propagate_step``) once for G groups of R rows under
``torch.func.vmap`` over G: iid samples G=1, R=S; thinned samples G=S,
R=1; chains G=C, R=S; thinned chains G=C×S, R=1.  Its step reads the step
index from a device counter and the draws from static buffers; on the CPU
it runs plainly, which is what the card replays from a CUDA graph.  Held
here, fp64, small models (D=2, M=6, n=20, T=12, S=3):

- against the per-group loop it replaced (one Python recursion per group,
  ``loop_rollout``) at rtol 1e-12, and against the JAX package's
  ``build_collect`` (``ffvd_tpu/eval/rollout.py:44-83,191-237``) with
  JAX's draws rebuilt from its key layout, at the existing tests'
  tolerances (1e-10 iid, 1e-8 thinned): LinearK and deep, iid and thinned;
- through ``multichain_moments`` for LinearK and deep chains, iid and
  thinned, against the per-group loop and JAX's vmapped
  ``multichain_moments`` (``ffvd_tpu/eval/ensemble.py:105-148``);
- its step reads nothing back to the host (``tests/torch_host_guard.py``);
  a trainer keeps its step for the next call of the same shapes;
- ``capture=True`` raises on the CPU and under a gloo mesh whose step
  all-reduces over 'ep'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.eval.ensemble import multichain_moments as j_moments
from ffvd_tpu.eval.rollout import build_collect
from ffvd_tpu.inference.sghmc import _tree_normals
from ffvd_tpu.inference.trainer import SubsetOps as JSubsetOps
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.parallel.sharding import MultiChainTrainer as JMultiChain

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.eval import rollout as er
from ffvd_tpu_torch.eval.ensemble import multichain_moments
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.conditionals import gp_transition
from ffvd_tpu_torch.model.deep import hidden_precals, propagate_step
from ffvd_tpu_torch.model.params import SSMData, params_from_numpy
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.parallel import MultiChainTrainer
from ffvd_tpu_torch.parallel.sharding import member
from tests.test_torch_deep import D, M, by_path, deep_model, jax_deep_params
from tests.test_torch_multichain import stack_leaves
from tests.torch_host_guard import no_host_reads

torch.set_num_threads(2)

S, T, SPACING, C, N = 3, 12, 2, 2, 20
LOOP = dict(rtol=1e-12, atol=1e-14)
CASES = {"LinearK-iid": ("LinearK", 1, 4),
         "LinearK-thinned": ("LinearK", 1, 5),
         "deep-iid": ("SquaredExponential", 2, 4),
         "deep-thinned": ("SquaredExponential", 2, 5)}


def _kw(kernel_type, n_layers, case):
    """A small config; LinearK's Kmm = σ²ZZᵀ has rank Din=3 < M, so its
    jitter sets the conditioning (tests/test_torch_eval_linear.py)."""
    return dict(dataset="flutter", case=case, num_inducing=M, x_dim=D,
                kernel_type=kernel_type, n_layers=n_layers,
                jitter=1e-3 if kernel_type == "LinearK" else 1e-5,
                num_posterior_samples=S, posterior_sample_spacing=SPACING)


@torch.no_grad()
def loop_rollout(tr, p, controls, noise, hidden_noise=()):
    """The recursion of one parameter set as it ran before the batch: a
    Python loop over T steps of ``gp_transition`` for its R rows, one call
    per group of rows."""
    cfg = tr.cfg
    pre = er.rollout_precal(cfg, p)
    u_val, q_sqrt = er.u_and_qsqrt(tr, p, tr.data, pre)
    hpre = hidden_precals(cfg.kernel_type, cfg.jitter, p.hidden)
    x = p.x[-1][None, :].expand(noise.shape[0], -1)
    xs, vs = [], []
    for t in range(controls.shape[0]):
        h = None
        if p.hidden:
            h = propagate_step(cfg.kernel_type, cfg.jitter, p.hidden, hpre,
                               x, controls[t], [e[:, t] for e in hidden_noise])
        x, v = gp_transition(cfg.kernel_type, p.kernel, pre, p.z, u_val,
                             p.q, x, controls[t], noise[:, t], q_sqrt, h_t=h)
        xs.append(x)
        vs.append(v)
    return torch.stack(xs, dim=1), torch.stack(vs, dim=1)


def jax_roll_noise(k_roll, n_hidden):
    """``_rollout_one``'s draws for one sample: head (T, D) and one (T, D)
    per hidden layer (per step ``k, k_prop = split(k)`` in a deep model,
    layer i's normal from ``fold_in(k_prop, i)``)."""
    def per_step(k):
        hid = jnp.zeros((0, D))
        if n_hidden:
            k, k_prop = jax.random.split(k)
            hid = jnp.stack([jax.random.normal(
                jax.random.fold_in(k_prop, i), (1, D), jnp.float64)[0]
                for i in range(n_hidden)])
        return jax.random.normal(k, (D,), jnp.float64), hid
    head, hid = jax.vmap(per_step)(jax.random.split(k_roll, T))
    return head, jnp.moveaxis(hid, 1, 0)


def jax_sample_draws(key, sub, n_hidden, thinned):
    """One chain's per-sample draws from ``key`` (``build_collect``'s
    layout): thinning normals (S, SPACING, ...) per SG-HMC leaf and
    inter-layer normals (S, SPACING, N, D) per hidden layer, then the
    rollout's head (S, T, D) and hidden (S, L-1, T, D) normals."""
    def per_sample(k):
        if not thinned:
            return jax_roll_noise(k, n_hidden)
        k_thin, k_roll = jax.random.split(k)

        def thin(kk):
            prop = jnp.zeros((0, N, D))
            if n_hidden:
                kk, k_prop = jax.random.split(kk)
                prop = jnp.stack([jax.random.normal(
                    jax.random.fold_in(k_prop, i), (N, D), jnp.float64)
                    for i in range(n_hidden)])
            return _tree_normals(kk, sub), prop
        noise, prop = jax.vmap(thin)(jax.random.split(k_thin, SPACING))
        return (noise, prop) + jax_roll_noise(k_roll, n_hidden)
    return jax.jit(jax.vmap(per_sample))(jax.random.split(key, S))


def as_torch(a):
    return torch.tensor(np.asarray(a))


def _thin_inputs(draws, paths, n_hidden, lead=()):
    """The port's ``thin_noise`` (path → lead + (S, SPACING, ...)) and
    ``thin_prop`` (one lead + (S, SPACING, N, D) tensor a hidden layer)."""
    noise, prop = draws[0], draws[1]
    k = len(lead)
    thin_noise = {p: as_torch(a) for p, a in zip(paths, noise)}
    thin_prop = [as_torch(np.take(np.asarray(prop), i, axis=k + 2))
                 for i in range(n_hidden)]
    return thin_noise, thin_prop


def _head_hidden(draws, n_hidden, k):
    """The rollout's head normals and per-layer hidden normals, split from
    a (..., L-1, T, D) array at axis ``k``."""
    head, hid = draws[-2], draws[-1]
    return as_torch(head), [as_torch(np.take(np.asarray(hid), i, axis=k))
                            for i in range(n_hidden)]


@pytest.mark.parametrize("case", list(CASES))
def test_collect_equals_the_per_group_loop_and_jax(case):
    kernel_type, n_layers, c = CASES[case]
    n_hidden, thinned = n_layers - 1, c == 5
    leaves, y, control = deep_model(40, n=N, n_hidden=n_hidden)
    kw = _kw(kernel_type, n_layers, c)
    jtr = JTrainer(JConfig(**kw), JSSMData(y=jnp.asarray(y),
                                           control=jnp.asarray(control)))
    tr = Trainer(FFVDConfig(**kw), SSMData(y=torch.as_tensor(y),
                                           control=torch.as_tensor(control)))
    jstate = jtr.init_state(jax_deep_params(leaves))
    key = jax.random.key(13)
    ops = JSubsetOps(jtr.labels, jstate.params)
    paths = [list(by_path(jstate.params))[i] for i in ops.idx]
    draws = jax_sample_draws(key, ops.split(jstate.params) if thinned
                             else None, n_hidden, thinned)
    jxs, jvs, _ = jax.jit(build_collect(jtr, T, S, SPACING))(
        jstate, key, jtr.data)

    state = tr.init_state(params_from_numpy(leaves))
    head, hidden = _head_hidden(draws, n_hidden, 1)
    thin = (_thin_inputs(draws, paths, n_hidden) if thinned
            else (None, None))
    before = ro.rollout.launches
    xs, vs, moved = er.collect_posterior(
        tr, state, T, num=S, noise=head, hidden_noise=hidden or None,
        thin_noise=thin[0], thin_prop=thin[1])
    assert ro.rollout.launches == before        # the recursion, no kernel
    assert xs.shape == (S, T, D) and tr._rollout_graph.sig[0] is False

    controls = er.rollout_controls(tr.data, T)
    if thinned:
        samples, _ = er.thin_posterior(tr, state, S, SPACING, None, *thin)
        loops = [loop_rollout(tr, p, controls, head[i:i + 1],
                              [e[i:i + 1] for e in hidden])
                 for i, p in enumerate(samples)]
        lx = torch.cat([r[0] for r in loops])
        lv = torch.cat([r[1] for r in loops])
    else:
        lx, lv = loop_rollout(tr, state.params, controls, head, hidden)
    np.testing.assert_allclose(xs.numpy(), lx.numpy(), **LOOP)
    np.testing.assert_allclose(vs.numpy(), lv.numpy(), **LOOP)
    tol = dict(rtol=1e-8 if thinned else 1e-10, atol=1e-12)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **tol)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **tol)
    assert not torch.allclose(xs[0], xs[1])
    if thinned:
        assert not torch.equal(moved.params.kernel.log_variance,
                               state.params.kernel.log_variance)


@pytest.mark.parametrize("case", list(CASES))
def test_chains_equal_the_per_group_loop_and_jax(case):
    kernel_type, n_layers, c = CASES[case]
    n_hidden, thinned = n_layers - 1, c == 5
    base, y, control = deep_model(41, n=N, n_hidden=n_hidden)
    rng = np.random.RandomState(2)
    leaves = stack_leaves([base] * C)
    leaves = {k: v + 1e-3 * rng.randn(*v.shape) for k, v in leaves.items()}
    kw = _kw(kernel_type, n_layers, c)
    jmct = JMultiChain(JConfig(**kw), JSSMData(
        y=jnp.asarray(y), control=jnp.asarray(control)), C)
    jstate = jmct.init_state(jax_deep_params(leaves))
    key = jax.random.key(17)
    jchains, jnew = j_moments(jmct, jstate, T, key)

    params_c = jax.tree.map(lambda a: a[0], jstate.params)
    ops = JSubsetOps(jmct.base.labels, params_c)
    paths = [list(by_path(params_c))[i] for i in ops.idx]
    per = [jax_sample_draws(k, ops.split(params_c) if thinned else None,
                            n_hidden, thinned)
           for k in jax.random.split(key, C)]
    stacked = jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                           *per)
    head, hidden = _head_hidden(stacked, n_hidden, 2)
    thin = (_thin_inputs(stacked, paths, n_hidden, lead=(C,)) if thinned
            else (None, None))

    mct = MultiChainTrainer(FFVDConfig(**kw), SSMData(
        y=torch.as_tensor(y), control=torch.as_tensor(control)), C)
    state = mct.init_state(params_from_numpy(leaves))
    chains, new = multichain_moments(
        mct, state, T, noise=head, hidden_noise=hidden or None,
        thin_noise=thin[0], thin_prop=thin[1])
    g = mct._rollout_graph
    assert g.sig[0] is False and g.xs.shape == ((C * S, 1, T, D) if thinned
                                                else (C, S, T, D))

    controls = er.rollout_controls(mct.data, T)
    if thinned:
        samples, _ = er.thin_posterior(mct, state, S, SPACING, None, *thin)
    for i, ((y_s, v_s, r2), (jy, jv, jr2)) in enumerate(zip(chains,
                                                           jchains)):
        pi = member(new.params, i)
        if thinned:
            loops = [loop_rollout(mct, member(samples[s], i), controls,
                                  head[i, s:s + 1],
                                  [e[i, s:s + 1] for e in hidden])
                     for s in range(S)]
            lx = torch.cat([r[0] for r in loops])
            lv = torch.cat([r[1] for r in loops])
        else:
            lx, lv = loop_rollout(mct, member(state.params, i), controls,
                                  head[i], [e[i] for e in hidden])
        with torch.no_grad():
            ly, lvy = lx @ pi.c + pi.d, lv @ (pi.c * pi.c)
        np.testing.assert_allclose(y_s, ly.numpy(), **LOOP)
        np.testing.assert_allclose(v_s, lvy.numpy(), **LOOP)
        tol = dict(rtol=1e-8 if thinned else 1e-10, atol=1e-12)
        np.testing.assert_allclose(y_s, jy, **tol)
        np.testing.assert_allclose(v_s, jv, **tol)
        np.testing.assert_allclose(r2, jr2, **tol)
    jl = by_path(jnew.params)
    for k, v in new.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jl[k], err_msg=k,
                                   rtol=1e-8, atol=1e-12)
    assert not np.allclose(chains[0][0], chains[1][0])


@pytest.mark.parametrize("grouped", [False, True], ids=["G=1", "G=3"])
@pytest.mark.parametrize("n_layers", [1, 2], ids=["LinearK", "deep"])
def test_the_step_reads_nothing_back(n_layers, grouped):
    kernel_type = "LinearK" if n_layers == 1 else "SquaredExponential"
    leaves, y, control = deep_model(42, n=N, n_hidden=n_layers - 1)
    tr = Trainer(FFVDConfig(**_kw(kernel_type, n_layers, 4)), SSMData(
        y=torch.as_tensor(y), control=torch.as_tensor(control)))
    p = params_from_numpy(leaves)
    g = torch.Generator().manual_seed(0)
    lead = (3, 2) if grouped else (2,)
    noise = torch.randn(lead + (T, D), generator=g, dtype=torch.float64)
    hidden = [torch.randn(noise.shape, generator=g, dtype=torch.float64)
              for _ in p.hidden]
    if grouped:
        p = er.stack_members([p] * 3)
    with no_host_reads():
        xs, vs = er.recursion_rollout(tr, p, er.rollout_controls(tr.data, T),
                                      noise, hidden)
    assert xs.shape == noise.shape and torch.isfinite(xs).all()
    assert (vs > 0).all()
    if grouped:   # equal sets with different draws
        assert not torch.equal(xs[0], xs[1])


def test_a_trainer_keeps_its_step_for_the_same_shapes():
    leaves, y, control = deep_model(43, n=N, n_hidden=1)
    tr = Trainer(FFVDConfig(**_kw("SquaredExponential", 2, 4)), SSMData(
        y=torch.as_tensor(y), control=torch.as_tensor(control)))
    state = tr.init_state(params_from_numpy(leaves))
    run = lambda seed, num=S: er.collect_posterior(
        tr, state, T, num=num, generator=torch.Generator().manual_seed(seed))
    a = run(1)[0]
    g = tr._rollout_graph
    b, c = run(1)[0], run(2)[0]
    assert tr._rollout_graph is g
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.data_ptr() != b.data_ptr()     # each call's own result
    assert run(1, num=S + 1)[0].shape == (S + 1, T, D)
    assert tr._rollout_graph is not g


def test_a_deep_rollout_needs_its_hidden_noise():
    leaves, y, control = deep_model(44, n=N, n_hidden=1)
    tr = Trainer(FFVDConfig(**_kw("SquaredExponential", 2, 4)), SSMData(
        y=torch.as_tensor(y), control=torch.as_tensor(control)))
    with pytest.raises(ValueError, match="hidden layers"):
        er.recursion_rollout(tr, params_from_numpy(leaves),
                             er.rollout_controls(tr.data, T),
                             torch.zeros(S, T, D, dtype=torch.float64))


def test_capture_true_raises_on_the_cpu():
    leaves, y, control = deep_model(45, n=N, n_hidden=0)
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    kw = _kw("LinearK", 1, 4)
    tr = Trainer(FFVDConfig(**kw), data)
    state = tr.init_state(params_from_numpy(leaves))
    with pytest.raises(ValueError, match="CUDA device"):
        er.collect_posterior(tr, state, T, num=S, capture=True,
                             generator=torch.Generator())
    mct = MultiChainTrainer(FFVDConfig(**kw), data, C)
    mstate = mct.init_state(params_from_numpy(stack_leaves([leaves] * C)))
    with pytest.raises(ValueError, match="CUDA device"):
        multichain_moments(mct, mstate, T, num=S, capture=True,
                           generator=torch.Generator())
    assert not hasattr(tr, "_rollout_graph")
    assert not hasattr(mct, "_rollout_graph")


def test_capture_true_raises_under_a_mesh(tmp_path):
    """A meshed trainer's rollout follows its step's capture rule: at world
    size 1 (no collective) ``capture=True`` raises for the CPU only and
    the default runs the recursion plainly; on a gloo mesh that splits the
    dims over 'ep' it refuses with the backend named, on every process."""
    from ffvd_tpu_torch.parallel import make_mesh
    from ffvd_tpu_torch.parallel.distributed import spawn_local
    from ffvd_tpu_torch.parallel.rank_jobs import raise_job
    kw = _kw("SquaredExponential", 2, 4)
    leaves, y, control = deep_model(46, n=N, n_hidden=1)
    stacked = stack_leaves([leaves] * C)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mct = MultiChainTrainer(
            FFVDConfig(**kw),
            SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control)),
            C, mesh=make_mesh(1, x_dim=D))
        state = mct.init_state(params_from_numpy(stacked))
        with pytest.raises(ValueError, match="CUDA device"):
            multichain_moments(mct, state, T, num=S, capture=True,
                               generator=torch.Generator())
        assert not hasattr(mct, "_rollout_graph")
        chains, _ = multichain_moments(mct, state, T, num=S,
                                       generator=torch.Generator())
        assert len(chains) == C and mct._rollout_graph.sig[0] is False
        assert all(np.isfinite(ch[0]).all() for ch in chains)
    finally:
        dist.destroy_process_group()
    spec = dict(cfg=kw, leaves=stacked, y=y, control=control, iters=0,
                mesh=(1, 2), moments=dict(test_len=T, seed=3, capture=True))
    said = spawn_local(raise_job, 2, "gloo", "cpu", args=(spec,),
                       timeout=240, tmpdir=str(tmp_path))
    assert len(said) == 2 and said[0] == said[1]
    assert "'ep' on gloo" in said[0]
