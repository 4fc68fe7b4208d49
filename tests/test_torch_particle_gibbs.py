"""Port parity, the particle-Gibbs sweep (case C6) against
``ffvd_tpu/inference/particle_gibbs.py::make_pg_fn``.

The port cannot reproduce threefry, so the tests compute the JAX sweep's
own draws with JAX's calls, following its key layout (per sweep
``k_init, k_scan, k_choice = split(key, 3)``, ``keys = split(k_scan, n)``;
per step ``k_prop, k_res = split(k)`` in the reference style and
``k_anc, k_prop = split(k)`` in the ancestor style), and inject them.
``jax.random.categorical`` samples by Gumbel-max, which the first test
checks, so JAX's Gumbels drive the port's ``argmax(logits + G)``.  A spy on
``jax.random.categorical`` records JAX's resampling indices; the port's
must be identical.  fp64, small shapes (n=24-40, D=2, M=6, P=16): x within
rtol 1e-12 and the stats, which are means, equal up to their summation
order (rtol 1e-14).

The Kalman-filter and RTS-smoother oracles are ports of
tests/test_inference.py:294,353, at their sizes and bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.inference.particle_gibbs import make_pg_fn as j_make_pg_fn
from ffvd_tpu.model.params import GPSSMParams as JParams
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.ops.kernels import KernelParams as JKP

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference import particle_gibbs as pg
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.conditionals import kernel_precal
from ffvd_tpu_torch.model.params import LEAF_PATHS, SSMData, params_from_numpy

torch.set_num_threads(2)

STAT_KEYS = ("ref_survival", "unique_frac", "accepted", "dx_mean_abs",
             "dx_frac_moved")


def small_model(seed, n=32, m=6, d=2, u_dim=1, p_obs=1):
    """Numpy leaves keyed by path, y and controls.  With p_obs=2 the
    emission noise is a full lower Cholesky (off-diagonal entry set)."""
    rng = np.random.RandomState(seed)
    din = d + u_dim
    log_rchol = np.diag(np.log(0.2 + 0.3 * rng.rand(p_obs)))
    log_rchol += np.tril(0.1 * rng.randn(p_obs, p_obs), -1)
    leaves = {
        "x": 0.5 * rng.randn(n + 1, d), "u": rng.randn(m, d),
        "z": rng.randn(m, din),
        "kernel.log_variance": np.log(rng.rand(d) + 0.2),
        "kernel.log_lengthscales": np.log(rng.rand(d, din) + 0.5),
        "log_q": np.log(rng.rand(d) * 0.2 + 0.05),
        "c": rng.randn(d, p_obs), "d": rng.randn(p_obs),
        "log_rchol": log_rchol}
    return leaves, rng.randn(n, p_obs), rng.randn(2 * n, u_dim)


def jax_params(leaves):
    a = {k: jnp.asarray(v) for k, v in leaves.items()}
    return JParams(x=a["x"], u=a["u"], z=a["z"],
                   kernel=JKP(a["kernel.log_variance"],
                              a["kernel.log_lengthscales"]),
                   log_q=a["log_q"], c=a["c"], d=a["d"],
                   log_rchol=a["log_rchol"])


def jax_pg_draws(key, n, p, d, ancestor):
    """The draws ``make_pg_fn``'s sweep makes from ``key``, in the port's
    layout (``particle_gibbs.pg_draws``), as numpy."""
    def f(key):
        k_init, k_scan, k_choice = jax.random.split(key, 3)

        def per_step(k):
            a, b = jax.random.split(k)
            k_g, k_prop = (a, b) if ancestor else (b, a)
            return (jax.random.normal(k_prop, (p - 1, d), jnp.float64),
                    jax.random.gumbel(k_g, (p - 1, p), jnp.float64))
        normals, gumbels = jax.vmap(per_step)(jax.random.split(k_scan, n))
        final = (jax.random.gumbel(k_choice, (p,), jnp.float64) if ancestor
                 else jax.random.randint(k_choice, (1,), 0, p))
        return {"particles0": jax.random.normal(k_init, (p - 1, d),
                                                jnp.float64),
                "normals": normals, "gumbels": gumbels, "final": final}
    return {k: np.asarray(v) for k, v in jax.jit(f)(key).items()}


def to_torch_draws(draws, device="cpu"):
    return {k: torch.tensor(v, device=device,
                               dtype=torch.int64 if k == "final"
                               and v.dtype.kind == "i" else torch.float64)
            for k, v in draws.items()}


def jax_categorical_keys(key, n, ancestor):
    """The keys of the sweep's ``jax.random.categorical`` calls, in order:
    one a step, and the ancestor style's final choice."""
    k_init, k_scan, k_choice = jax.random.split(key, 3)
    keys = [jax.random.split(k)[0 if ancestor else 1]
            for k in jax.random.split(k_scan, n)]
    return keys + ([k_choice] if ancestor else [])


@pytest.fixture
def categorical_spy(monkeypatch):
    """Records every ``jax.random.categorical`` result traced afterwards,
    keyed by its key's data."""
    seen = {}
    orig = jax.random.categorical

    def record(kd, idx):
        seen[tuple(np.asarray(kd).ravel().tolist())] = np.asarray(idx)

    def spy(key, logits, *args, **kw):
        idx = orig(key, logits, *args, **kw)
        jax.debug.callback(record, jax.random.key_data(key), idx)
        return idx
    monkeypatch.setattr(jax.random, "categorical", spy)
    return lambda k: seen[tuple(np.asarray(jax.random.key_data(k))
                                .ravel().tolist())]


def _configs(ancestor, d, m, p, **kw):
    kw = dict(dataset="ballbeam", case=6, num_inducing=m, x_dim=d,
              pg_particles=p, pg_ancestor_trace=ancestor, **kw)
    return JConfig(**kw), FFVDConfig(**kw)


def test_categorical_is_gumbel_max():
    """The identity the injection rests on, in the installed JAX."""
    p = 16
    logits = jax.random.normal(jax.random.key(3), (p,), jnp.float64)
    for seed in range(5):
        k = jax.random.key(seed)
        got = jax.random.categorical(k, logits, shape=(p - 1,))
        want = jnp.argmax(logits + jax.random.gumbel(k, (p - 1, p),
                                                     jnp.float64), -1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(
            np.asarray(jax.random.categorical(k, logits)),
            np.asarray(jnp.argmax(logits + jax.random.gumbel(
                k, (p,), jnp.float64))))


@pytest.mark.parametrize("ancestor", [True, False],
                         ids=["ancestor", "reference"])
@pytest.mark.parametrize("u_dim,p_obs,n", [(1, 1, 32), (0, 1, 24),
                                           (1, 2, 40)],
                         ids=["controls", "no-controls", "full-R-P2"])
def test_sweep_matches_jax(categorical_spy, ancestor, u_dim, p_obs, n):
    d, m, p = 2, 6, 16
    leaves, y, control = small_model(11 + n, n=n, m=m, d=d, u_dim=u_dim,
                                     p_obs=p_obs)
    jcfg, cfg = _configs(ancestor, d, m, p)
    key = jax.random.key(100 + n)
    draws = to_torch_draws(jax_pg_draws(key, n, p, d, ancestor))

    jdata = JSSMData(y=jnp.asarray(y), control=jnp.asarray(control))
    jparams, jstats = jax.jit(j_make_pg_fn(jcfg, jdata, with_stats=True))(
        jax_params(leaves), key)
    jax.effects_barrier()
    j_idx = [categorical_spy(k) for k in jax_categorical_keys(key, n,
                                                                 ancestor)]

    params = params_from_numpy(leaves)
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    out, stats = pg.make_pg_fn(cfg, data, with_stats=True)(params,
                                                           draws=draws)
    style = pg.pg_ancestor_style if ancestor else pg.pg_reference_style
    pre = kernel_precal(cfg.kernel_type, params.kernel, params.z, cfg.jitter)
    new_x, _, picks = style(cfg, params, pre, data, draws)

    if ancestor:
        np.testing.assert_array_equal(picks["ancestors"][:, :p - 1].numpy(),
                                      np.stack(j_idx[:n]))
        assert (picks["ancestors"][:, p - 1] == p - 1).all()
        assert int(picks["final"][0]) == int(j_idx[n])
    else:
        np.testing.assert_array_equal(picks["resampled"].numpy(),
                                      np.stack(j_idx))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(jparams.x),
                               rtol=1e-12, atol=1e-14)
    assert torch.equal(new_x, out.x)
    for k in STAT_KEYS:      # means: equal up to their summation order
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-14, err_msg=k)
    # the sweep moved x and nothing else
    assert float(stats["dx_frac_moved"]) > 0
    for k in LEAF_PATHS[1:]:
        assert out.leaves()[k] is params.leaves()[k]


def test_pg_compat_noop_leaves_x_bit_identical():
    leaves, y, control = small_model(2, n=20)
    _, cfg = _configs(False, 2, 6, 16, pg_compat_noop=True)
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    params = params_from_numpy(leaves)
    out, stats = pg.make_pg_fn(cfg, data, with_stats=True)(params)
    assert out is params
    assert float(stats["ref_survival"]) == 1.0
    assert float(stats["accepted"]) == 0.0
    # and through three trainer iterations: x bit-identical, u trained
    tr = Trainer(cfg, data, pg_fn=pg.make_pg_fn(cfg))
    state = tr.init_state(params)
    state, trace = tr.run(state, 3, generator=torch.Generator())
    assert torch.isfinite(trace).all()
    assert torch.equal(state.params.x, params.x)
    assert not torch.equal(state.params.u, params.u)


def test_draws_need_a_generator_and_follow_the_layout():
    leaves, _, _ = small_model(4, n=10)
    params = params_from_numpy(leaves)
    for ancestor in (True, False):
        _, cfg = _configs(ancestor, 2, 6, 8)
        with pytest.raises(ValueError, match="Generator"):
            pg.pg_draws(cfg, params, None)
        dr = pg.pg_draws(cfg, params, torch.Generator().manual_seed(0))
        assert dr["particles0"].shape == (7, 2)
        assert dr["normals"].shape == (10, 7, 2)
        assert dr["gumbels"].shape == (10, 7, 8)
        assert all(v.dtype == torch.float64 for k, v in dr.items()
                   if k != "final" or ancestor)
        if ancestor:
            assert dr["final"].shape == (8,)
        else:
            assert dr["final"].dtype == torch.int64
            assert 0 <= int(dr["final"][0]) < 8


def _random_walk(n, q_var, r_var, p, ancestor):
    """The conditionally linear-Gaussian model of the oracle tests: kernel
    variance → 0, so x_{t+1} = x_t + w, y_t = x_{t+1} + v (D=1, U=0)."""
    rng = np.random.RandomState(9)
    x_true = np.cumsum(np.sqrt(q_var) * rng.randn(n + 1))
    y = x_true[1:, None] + np.sqrt(r_var) * rng.randn(n, 1)
    leaves = {"x": np.zeros((n + 1, 1)), "u": np.zeros((8, 1)),
              "z": rng.randn(8, 1), "kernel.log_variance": np.array([-30.0]),
              "kernel.log_lengthscales": np.zeros((1, 1)),
              "log_q": np.array([np.log(q_var)]), "c": np.ones((1, 1)),
              "d": np.zeros(1),
              "log_rchol": np.array([[0.5 * np.log(r_var)]])}
    cfg = FFVDConfig(dataset="ballbeam", case=6, num_inducing=8, x_dim=1,
                     pg_particles=p, pg_ancestor_trace=ancestor)
    data = SSMData(y=torch.as_tensor(y),
                   control=torch.zeros(2 * n, 0, dtype=torch.float64))
    return params_from_numpy(leaves), data, cfg, y


def _kalman(y, q_var, r_var):
    """Filter means/variances, predictive ones, for x0 ~ N(0, 1)."""
    n = y.shape[0]
    mf, pf = np.zeros(n + 1), np.zeros(n + 1)
    mp, pp_ = np.zeros(n + 1), np.zeros(n + 1)
    mf[0], pf[0] = 0.0, 1.0
    for t in range(n):
        mp[t + 1], pp_[t + 1] = mf[t], pf[t] + q_var
        k_g = pp_[t + 1] / (pp_[t + 1] + r_var)
        mf[t + 1] = mp[t + 1] + k_g * (y[t, 0] - mp[t + 1])
        pf[t + 1] = (1 - k_g) * pp_[t + 1]
    return mf, pf, mp, pp_


def _pg_mean(params, data, cfg, sweeps, seed):
    fn = pg.make_pg_fn(cfg, data)
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([fn(params, gen).x for _ in range(sweeps)]
                       ).mean(dim=0)[:, 0].numpy()


def test_pg_matches_kalman_filter_marginals():
    """Reference-style storage keeps the resampled states, so the stored
    x[t+1] is a draw from the filtering marginal: the mean of 300 sweeps
    (P=128) matches the exact Kalman filter.  Filter std ≈ 0.2, so the
    Monte-Carlo error of the mean is ≈0.013; the bound 0.12 is the JAX
    test's and leaves room for the 1/P draws that keep the zero
    reference."""
    n, q_var, r_var = 24, 0.3, 0.05
    params, data, cfg, y = _random_walk(n, q_var, r_var, 128, False)
    pg_mean = _pg_mean(params, data, cfg, 300, 0)
    means = _kalman(y, q_var, r_var)[0]
    err = np.abs(pg_mean[5:] - means[5:])
    assert err.max() < 0.12, (err.max(), pg_mean[:6], means[:6])


def test_pg_ancestor_trace_matches_rts_smoother():
    """The ancestor-traced sweep draws coherent trajectories from the
    smoothing posterior: over 300 sweeps (P=192; the JAX test takes 400 at
    P=256) its marginal means match the exact RTS smoother within 0.12.
    The smoother's std is at most ≈0.45 (at t=0), so the Monte-Carlo error
    of a mean is ≤0.026 and the bound is ≥4.5 of it.  Fewer particles
    bias the draws towards the zero reference (at P=64 past the bound).
    The smoother differs from the filter at early times, so the test tells
    the two storages apart."""
    n, q_var, r_var = 24, 0.3, 0.05
    params, data, cfg, y = _random_walk(n, q_var, r_var, 192, True)
    pg_mean = _pg_mean(params, data, cfg, 300, 1)
    mf, pf, mp, pp_ = _kalman(y, q_var, r_var)
    ms = mf.copy()
    for t in range(n - 1, -1, -1):
        ms[t] = mf[t] + pf[t] / pp_[t + 1] * (ms[t + 1] - mp[t + 1])
    err = np.abs(pg_mean - ms)
    assert err.max() < 0.12, (err.max(), pg_mean[:5], ms[:5])
    assert np.abs(ms[:5] - mf[:5]).max() > 0.15


def test_sweep_replaces_only_x_and_keeps_it_out_of_autograd():
    leaves, y, control = small_model(5, n=12)
    _, cfg = _configs(True, 2, 6, 8)
    params = params_from_numpy(leaves)
    params = dataclasses.replace(params, u=params.u.requires_grad_(True))
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    out = pg.make_pg_fn(cfg, data)(params, torch.Generator().manual_seed(1))
    assert out.u is params.u and not out.x.requires_grad
    assert out.x.shape == params.x.shape and torch.isfinite(out.x).all()
