"""The port's own draws against the distributions JAX's draws come from.

Every parity test of the sampler paths injects JAX's draws, so it holds
each step for a given draw but not the port's draw-making: the particle-
Gibbs sweep's Gumbels (``inference/particle_gibbs.py::pg_draws`` /
``_gumbel``), the resampling choice they make, and SG-HMC's normals
(``inference/sghmc.py::tree_normals``, and the momentum noise of an
``sghmc_step`` left to draw its own).  Here they are held, at fixed
seeds, against ``jax.random.gumbel``, ``jax.random.categorical`` and the
variance JAX's ``sghmc_step`` draws with (``ffvd_tpu/inference/
sghmc.py:74-77``), by moments and two-sample tests at n = 10⁵.

Tolerances: a mean within 5 standard errors; a variance within 5
standard errors of the sample variance (σ²·√((κ−1)/n), κ the kurtosis:
3 for a normal, 8.4 for a Gumbel); a two-sample Kolmogorov-Smirnov
statistic under its 0.1% critical value 1.95·√(2/n); a χ² over 16
categories (15 degrees of freedom) under its 0.1% critical value 37.70.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ffvd_tpu.inference import sghmc as jsghmc

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import load_warmstart
from ffvd_tpu_torch.inference import sghmc
from ffvd_tpu_torch.inference.particle_gibbs import pg_draws
from ffvd_tpu_torch.model.params import init_params_from_warmstart

N = 100_000
KS_CRIT = 1.95 * math.sqrt(2.0 / N)
CHI2_CRIT_15 = 37.70
EULER = 0.5772156649015329
GUMBEL_VAR = math.pi ** 2 / 6
GUMBEL_KURT = 5.4 + 3.0
DTYPES = {"fp64": (torch.float64, jnp.float64),
          "fp32": (torch.float32, jnp.float32)}


def _params(dtype):
    return init_params_from_warmstart(load_warmstart("ballbeam"),
                                      dtype=dtype)


def _sweep_gumbels(p, dtype, rows=N, seed=0):
    """Resampling Gumbel rows (P wide) from consecutive sweeps' draws of
    one generator, as a run's generator feeds them."""
    cfg = FFVDConfig(dataset="ballbeam", case=6, pg_particles=p)
    params = _params(dtype)
    g = torch.Generator().manual_seed(seed)
    out, have = [], 0
    while have < rows:
        gum = pg_draws(cfg, params, g)["gumbels"].reshape(-1, p)
        out.append(gum)
        have += gum.shape[0]
    return torch.cat(out)[:rows].numpy().astype(np.float64)


def _moments_close(x, mean, var, kurt):
    n = x.size
    assert abs(x.mean() - mean) < 5 * math.sqrt(var / n), (x.mean(), mean)
    assert abs(x.var() - var) < 5 * var * math.sqrt((kurt - 1) / n), (
        x.var(), var)


@pytest.mark.parametrize("name", DTYPES)
def test_pg_gumbels_match_jax_gumbel(name):
    """``pg_draws``' Gumbels: mean γ, variance π²/6, and the same
    distribution as ``jax.random.gumbel`` (two-sample KS)."""
    tdt, jdt = DTYPES[name]
    ours = _sweep_gumbels(100, tdt).reshape(-1)[:N]
    theirs = np.asarray(jax.random.gumbel(jax.random.key(1), (N,), jdt),
                        np.float64)
    _moments_close(ours, EULER, GUMBEL_VAR, GUMBEL_KURT)
    _moments_close(theirs, EULER, GUMBEL_VAR, GUMBEL_KURT)
    assert stats.ks_2samp(ours, theirs).statistic < KS_CRIT
    assert np.all(np.isfinite(ours))


def test_consecutive_sweeps_draw_afresh():
    """Two consecutive sweeps of one generator draw uncorrelated Gumbels
    (|r| under 5/√n), and the generator's state advances between them."""
    cfg = FFVDConfig(dataset="ballbeam", case=6, pg_particles=16)
    params = _params(torch.float64)
    g = torch.Generator().manual_seed(3)
    a = pg_draws(cfg, params, g)
    b = pg_draws(cfg, params, g)
    for k in ("particles0", "normals", "gumbels", "final"):
        x, y = a[k].reshape(-1).numpy(), b[k].reshape(-1).numpy()
        r = np.corrcoef(x, y)[0, 1]
        assert abs(r) < 5 / math.sqrt(x.size), (k, r)


def _chi2_gof(counts, probs):
    expected = probs * counts.sum()
    return float(((counts - expected) ** 2 / expected).sum())


def _chi2_two(c1, c2):
    """χ² statistic of homogeneity of two count vectors (equal totals)."""
    tot = c1 + c2
    keep = tot > 0
    e1 = tot * c1.sum() / (c1.sum() + c2.sum())
    e2 = tot * c2.sum() / (c1.sum() + c2.sum())
    return float((((c1 - e1) ** 2 / e1) + ((c2 - e2) ** 2 / e2))[keep].sum())


@pytest.mark.parametrize("name", DTYPES)
def test_gumbel_max_choice_matches_softmax_and_jax_categorical(name):
    """argmax(logits + G) with ``pg_draws``' Gumbels at P=16: its
    frequencies against softmax(logits) (χ², 15 dof) and against
    ``jax.random.categorical``'s on the same logits (χ² of homogeneity)."""
    tdt, jdt = DTYPES[name]
    p = 16
    logits = np.random.default_rng(5).normal(0.0, 1.5, p)
    gum = _sweep_gumbels(p, tdt, seed=11)
    lg = torch.as_tensor(logits, dtype=tdt)
    ours = torch.argmax(lg + torch.as_tensor(gum, dtype=tdt), dim=1).numpy()
    theirs = np.asarray(jax.random.categorical(
        jax.random.key(2), jnp.asarray(logits, jdt), shape=(N,)))
    c_ours = np.bincount(ours, minlength=p).astype(np.float64)
    c_theirs = np.bincount(theirs, minlength=p).astype(np.float64)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    assert _chi2_gof(c_ours, probs) < CHI2_CRIT_15
    assert _chi2_gof(c_theirs, probs) < CHI2_CRIT_15
    assert _chi2_two(c_ours, c_theirs) < CHI2_CRIT_15


@pytest.mark.parametrize("name", DTYPES)
def test_tree_normals_match_jax_normal(name):
    """``tree_normals``: standard normal leaves (mean 0, variance 1, KS
    against ``jax.random.normal``), and a ``lead`` axis of sub-steps
    draws each sub-step afresh."""
    tdt, jdt = DTYPES[name]
    leaves = {"u": torch.zeros(1000, 4, dtype=tdt),
              "kernel.log_variance": torch.zeros(4, dtype=tdt)}
    g = torch.Generator().manual_seed(4)
    draws = sghmc.tree_normals(leaves, g, lead=(25,))
    assert {k: tuple(v.shape) for k, v in draws.items()} == {
        "u": (25, 1000, 4), "kernel.log_variance": (25, 4)}
    assert all(v.dtype == tdt for v in draws.values())
    ours = draws["u"].reshape(-1).numpy().astype(np.float64)[:N]
    theirs = np.asarray(jax.random.normal(jax.random.key(4), (N,), jdt),
                        np.float64)
    _moments_close(ours, 0.0, 1.0, 3.0)
    assert stats.ks_2samp(ours, theirs).statistic < KS_CRIT
    sub = draws["u"].reshape(25, -1).numpy()
    assert abs(np.corrcoef(sub[0], sub[1])[0, 1]) < 5 / math.sqrt(4000)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("burn_in", [False, True])
def test_sghmc_step_noise_has_jax_variance(name, burn_in):
    """One ``sghmc_step`` that draws its own noise, at zero gradient and
    zero momentum, moves θ by N(0, σ²) per element; σ is JAX's
    (``_leaf_update`` with the noise set to 1 returns σ itself).  Its
    standardised moves have mean 0 and variance 1 (5 standard errors)
    and JAX's un-injected step's alike; the two pass a KS test."""
    tdt, jdt = DTYPES[name]
    rng = np.random.default_rng(9)
    shape = (N // 4, 4)
    g2 = rng.uniform(1e-4, 4.0, shape)
    kw = dict(epsilon=0.05, mdecay=0.05, x_n=501, burn_in=burn_in,
              p_clip=None, spike_clip=None)
    zero = np.zeros(shape)
    st = {"xi": np.ones(shape), "g": np.ones(shape), "g2": g2, "p": zero}

    sigma = np.asarray(jsghmc._leaf_update(
        jnp.asarray(zero, jdt), jnp.asarray(zero, jdt),
        *(jnp.asarray(st[k], jdt) for k in ("xi", "g", "g2", "p")),
        jnp.ones(shape, jdt), **kw)[4], np.float64)

    t = lambda a: {"u": torch.as_tensor(a, dtype=tdt)}
    new, _ = sghmc.sghmc_step(
        t(zero), t(zero), sghmc.SGHMCState(**{k: t(v) for k, v in st.items()}),
        generator=torch.Generator().manual_seed(12), **kw)
    ours = (new["u"].numpy().astype(np.float64) / sigma).reshape(-1)

    jt = lambda a: {"u": jnp.asarray(a, jdt)}
    jnew, _ = jsghmc.sghmc_step(
        jt(zero), jt(zero),
        jsghmc.SGHMCState(**{k: jt(v) for k, v in st.items()}),
        jax.random.key(13), **kw)
    theirs = (np.asarray(jnew["u"], np.float64) / sigma).reshape(-1)

    _moments_close(ours, 0.0, 1.0, 3.0)
    _moments_close(theirs, 0.0, 1.0, 3.0)
    assert stats.ks_2samp(ours, theirs).statistic < KS_CRIT


def test_trainer_sampler_normals_are_tree_normals():
    """The trainer's 21 sub-steps' normals of an outer iteration are one
    ``tree_normals`` call with a lead of 21 on the run's generator."""
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
    from ffvd_tpu_torch.model.params import SSMData
    cfg = FFVDConfig(dataset="ballbeam", case=2)
    ds = create_dataset("ballbeam")
    tr = Trainer(cfg, SSMData(y=torch.as_tensor(ds.y_train),
                              control=torch.as_tensor(ds.control)))
    sub = tr.subset.split(_params(torch.float64))
    a = tr._sampler_normals(sub, torch.Generator().manual_seed(21),
                            len(SUBSTEP_FLAGS))
    b = sghmc.tree_normals(sub, torch.Generator().manual_seed(21),
                           lead=(len(SUBSTEP_FLAGS),))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sweep_with_its_own_draws_matches_jax_sweep():
    """The whole sweep, each package drawing its own random numbers: 100
    ancestor-traced sweeps (drive, P=16) from the warm start by the port's
    ``make_pg_fn`` on one generator and by JAX's on split keys.  The new
    trajectory's last state, its mean, how far it moved, and the mixing
    diagnostics have the same distribution (two-sample KS under its 0.1%
    critical value at n = 100 each, 1.95·√(2/100))."""
    from ffvd_tpu.config import FFVDConfig as JConfig
    from ffvd_tpu.inference.particle_gibbs import make_pg_fn as j_make_pg_fn
    from ffvd_tpu.model.params import SSMData as JSSMData
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.model.params import SSMData, params_to_numpy
    from tests.test_torch_particle_gibbs import jax_params
    k, p = 100, 16
    ds = create_dataset("drive")
    params = init_params_from_warmstart(load_warmstart("drive"))
    x0 = params.x.numpy()
    fn = make_pg_fn(FFVDConfig(dataset="drive", case=6, pg_particles=p),
                    with_stats=True)
    data = SSMData(y=torch.as_tensor(ds.y_train),
                   control=torch.as_tensor(ds.control))
    g = torch.Generator().manual_seed(17)
    ours = [fn(params, g, data) for _ in range(k)]
    jfn = jax.jit(j_make_pg_fn(JConfig(dataset="drive", case=6,
                                       pg_particles=p), with_stats=True))
    jp = jax_params(params_to_numpy(params))
    jdata = JSSMData(y=jnp.asarray(ds.y_train),
                     control=jnp.asarray(ds.control))
    theirs = [jfn(jp, key, jdata)
              for key in jax.random.split(jax.random.key(18), k)]

    def features(runs):
        xs = np.stack([np.asarray(r[0].x, np.float64) for r in runs])
        out = {"x_last": xs[:, -1, 0], "x_mean": xs.mean(axis=(1, 2)),
               "moved": np.abs(xs - x0).mean(axis=(1, 2))}
        for name in ("ref_survival", "unique_frac", "dx_frac_moved"):
            out[name] = np.array([float(r[1][name]) for r in runs])
        return out

    a, b = features(ours), features(theirs)
    crit = 1.95 * math.sqrt(2.0 / k)
    for name in a:
        assert np.all(np.isfinite(a[name])), name
        assert stats.ks_2samp(a[name], b[name]).statistic < crit, (
            name, a[name].mean(), b[name].mean())


def test_sampler_iteration_with_its_own_draws_matches_jax():
    """One C2 outer iteration (21 SG-HMC sub-steps, the window feed, Adam)
    from the ballbeam warm start, 40 times with each package's own draws:
    the sampled leaves (u and the kernel hypers) spread and centre alike.
    Per element, the sd ratio port/JAX (median over the elements within
    [0.9, 1.1]; one ratio's sd is ≈0.16 at 40 draws, a median of 424
    about 0.01) and the standardised difference of means
    z = Δmean/√((s₁² + s₂²)/40) (mean of z² in [0.7, 1.4]; its expectation
    is 1, its sd ≈ 0.07 over 424 elements)."""
    from ffvd_tpu.config import FFVDConfig as JConfig
    from ffvd_tpu.data import create_dataset as j_create_dataset
    from ffvd_tpu.data import load_warmstart as j_load_warmstart
    from ffvd_tpu.inference.trainer import Trainer as JTrainer
    from ffvd_tpu.model.params import SSMData as JSSMData
    from ffvd_tpu.model.params import init_params_from_warmstart as j_init
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import SSMData
    from tests.test_torch_trainer_sghmc import by_path
    k, sampled = 40, ("u", "kernel.log_variance", "kernel.log_lengthscales")
    ds = create_dataset("ballbeam")
    tr = Trainer(FFVDConfig(dataset="ballbeam", case=2),
                 SSMData(y=torch.as_tensor(ds.y_train),
                         control=torch.as_tensor(ds.control)))
    g = torch.Generator().manual_seed(5)
    ours = []
    for _ in range(k):
        st, _ = tr.run(tr.init_state(_params(torch.float64)), 1, generator=g)
        ours.append(np.concatenate([st.params.leaves()[n].detach().numpy()
                                    .reshape(-1) for n in sampled]))
    jds = j_create_dataset("ballbeam")
    jtr = JTrainer(JConfig(dataset="ballbeam", case=2),
                   JSSMData(y=jnp.asarray(jds.y_train),
                            control=jnp.asarray(jds.control)))
    j0 = jtr.init_state(j_init(j_load_warmstart("ballbeam")))
    theirs = []
    for key in jax.random.split(jax.random.key(9), k):
        st, _ = jtr.run(j0, 1, key, chunk_size=1)
        leaves = by_path(st.params)
        theirs.append(np.concatenate([np.asarray(leaves[n]).reshape(-1)
                                      for n in sampled]))
    a, b = np.stack(ours), np.stack(theirs)
    sa, sb = a.std(axis=0, ddof=1), b.std(axis=0, ddof=1)
    assert a.shape[1] == 424 and np.all(sa > 0) and np.all(sb > 0)
    assert 0.9 < np.median(sa / sb) < 1.1, np.median(sa / sb)
    z = (a.mean(axis=0) - b.mean(axis=0)) / np.sqrt((sa ** 2 + sb ** 2) / k)
    assert 0.7 < np.mean(z ** 2) < 1.4, np.mean(z ** 2)
