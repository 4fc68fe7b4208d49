"""Port parity: ``collapse_precision="ds64"`` through the objective, the
trainer and the rollout, against the JAX package's native fp64 functions
at the float32-rounded point (what the JAX package's double-single segment
approximates to ≈49 bits; its ds64 trainer and collection are never run
here: jitting them on the CPU takes minutes).

- ``elbo_terms`` and ``windowed_elbo_terms`` (unmasked and masked) with
  ds64: every term within 4e-6·max(|v|, 1) (tests/test_ds_collapse.py:
  244-252), the terms outside the segment at rtol 1e-12; at the full window
  the windowed objective equals ``elbo_terms`` to 1e-10 (:255-257).
- The ds64 C4 and C5 trainers (C5 with injected sampler draws): the first
  gradient equals JAX's fp64 gradient, and the port's native fp64 one, at
  the float32-rounded leaves, rtol 1e-5.
- The ds64 C4 rollout with JAX's noise injected, against JAX's native fp64
  ``build_collect`` at the rounded leaves: its factors are float32-rounded
  (2⁻²⁴ relative), so over the 30 metric steps the states hold at rtol
  1e-5, atol 2e-6 (measured 8.4e-7), the variances at rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.eval.rollout import build_collect
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.elbo import elbo_terms as j_elbo_terms
from ffvd_tpu.model.elbo import negative_elbo as j_negative_elbo
from ffvd_tpu.model.elbo import windowed_elbo_terms as j_win_terms
from ffvd_tpu.model.params import SSMData as JSSMData

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.eval.rollout import collect_posterior
from ffvd_tpu_torch.inference import trainer as trainer_mod
from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer, grads_of
from ffvd_tpu_torch.model.elbo import elbo_terms, windowed_elbo_terms
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                         init_params_from_warmstart,
                                         params_from_numpy, params_to_numpy)
from tests.test_torch_elbo import _grad_leaves
from tests.test_torch_particle_gibbs import jax_params, small_model

torch.set_num_threads(2)

COLLAPSED = ("later_term1", "later_term2", "nll_reg_trace_inverse_Q_B",
             "nll")
OUTSIDE = ("nll_log_likelihood", "nll_part_prior", "x_t_prior_Q")

_j_terms = jax.jit(j_elbo_terms)
_j_win = jax.jit(j_win_terms, static_argnames=("window_n",))
_j_grad = jax.jit(jax.grad(j_negative_elbo))


def _rounded(leaves):
    return {k: np.asarray(v, np.float32).astype(np.float64)
            for k, v in leaves.items()}


def _model(mask=False):
    """small_model at the ds test's sizes (D=2, M=12, N=48, one control),
    leaves rounded to float32; both packages' params and data."""
    leaves, y, control = small_model(3, n=48, m=12)
    leaves = _rounded(leaves)
    m = None
    if mask:
        m = np.ones(48)
        m[40:] = 0.0
    data = SSMData(y=torch.tensor(y), control=torch.tensor(control),
                   mask=None if m is None else torch.tensor(m))
    jdata = JSSMData(y=jnp.asarray(y), control=jnp.asarray(control),
                     mask=None if m is None else jnp.asarray(m))
    return params_from_numpy(leaves), data, jax_params(leaves), jdata


def _hold(terms, jterms):
    assert set(terms) == set(jterms)
    for k in COLLAPSED:
        a, b = float(terms[k]), float(jterms[k])
        assert abs(a - b) <= 4e-6 * max(abs(b), 1.0), (k, a, b)
    for k in OUTSIDE:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("mask", [False, True])
def test_elbo_terms_ds64_match_jax_fp64(mask):
    params, data, jp, jdata = _model(mask)
    terms = elbo_terms(params, data, collapse_precision="ds64")
    _hold(terms, _j_terms(jp, jdata))
    assert terms["later_term1"].dtype == torch.float64


@pytest.mark.parametrize("mask,start", [(False, 0), (False, 17), (True, 9)])
def test_windowed_elbo_terms_ds64_match_jax_fp64(mask, start):
    params, data, jp, jdata = _model(mask)
    terms = windowed_elbo_terms(params, data, torch.tensor(start), 20,
                                collapse_precision="ds64")
    _hold(terms, _j_win(jp, jdata, jnp.asarray(start), window_n=20))


def test_full_window_equals_elbo_terms():
    params, data, _, _ = _model()
    full = elbo_terms(params, data, collapse_precision="ds64")["nll"]
    win = windowed_elbo_terms(params, data, 0, 48,
                              collapse_precision="ds64")["nll"]
    assert abs(float(full) - float(win)) <= 1e-10


def _ballbeam(cfg):
    ds = create_dataset("ballbeam")
    data = SSMData(y=torch.as_tensor(ds.y_train),
                   control=torch.as_tensor(ds.control))
    leaves = _rounded(params_to_numpy(init_params_from_warmstart(
        load_warmstart("ballbeam"))))
    jdata = JSSMData(y=jnp.asarray(ds.y_train), control=jnp.asarray(ds.control))
    return Trainer(cfg, data), leaves, jdata


def _reference_grads(tr, leaves, jdata, paths):
    """JAX's and the port's native fp64 gradients at ``leaves``."""
    jg = _grad_leaves(_j_grad(jax_params(leaves), jdata))
    p = params_from_numpy(leaves)
    native = dataclasses.replace(tr.cfg, collapse_precision="native")
    ntr = Trainer(native, tr.data)
    req = {k: v.requires_grad_(True) for k, v in p.leaves().items()
           if k in paths}
    g = grads_of(ntr.train_nll(type(p).from_leaves({**p.leaves(), **req})),
                 list(req.values()))
    return ({k: np.asarray(jg[k]) for k in paths},
            {k: v.detach().numpy() for k, v in zip(req, g)})


def _close(ours, refs):
    for ref in refs:
        for k, v in ours.items():
            scale = float(np.abs(ref[k]).max())
            np.testing.assert_allclose(v, ref[k], rtol=1e-5,
                                       atol=1e-12 * max(scale, 1.0),
                                       err_msg=k)
    # the segment's part passed the float32 casts: not the native gradient
    assert not all(np.array_equal(v, refs[1][k]) for k, v in ours.items())


def test_ds64_c4_first_gradient_is_fp64_at_rounded_leaves():
    tr, leaves, jdata = _ballbeam(FFVDConfig(case=4,
                                             collapse_precision="ds64"))
    assert tr.train_precision == "ds64"
    state = tr.init_state(params_from_numpy(leaves))
    group = state.adam.param_groups[0]["params"]
    paths = [k for k, v in state.params.leaves().items()
             if any(v is p for p in group)]
    tr.outer_step(state)
    ours = {k: p.grad.numpy() for k, p in zip(paths, group)}
    _close(ours, _reference_grads(tr, leaves, jdata, paths))


def test_ds64_c5_first_gradient_is_fp64_at_rounded_leaves(monkeypatch):
    tr, leaves, jdata = _ballbeam(FFVDConfig(case=5,
                                             collapse_precision="ds64"))
    state = tr.init_state(params_from_numpy(leaves))
    seen = []
    orig = trainer_mod.Trainer.subset_grads

    def spy(self, sub, params, *a, **kw):
        out = orig(self, sub, params, *a, **kw)
        seen.append({k: v.numpy() for k, v in out.items()})
        return out
    monkeypatch.setattr(trainer_mod.Trainer, "subset_grads", spy)
    g = torch.Generator().manual_seed(0)
    sub = tr.subset.split(state.params)
    noise = {k: torch.randn((len(SUBSTEP_FLAGS),) + tuple(v.shape),
                            generator=g, dtype=torch.float64)
             for k, v in sub.items()}
    nll = tr.outer_step(state, noise=noise, feed=0)
    assert len(seen) == len(SUBSTEP_FLAGS) and bool(torch.isfinite(nll))
    _close(seen[0], _reference_grads(tr, leaves, jdata, list(sub)))


def _jax_noise(key, num, t_len, d):
    """``build_collect``'s iid rollout normals for ``key``: sample keys
    split(key, num), step keys split(k, T)."""
    def per_sample(k):
        return jax.vmap(lambda kt: jax.random.normal(kt, (d,), jnp.float64))(
            jax.random.split(k, t_len))
    return np.asarray(jax.jit(jax.vmap(per_sample))(
        jax.random.split(key, num)))


def test_ds64_rollout_matches_jax_fp64_at_rounded_leaves():
    num, t_len = 3, 30
    tr, leaves, jdata = _ballbeam(FFVDConfig(case=4,
                                             collapse_precision="ds64"))
    jtr = JTrainer(JConfig(case=4), jdata)
    key = jax.random.key(3)
    jxs, jvs, _ = jax.jit(build_collect(jtr, t_len, num, 32))(
        jtr.init_state(jax_params(leaves)), key, jdata)
    state = tr.init_state(params_from_numpy(leaves))
    xs, vs, _ = collect_posterior(
        tr, state, t_len, num=num,
        noise=torch.tensor(_jax_noise(key, num, t_len, 4)))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), rtol=1e-5)
    assert sorted(state.params.leaves()) == sorted(LEAF_PATHS)
