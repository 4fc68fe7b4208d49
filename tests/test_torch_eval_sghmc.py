"""Port parity, thinned evaluation: ``collect_posterior`` on the SG-HMC
cases against the JAX package's ``build_collect``.

The JAX trainer runs two outer iterations from the ballbeam warm start;
its params, sampler state and window are carried into the port
(``params_from_numpy``, ``Trainer.chain_from_numpy``).  Both packages then
thin S=2 samples, spacing 3, and roll each out for T=30 steps, with JAX's
own thinning and rollout normals given to the port (per sample k:
``k_thin, k_roll = split(k)``; ``_tree_normals(kk, subset)`` for ``kk`` in
``split(k_thin, spacing)``; ``normal(split(k_roll, T)[t], (D,))``).  xs,
vs and the returned chain agree at rtol 1e-8 (fp64; the port sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.eval.rollout import build_collect
from ffvd_tpu.inference.sghmc import _tree_normals
from ffvd_tpu.inference.trainer import SubsetOps as JSubsetOps
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.cli import main as cli_main
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset
from ffvd_tpu_torch.eval.rollout import collect_posterior, predict_summary
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import LEAF_PATHS, SSMData, params_from_numpy
from ffvd_tpu_torch.ops import rollout as ro

torch.set_num_threads(2)

S, SPACING, T = 2, 3, 30


def by_path(tree):
    return dict(zip(LEAF_PATHS, map(np.asarray, jax.tree.leaves(tree))))


def _jax_draws(key, sub, d):
    """The thinning and rollout normals of ``build_collect`` for ``key``:
    path-ordered lists of (S, SPACING, ...) arrays and (S, T, D)."""
    def per_sample(k):
        k_thin, k_roll = jax.random.split(k)
        thin = jax.vmap(lambda kk: _tree_normals(kk, sub))(
            jax.random.split(k_thin, SPACING))
        roll = jax.vmap(lambda kt: jax.random.normal(kt, (d,), jnp.float64))(
            jax.random.split(k_roll, T))
        return thin, roll
    return jax.jit(jax.vmap(per_sample))(jax.random.split(key, S))


@pytest.mark.parametrize("case", [5, 2])
def test_thinned_collect_matches_jax(case):
    kw = dict(dataset="ballbeam", case=case, num_posterior_samples=S,
              posterior_sample_spacing=SPACING)
    jcfg = JConfig(**kw)
    ds = j_create_dataset("ballbeam")
    jtr = JTrainer(jcfg, JSSMData(y=jnp.asarray(ds.y_train),
                                  control=jnp.asarray(ds.control)))
    jstate = jtr.init_state(j_init(j_load_warmstart("ballbeam")))
    step = jax.jit(jtr.outer_step)
    for k in jax.random.split(jax.random.key(1), 2):
        jstate, _ = step(jstate, k)
    ops = JSubsetOps(jtr.labels, jstate.params)
    paths = [LEAF_PATHS[i] for i in ops.idx]
    key = jax.random.key(5)
    thin, roll = _jax_draws(key, ops.split(jstate.params), 4)
    jxs, jvs, jnew = jax.jit(build_collect(jtr, T, S, SPACING))(
        jstate, key, jtr.data)

    tds = create_dataset("ballbeam")
    tr = Trainer(FFVDConfig(**kw), SSMData(y=torch.as_tensor(tds.y_train),
                                           control=torch.as_tensor(
                                               tds.control)))
    state = tr.init_state(params_from_numpy(by_path(jstate.params)))
    state = tr.chain_from_numpy(
        state, {f: by_path(getattr(jstate.sghmc, f))
                for f in ("xi", "g", "g2", "p")},
        by_path(jstate.window), int(jstate.window_count))
    before = ro.rollout.launches
    xs, vs, new = collect_posterior(
        tr, state, T, num=S, noise=torch.tensor(np.asarray(roll)),
        thin_noise={p: torch.tensor(np.asarray(a))
                    for p, a in zip(paths, thin)})
    assert ro.rollout.launches == before      # CPU: the plain version

    tol = dict(rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **tol)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **tol)
    jparams = by_path(jnew.params)
    for k, v in new.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jparams[k], **tol,
                                   err_msg=k)
    for f in ("xi", "g", "g2", "p"):
        jleaves = by_path(getattr(jnew.sghmc, f))
        for k in paths:
            np.testing.assert_allclose(getattr(new.sghmc, f)[k].numpy(),
                                       jleaves[k], **tol, err_msg=f"{f}.{k}")
    # the chain moved; the window and the Adam leaves did not
    assert not torch.equal(new.params.kernel.log_variance,
                           state.params.kernel.log_variance)
    assert new.window is state.window and new.params.z is state.params.z


def test_model_evaluate_continues_the_chain():
    cfg = FFVDConfig(dataset="ballbeam", case=5, posterior_sample_spacing=2)
    m = FFVDModel(cfg, device="cpu").fit(3)
    assert m.state.window_count == 3
    lv_fit = m.params.kernel.log_variance.clone()
    res = m.evaluate(num_samples=2)
    assert np.isfinite(res["rmse"]) and np.isfinite(res["nll"])
    assert not torch.equal(m.params.kernel.log_variance, lv_fit)
    # the second evaluate() starts from the chain the first one left
    moved = m.state
    gen = torch.Generator().manual_seed(4)
    noise = torch.randn(2, m.dataset.n_test, 4, generator=gen,
                        dtype=torch.float64)
    thin = {k: torch.randn((2, 2) + tuple(v.shape), generator=gen,
                           dtype=torch.float64)
            for k, v in m.trainer.subset.split(moved.params).items()}
    res2 = m.evaluate(num_samples=2, noise=noise, thin_noise=thin)
    xs, vs, _ = collect_posterior(m.trainer, moved, m.dataset.n_test, num=2,
                                  noise=noise, thin_noise=thin)
    py, _, _ = predict_summary(m.params, xs, vs, cfg.emission_noise)
    np.testing.assert_array_equal(res2["predict_y"], py.detach().numpy())
    assert m.state is not moved


def test_per_sample_density_and_sample_apis():
    cfg = FFVDConfig(dataset="ballbeam", case=2, posterior_sample_spacing=1,
                     num_posterior_samples=2)
    m = FFVDModel(cfg, device="cpu").fit(1)
    rmses, nlls = m.evaluate_per_sample()
    assert len(rmses) == len(nlls) == 2 and np.all(np.isfinite(rmses))
    dens = m.calculate_density(m.dataset.y_test[:20])
    assert dens.shape == (20, 1) and np.all(np.isfinite(dens))
    ys = m.sample(test_len=15, s=3)
    assert ys.shape == (3, 15, 1) and np.all(np.isfinite(ys))


def test_cli_runs_c2_on_cpu_and_writes_results(tmp_path):
    out = cli_main(["--file_index", "5", "--case_val", "2",
                    "--iterations", "2", "--samples", "2",
                    "--posterior_sample_spacing", "2", "--platform", "cpu",
                    "--results_dir", str(tmp_path)])
    assert np.isfinite(out["rmse"]) and np.isfinite(out["final_elbo"])
    files = list((tmp_path / "ballbeam").glob("C2VFE_result_ballbeam_*"))
    assert len(files) == 1
    with np.load(files[0], allow_pickle=True) as z:
        assert z["ll_seq"].shape == (4,) and str(z["case"]) == "C2"
