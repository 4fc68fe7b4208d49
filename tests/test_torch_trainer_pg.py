"""Port parity, the C6 trainer: particle Gibbs on x, Adam on the rest,
against the JAX ``Trainer`` with ``make_pg_fn``.

Both start from the ballbeam warm start in fp64 (D=4, M=100, N=500,
P=100).  Per outer iteration JAX splits ``k_sghmc, k_feed, k_pg =
split(key, 3)`` and sweeps with ``k_pg``; the test computes that sweep's
draws with JAX's calls (``jax_pg_draws``) and injects them into
``Trainer.run(draws=[{"pg": ...}])``.  Over 3 iterations the nll trace and
every leaf agree at rtol 1e-9, in both sweep styles.  Then the entry
points: ``FFVDModel`` and the CLI run C6 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.inference.particle_gibbs import make_pg_fn as j_make_pg_fn
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.cli import main as cli_main
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                         init_params_from_warmstart)
from ffvd_tpu_torch.ops import rollout as ro
from tests.test_torch_particle_gibbs import jax_pg_draws, to_torch_draws

torch.set_num_threads(2)

ITERS = 3


def _jax_run(cfg, n_iter):
    """n_iter jitted JAX outer steps, with the sweep draws of each."""
    ds = j_create_dataset(cfg.dataset)
    tr = JTrainer(cfg, JSSMData(y=jnp.asarray(ds.y_train),
                                control=jnp.asarray(ds.control)),
                  pg_fn=j_make_pg_fn(cfg))
    state = tr.init_state(j_init(j_load_warmstart(cfg.dataset)))
    n, d = state.params.n_transitions, state.params.x_dim
    step = jax.jit(tr.outer_step)
    draws, nlls = [], []
    for key in jax.random.split(jax.random.key(3), n_iter):
        _, _, k_pg = jax.random.split(key, 3)
        draws.append({"pg": to_torch_draws(jax_pg_draws(
            k_pg, n, cfg.pg_particles, d, cfg.pg_ancestor_trace))})
        state, nll = step(state, key)
        nlls.append(float(nll))
    return state, np.asarray(nlls), draws


@pytest.mark.parametrize("ancestor", [True, False],
                         ids=["ancestor", "reference"])
def test_c6_trainer_matches_jax(ancestor):
    kw = dict(dataset="ballbeam", case=6, pg_ancestor_trace=ancestor)
    jstate, jtrace, draws = _jax_run(JConfig(**kw), ITERS)

    cfg = FFVDConfig(**kw)
    ds = create_dataset(cfg.dataset)
    data = SSMData(y=torch.as_tensor(ds.y_train),
                   control=torch.as_tensor(ds.control))
    tr = Trainer(cfg, data, pg_fn=make_pg_fn(cfg))
    state = tr.init_state(init_params_from_warmstart(
        load_warmstart(cfg.dataset)))
    x0 = state.params.x.clone()
    assert tr.labels["x"] == "frozen" and not state.params.x.requires_grad
    state, trace = tr.run(state, ITERS, draws=draws)

    tol = dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(trace.numpy(), jtrace, **tol)
    jleaves = dict(zip(LEAF_PATHS, map(np.asarray,
                                       jax.tree.leaves(jstate.params))))
    for k, v in state.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jleaves[k], **tol,
                                   err_msg=k)
    assert not torch.equal(state.params.x, x0)
    assert state.step == ITERS and state.sghmc is None


def test_c6_trainer_needs_a_pg_fn():
    data = SSMData(y=torch.zeros(500, 1), control=torch.zeros(1000, 1))
    with pytest.raises(ValueError, match="particle-Gibbs"):
        Trainer(FFVDConfig(case=6), data)


def test_c6_trainer_needs_a_generator_or_draws():
    cfg = FFVDConfig(dataset="ballbeam", case=6, pg_particles=4)
    ds = create_dataset(cfg.dataset)
    data = SSMData(y=torch.as_tensor(ds.y_train),
                   control=torch.as_tensor(ds.control))
    tr = Trainer(cfg, data, pg_fn=make_pg_fn(cfg))
    state = tr.init_state(init_params_from_warmstart(
        load_warmstart(cfg.dataset)))
    with pytest.raises(ValueError, match="Generator"):
        tr.outer_step(state)


def test_model_fits_and_evaluates_c6_on_cpu():
    cfg = FFVDConfig(dataset="ballbeam", case=6, pg_particles=16,
                     num_posterior_samples=2)
    m = FFVDModel(cfg, device="cpu")
    x0 = m.params.x.clone()
    before = ro.rollout.launches
    res = m.fit(2).evaluate()
    assert ro.rollout.launches == before          # CPU: the plain version
    assert np.isfinite(res["rmse"]) and np.isfinite(res["nll"])
    assert torch.isfinite(m.nll_trace).all() and m.nll_trace.shape == (2,)
    assert not torch.equal(m.params.x, x0)


@pytest.mark.parametrize("flag", [["--pg_ancestor_trace"],
                                  ["--pg_ancestor_trace", "false"]],
                         ids=["ancestor", "reference"])
def test_cli_runs_c6_on_cpu(tmp_path, flag):
    out = cli_main(["--file_index", "5", "--case_val", "6",
                    "--iterations", "1", "--samples", "2",
                    "--pg_particles", "8", "--platform", "cpu",
                    "--results_dir", str(tmp_path)] + flag)
    assert np.isfinite(out["rmse"]) and np.isfinite(out["final_elbo"])
    files = list((tmp_path / "ballbeam").glob("C6VFE_result_ballbeam_*"))
    assert len(files) == 1
    with np.load(files[0], allow_pickle=True) as z:
        assert str(z["case"]) == "C6" and int(z["PG_num"]) == 8
