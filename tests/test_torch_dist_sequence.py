"""Port parity, the time axis split over processes ('sp').

Four gloo processes on the CPU (``parallel.distributed.spawn_local``) run
``parallel/rank_jobs.py``'s sequence jobs, fp64, at ``small_model``'s
sizes with N=15 transitions, which do not divide by 4 (rows 4, 4, 4, 3):

- ``SequenceShardedTrainer`` C2 against JAX's ``SequenceShardedTrainer(
  make_seq_mesh(4))`` with JAX's draws injected, at rtol 1e-9 (trace and
  x; ``tests/test_sharding.py:71-97``);
- C4, deep C4, C6 and C1 against the port's unsharded ``Trainer`` with the
  same generator at rtol 1e-10; ds64 C4 at 1e-6, because the float64
  segment's terms come out rounded to float32, so a last-bit change of a
  reduced sum can move a term by a float32 ulp;
- per-leaf gradients at rtol 1e-12 against the unsharded ``autograd.grad``
  (an all-reduce whose backward sums every process's cotangent counts the
  shared objective W times: this is the test that sees it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.parallel.sequence import SequenceShardedTrainer as JSeq
from ffvd_tpu.parallel.sequence import make_seq_mesh as j_make_seq_mesh

from ffvd_tpu_torch.parallel.distributed import spawn_local
from ffvd_tpu_torch.parallel.rank_jobs import grads_job, sequence_job
from tests.test_torch_deep import (by_path, deep_model, jax_deep_params,
                                   jax_step_draws)

torch.set_num_threads(2)
CPU = torch.device("cpu")
KW = dict(dataset="ballbeam", num_inducing=6, x_dim=2, window_size=4)
N = 15


def ranks(job, spec, tmp_path):
    return spawn_local(job, 4, "gloo", "cpu",
                       args=(dict(spec, mesh=(4,), axis="sp"),),
                       timeout=240, tmpdir=str(tmp_path))


def one_model(n_hidden=0, seed=2):
    return deep_model(seed, n=N, n_hidden=n_hidden)


def assert_same(got, want, rtol, atol=1e-13):
    np.testing.assert_allclose(got["trace"].numpy(), want["trace"].numpy(),
                               rtol=rtol, atol=atol, err_msg="trace")
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_sp_c2_matches_jax_sequence_sharding(tmp_path):
    iters = 4
    leaves, y, control = one_model()
    cfg = JConfig(case=2, **KW)
    seq = JSeq(JTrainer(cfg, JSSMData(y=jnp.asarray(y),
                                      control=jnp.asarray(control))),
               j_make_seq_mesh(4))
    params = jax_deep_params(leaves)
    jtr = seq.trainer
    jtr._params0 = params
    key = jax.random.key(4)
    jstate, jtrace = seq.run(jtr.init_state(params), jtr.data, iters, key,
                             chunk_size=iters)
    # The port's draws of each step: run's one chunk splits key → (key,
    # sub) and sub into the step keys.
    keys = jax.random.split(jax.random.split(key)[1], iters)
    draws = [jax_step_draws(jtr, keys[t], min(t + 1, cfg.window_size), 0, 2)
             for t in range(iters)]
    spec = dict(cfg=dict(case=2, **KW), leaves=leaves, y=y, control=control,
                iters=iters, draws=draws)
    single = sequence_job(CPU, spec)
    out = ranks(sequence_job, spec, tmp_path)
    for r in out:
        assert_same(r, single, rtol=1e-10)
    tol = dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(out[0]["trace"].numpy(), np.asarray(jtrace),
                               **tol)
    jx = by_path(jstate.params)["x"]
    np.testing.assert_allclose(out[0]["state"]["params.x"].numpy(), jx, **tol)


@pytest.mark.parametrize("kw,n_hidden,rtol", [
    (dict(case=4), 0, 1e-10), (dict(case=4, n_layers=2), 1, 1e-10),
    (dict(case=6, pg_particles=5), 0, 1e-10), (dict(case=1), 0, 1e-10),
    (dict(case=4, collapse_precision="ds64"), 0, 1e-6)],
    ids=["C4", "deep-C4", "C6", "C1", "ds64-C4"])
def test_sp_matches_the_unsharded_trainer(kw, n_hidden, rtol, tmp_path):
    leaves, y, control = one_model(n_hidden)
    spec = dict(cfg=dict(KW, **kw), leaves=leaves, y=y, control=control,
                iters=3, seed=5)
    single = sequence_job(CPU, spec)
    for r in ranks(sequence_job, spec, tmp_path):
        assert_same(r, single, rtol=rtol)


@pytest.mark.parametrize("kw,n_hidden", [
    (dict(case=4), 0), (dict(case=1, prior_type="determinantal"), 0),
    (dict(case=4, n_layers=2), 1)], ids=["C4", "C1-determinantal",
                                         "deep-C4"])
def test_sp_gradients_per_leaf(kw, n_hidden, tmp_path):
    leaves, y, control = one_model(n_hidden)
    eps = ([np.random.RandomState(6).randn(N, 2)] if n_hidden else None)
    spec = dict(cfg=dict(KW, **kw), leaves=leaves, y=y, control=control,
                eps=eps, axis="sp")
    want = grads_job(CPU, spec)
    for got in ranks(grads_job, spec, tmp_path):
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-14, err_msg=k)
