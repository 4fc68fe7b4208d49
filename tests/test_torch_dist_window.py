"""Port parity, a windowed objective with the time axis split over 'sp'.

Four gloo processes on the CPU (``parallel.distributed.spawn_local``) run
``parallel/rank_jobs.py``'s sequence and gradient jobs, fp64, at
``small_model``'s sizes with N=15 transitions (rows 4, 4, 4, 3), training
on random windows (``minibatch_size < N``,
``model/elbo.py::windowed_elbo_terms``):

- C2 and C4 against JAX's ``SequenceShardedTrainer(make_seq_mesh(4))``
  with the same windows and draws at rtol 1e-9
  (``ffvd_tpu/parallel/sequence.py:85-116``);
- against the unsharded windowed ``Trainer`` at 1e-10, with windows
  injected that straddle a row boundary or lie inside one process's rows,
  and with windows drawn from the generator (C2, deep C4);
- per-leaf gradients of both kinds of window at 1e-12 against the
  unsharded ``autograd.grad``.
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

from ffvd_tpu_torch.parallel.rank_jobs import grads_job, sequence_job
from tests.test_torch_deep import by_path, jax_deep_params, jax_step_draws
from tests.test_torch_dist_sequence import (CPU, KW, assert_same, one_model,
                                            ranks)

torch.set_num_threads(2)

# Rows of the 4 processes at N=15: [0, 4), [4, 8), [8, 12), [12, 15).
# W=5 at starts 2, 6, 10 crosses a boundary each time; W=3 at starts 4, 8,
# 12 lies inside the rows of processes 1, 2 and 3.
WINDOWS = {"straddle": (5, [2, 6, 10]), "inside": (3, [4, 8, 12])}


@pytest.mark.parametrize("case", [2, 4], ids=["C2", "C4"])
def test_sp_windowed_matches_jax_sequence_sharding(case, tmp_path):
    iters = 3
    kw = dict(KW, case=case, minibatch_size=5)
    leaves, y, control = one_model()
    seq = JSeq(JTrainer(JConfig(**kw), JSSMData(
        y=jnp.asarray(y), control=jnp.asarray(control))), j_make_seq_mesh(4))
    params = jax_deep_params(leaves)
    jtr = seq.trainer
    jtr._params0 = params
    key = jax.random.key(6)
    jstate, jtrace = seq.run(jtr.init_state(params), jtr.data, iters, key,
                             chunk_size=iters)
    keys = jax.random.split(jax.random.split(key)[1], iters)
    draws = [jax_step_draws(jtr, keys[t], min(t + 1, kw["window_size"]), 0,
                            2) for t in range(iters)]
    assert all(len(d["starts"]) for d in draws)
    spec = dict(cfg=kw, leaves=leaves, y=y, control=control, iters=iters,
                draws=draws)
    out = ranks(sequence_job, spec, tmp_path)
    tol = dict(rtol=1e-9, atol=1e-12)
    for r in out:
        np.testing.assert_allclose(r["trace"].numpy(), np.asarray(jtrace),
                                   **tol)
        np.testing.assert_allclose(r["state"]["params.x"].numpy(),
                                   by_path(jstate.params)["x"], **tol)


@pytest.mark.parametrize("where", sorted(WINDOWS))
def test_sp_injected_windows_match_the_unsharded_trainer(where, tmp_path):
    w, starts = WINDOWS[where]
    leaves, y, control = one_model()
    spec = dict(cfg=dict(KW, case=4, minibatch_size=w), leaves=leaves, y=y,
                control=control, iters=len(starts),
                draws=[{"starts": torch.tensor([s])} for s in starts])
    single = sequence_job(CPU, spec)
    for r in ranks(sequence_job, spec, tmp_path):
        assert_same(r, single, rtol=1e-10)


@pytest.mark.parametrize("kw,n_hidden", [
    (dict(case=2), 0), (dict(case=4, n_layers=2), 1)], ids=["C2", "deep-C4"])
def test_sp_drawn_windows_match_the_unsharded_trainer(kw, n_hidden,
                                                      tmp_path):
    leaves, y, control = one_model(n_hidden)
    spec = dict(cfg=dict(KW, minibatch_size=5, **kw), leaves=leaves, y=y,
                control=control, iters=3, seed=8)
    single = sequence_job(CPU, spec)
    for r in ranks(sequence_job, spec, tmp_path):
        assert_same(r, single, rtol=1e-10)


@pytest.mark.parametrize("where", sorted(WINDOWS))
def test_sp_windowed_gradients_per_leaf(where, tmp_path):
    w, starts = WINDOWS[where]
    leaves, y, control = one_model()
    spec = dict(cfg=dict(KW, case=4, minibatch_size=w), leaves=leaves, y=y,
                control=control, start=torch.tensor([starts[0]]), axis="sp")
    want = grads_job(CPU, spec)
    for got in ranks(grads_job, spec, tmp_path):
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-14, err_msg=k)
