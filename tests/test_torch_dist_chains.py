"""Port parity, chains and datasets split over processes ('dp' × 'ep').

Four gloo processes on the CPU (``parallel.distributed.spawn_local``, a
``file://`` store under ``tmp_path``, a deadline on every launch) run the
jobs of ``parallel/rank_jobs.py``, which import no JAX; this process holds
their results against the JAX package and against the port in one process,
fp64, at ``small_model``'s sizes (D=2, M=6, N=20).

- dp=2 × ep=2 ``MultiChainTrainer`` C4 (20 iterations) and C5 (3, JAX's
  draws injected): against JAX's ``MultiChainTrainer(mesh=make_mesh(4,
  ep=2, x_dim=2))`` at rtol 1e-9, against the one-process port at 1e-12;
  then ``multichain_moments``: one plain rollout a dp group, its rows'
  offset, pooled moments at 1e-12;
- ep=4 at x_dim=6 (dims split 2, 2, 1, 1), C2; windows and deep layers
  (their draws cut to the share, the deep rollout's recursion); C6 under
  dp × ep;
- per-leaf gradients of the ep-split objective against the unsharded
  ``autograd.grad`` at rtol 1e-12;
- ``MultiDatasetTrainer`` of drive and gas_furnace on dp=2 × ep=2;
- ``shard_chain_state`` then ``gather_chain_state`` is the state exactly;
- a chain made non-finite: every process raises JAX's message with the
  global chain index.
"""

import jax
import numpy as np
import pytest
import torch

from ffvd_tpu.parallel.sharding import _check_finite as j_check_finite
from ffvd_tpu.parallel.sharding import make_mesh as j_make_mesh

from ffvd_tpu_torch.eval.ensemble import pool_moments
from ffvd_tpu_torch.parallel.distributed import spawn_local
from ffvd_tpu_torch.parallel.rank_jobs import (chains_job, datasets_job,
                                               grads_job, raise_job,
                                               roundtrip_job)
from tests.test_torch_deep import by_path, deep_model
from tests.test_torch_multichain import jax_multichain

torch.set_num_threads(2)
CPU = torch.device("cpu")
KW = dict(dataset="ballbeam", num_inducing=6, window_size=4,
          num_posterior_samples=2, posterior_sample_spacing=2)


def ranks(job, spec, tmp_path, n=4):
    return spawn_local(job, n, "gloo", "cpu", args=(spec,), timeout=240,
                       tmpdir=str(tmp_path))


def stacked(c, d=2, n=20, n_hidden=0, seed=3):
    leaves, y, control = deep_model(seed, n=n, n_hidden=n_hidden, d=d)
    rng = np.random.RandomState(seed + 7)
    return ({k: np.stack([v + 1e-3 * rng.randn(*v.shape) for _ in range(c)])
             for k, v in leaves.items()}, y, control)


def assert_same(got, want, rtol, atol=1e-14):
    """Trace and every state tensor of two job results."""
    np.testing.assert_allclose(got["trace"].numpy(), want["trace"].numpy(),
                               rtol=rtol, atol=atol, err_msg="trace")
    assert set(got["state"]) == set(want["state"])
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def assert_moments(got, want, rtol):
    for a, b in zip(got, want):
        for u, w in zip(a, b):
            np.testing.assert_allclose(u, w, rtol=rtol, atol=1e-14)
    for u, w in zip(pool_moments(got), pool_moments(want)):
        np.testing.assert_allclose(u, w, rtol=rtol, atol=1e-14)


@pytest.mark.parametrize("case,iters", [(4, 20), (5, 3)], ids=["C4", "C5"])
def test_dp_ep_chains_match_jax_mesh_and_one_process(case, iters, tmp_path):
    kw = dict(KW, case=case, x_dim=2)
    leaves, y, control = stacked(4)
    jstate, jtrace, draws = jax_multichain(
        kw, leaves, y, control, iters, mesh=j_make_mesh(4, ep=2, x_dim=2))
    spec = dict(cfg=kw, leaves=leaves, y=y, control=control, iters=iters,
                chunk=iters, draws=draws if case == 5 else None,
                moments=dict(test_len=6, seed=9))
    single = chains_job(CPU, spec)
    out = ranks(chains_job, dict(spec, mesh=(2, 2)), tmp_path)
    for r in out:
        assert_same(r, single, rtol=1e-12)
        assert_moments(r["moments"], single["moments"], rtol=1e-12)
    # One rollout call a dp group, on the first process of its 'ep' group:
    # chains [0, 2) and [2, 4), two samples each.
    assert [r["rollout_calls"] for r in out] == [[(4, 0)], [], [(4, 4)], []]
    assert single["rollout_calls"] == [(8, 0)]
    tol = dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(out[0]["trace"].numpy(), jtrace, **tol)
    state = out[0]["state"]
    for k, v in by_path(jstate.params).items():
        np.testing.assert_allclose(state[f"params.{k}"].numpy(), v,
                                   err_msg=k, **tol)
    for f in ("xi", "g", "g2", "p") if case == 5 else ():
        jf = by_path(getattr(jstate.sghmc, f))
        for k in (s.split(".", 2)[2] for s in state
                  if s.startswith(f"sghmc.{f}.")):
            np.testing.assert_allclose(state[f"sghmc.{f}.{k}"].numpy(),
                                       jf[k], err_msg=f"{f}.{k}", **tol)


def test_uneven_ep_over_six_dims(tmp_path):
    """ep=4 at x_dim=6 (JAX's default mesh there): dims 2, 2, 1, 1; the
    sampler, its window and the thinned moments."""
    kw = dict(KW, case=2, x_dim=6)
    leaves, y, control = stacked(2, d=6)
    spec = dict(cfg=kw, leaves=leaves, y=y, control=control, iters=3,
                moments=dict(test_len=5, seed=4))
    single = chains_job(CPU, spec)
    out = ranks(chains_job, dict(spec, mesh=(1, 4)), tmp_path)
    for r in out:
        assert_same(r, single, rtol=1e-12)
        assert_moments(r["moments"], single["moments"], rtol=1e-12)
    assert [r["rollout_calls"] for r in out] == [[(4, 0)], [], [], []]


@pytest.mark.parametrize("kw,n_hidden", [
    (dict(case=4, minibatch_size=8), 0), (dict(case=5, n_layers=2), 1),
    (dict(case=2, minibatch_size=8, n_layers=2), 1)],
    ids=["window-C4", "deep-C5", "window-deep-C2"])
def test_window_starts_and_layer_normals_cut_to_the_share(kw, n_hidden,
                                                          tmp_path):
    """The draws a gradient evaluation makes (window starts, inter-layer
    normals, the deep rollout's recursion noise) drawn whole and cut to
    each process's chains: the one-process run at 1e-12."""
    leaves, y, control = stacked(4, n_hidden=n_hidden)
    spec = dict(cfg=dict(KW, x_dim=2, **kw), leaves=leaves, y=y,
                control=control, iters=3, moments=dict(test_len=5, seed=2))
    single = chains_job(CPU, spec)
    for r in ranks(chains_job, dict(spec, mesh=(2, 2)), tmp_path):
        assert_same(r, single, rtol=1e-12)
        assert_moments(r["moments"], single["moments"], rtol=1e-12)


def test_particle_gibbs_chains_under_dp_and_ep(tmp_path):
    """C6: each process sweeps its chains with all D dims gathered, every
    chain's sweep draws made in order on every process."""
    kw = dict(KW, case=6, x_dim=2, pg_particles=5)
    leaves, y, control = stacked(4)
    spec = dict(cfg=kw, leaves=leaves, y=y, control=control, iters=3)
    single = chains_job(CPU, spec)
    for r in ranks(chains_job, dict(spec, mesh=(2, 2)), tmp_path):
        assert_same(r, single, rtol=1e-12)


@pytest.mark.parametrize("kw,mesh,n_hidden", [
    (dict(case=4, x_dim=2), (2, 2), 0),
    (dict(case=1, x_dim=2, prior_type="determinantal"), (2, 2), 0),
    (dict(case=4, x_dim=6, prior_type="strauss"), (1, 4), 0),
    (dict(case=4, x_dim=2, n_layers=2), (2, 2), 1)],
    ids=["C4", "C1-determinantal", "C4-ep4-D6", "deep-C4"])
def test_ep_split_gradients_per_leaf(kw, mesh, n_hidden, tmp_path):
    """Every leaf's gradient of the ep-split objective (per-dim parts on
    their processes, the shared part on one, the whole leaves' gradients
    summed over 'ep') is the unsharded ``autograd.grad``'s."""
    d = kw["x_dim"]
    leaves, y, control = stacked(2, d=d, n_hidden=n_hidden)
    eps = None
    if n_hidden:
        g = np.random.RandomState(5)
        eps = [g.randn(2, 20, d)]
    spec = dict(cfg=dict(KW, **kw), leaves=leaves, y=y, control=control,
                eps=eps)
    want = grads_job(CPU, spec)
    for got in ranks(grads_job, dict(spec, mesh=mesh), tmp_path):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-14, err_msg=k)


def test_multidataset_over_dp_and_ep(tmp_path):
    """drive and gas_furnace (N=250 and 148, padded and masked), one a dp
    group, their D=4 GPs over ep=2: the trace, the state and
    ``evaluate()``'s whole dict on every process."""
    spec = dict(cfg=dict(case=4, num_posterior_samples=2),
                names=["drive", "gas_furnace"], iters=3, eval_seed=2)
    single = datasets_job(CPU, spec)
    out = ranks(datasets_job, dict(spec, mesh=(2, 2)), tmp_path)
    for r in out:
        # Adam moves an element whose gradient is near 0 by about its lr
        # whatever the gradient's size, so the order of the 'ep' sums shows
        # there as ~1e-13 absolute on O(1) leaves (M=100, N=250).
        assert_same(r, single, rtol=1e-12, atol=1e-12)
        assert r["results"].keys() == single["results"].keys()
        for name, v in single["results"].items():
            for m in ("rmse", "nll"):
                np.testing.assert_allclose(r["results"][name][m], v[m],
                                           rtol=1e-12, err_msg=name)


def test_shard_then_gather_is_the_state(tmp_path):
    leaves, y, control = stacked(4)
    spec = dict(cfg=dict(KW, case=2, x_dim=2), leaves=leaves, y=y,
                control=control, iters=2, mesh=(2, 2))
    for same in ranks(roundtrip_job, spec, tmp_path):
        assert same and all(same.values()), same


def test_a_non_finite_chain_raises_on_every_process(tmp_path):
    leaves, y, control = stacked(4)
    leaves["x"][3] = np.nan
    spec = dict(cfg=dict(KW, case=4, x_dim=2), leaves=leaves, y=y,
                control=control, iters=2, mesh=(2, 2))
    nlls = np.zeros((2, 4))
    nlls[0, 3] = np.nan
    with pytest.raises(FloatingPointError) as jax_err:
        j_check_finite(jax.numpy.asarray(nlls), 0, "chain", True)
    assert ranks(raise_job, spec, tmp_path) == [str(jax_err.value)] * 4
