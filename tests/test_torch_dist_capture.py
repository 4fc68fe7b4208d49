"""The captured step of a meshed trainer, run plainly on the CPU.

On the card a process of a 'dp'-only mesh replays its own captured outer
iteration, thinning sub-step and rollout step (``utils/graphs.py``): the
step issues no collective, since the trace is gathered over 'dp' after a
chunk.  Here four gloo processes (``parallel.distributed.spawn_local`` and
the jobs of ``parallel/rank_jobs.py``, fp64, ``small_model``'s sizes) run
that step's body through ``Trainer._replay`` (``capture="body"``: the CPU's
view of what the card replays, as ``tests/test_torch_capture.py`` does for
one process) and eagerly, in the same processes, and this process holds:

- the body against the eager meshed run bit for bit, on a dp=4 × ep=1 mesh:
  8 C4 chains over 20 iterations, 8 C5 chains over 3 with JAX's draws
  injected, 4 C6 chains over 3 with JAX's sweep draws, deep C4 chains and
  their ``multichain_moments`` (the recursion), four stacked datasets;
- the same runs against the one-process port at rtol 1e-12 and against
  JAX's ``MultiChainTrainer(mesh=make_mesh(4, ep=1, ...))`` at rtol 1e-9;
- the capture rule (``inference.trainer.capture_rule``) as a table:
  backend × dp/ep/sp sizes × device × ``capture`` → eager, captured or a
  ``ValueError``, and the collectives that each kind of mesh reports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.inference.particle_gibbs import make_pg_fn as j_make_pg_fn
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.parallel.sharding import MultiChainTrainer as JMultiChain
from ffvd_tpu.parallel.sharding import make_mesh as j_make_mesh

from ffvd_tpu_torch.inference.trainer import capture_rule
from ffvd_tpu_torch.parallel.rank_jobs import (chains_job, datasets_job,
                                               jobs_in_turn)
from tests.test_torch_deep import by_path, jax_deep_params
from tests.test_torch_dist_chains import (KW, assert_moments, assert_same,
                                          ranks, stacked)
from tests.test_torch_multichain import jax_multichain
from tests.test_torch_particle_gibbs import jax_pg_draws, to_torch_draws

torch.set_num_threads(2)
CPU = torch.device("cpu")
JAX_TOL = dict(rtol=1e-9, atol=1e-12)


def body_and_eager(spec, tmp_path, kind="chains"):
    """Each rank's (body, eager) results of ``spec`` on a dp=4 × ep=1
    mesh, in one set of 4 gloo processes."""
    spec = dict(spec, mesh=(4, 1))
    out = ranks(jobs_in_turn, [
        ("body", kind, dict(spec, capture="body")),
        ("eager", kind, dict(spec, capture=False))], tmp_path)
    return [(r["body"][0], r["eager"][0]) for r in out]


def assert_bits(body, eager):
    """The trace, every state tensor and the moments, bit for bit."""
    assert torch.equal(body["trace"], eager["trace"])
    assert set(body["state"]) == set(eager["state"])
    for k, v in eager["state"].items():
        assert torch.equal(body["state"][k], v), k
    for a, b in zip(body.get("moments", ()), eager.get("moments", ())):
        for u, w in zip(a, b):
            np.testing.assert_array_equal(u, w)


def assert_jax(result, jstate, jtrace, sghmc_paths=()):
    np.testing.assert_allclose(result["trace"].numpy(), jtrace, **JAX_TOL)
    state = result["state"]
    for k, v in by_path(jstate.params).items():
        np.testing.assert_allclose(state[f"params.{k}"].numpy(), v,
                                   err_msg=k, **JAX_TOL)
    for f in ("xi", "g", "g2", "p") if sghmc_paths else ():
        jf = by_path(getattr(jstate.sghmc, f))
        for k in sghmc_paths:
            np.testing.assert_allclose(state[f"sghmc.{f}.{k}"].numpy(),
                                       jf[k], err_msg=f"{f}.{k}", **JAX_TOL)


@pytest.mark.parametrize("case,iters", [(4, 20), (5, 3)], ids=["C4", "C5"])
def test_dp_only_body_is_eager_one_process_and_jax_mesh(case, iters,
                                                         tmp_path):
    kw = dict(KW, case=case, x_dim=2)
    leaves, y, control = stacked(8)
    jstate, jtrace, draws = jax_multichain(
        kw, leaves, y, control, iters, mesh=j_make_mesh(4, ep=1, x_dim=2))
    spec = dict(cfg=kw, leaves=leaves, y=y, control=control, iters=iters,
                chunk=iters, draws=draws if case == 5 else None,
                moments=dict(test_len=6, seed=9))
    single = chains_job(CPU, dict(spec, capture=False))
    out = body_and_eager(spec, tmp_path)
    for body, eager in out:
        assert_bits(body, eager)
        assert_same(body, single, rtol=1e-12)
        assert_moments(body["moments"], single["moments"], rtol=1e-12)
        assert body["step_collectives"] == ()
    # One rollout call a dp group, 2 chains × 2 samples, its rows offset.
    assert [b["rollout_calls"] for b, _ in out] == [
        [(4, 0)], [(4, 4)], [(4, 8)], [(4, 12)]]
    sghmc = [k.split(".", 2)[2] for k in out[0][0]["state"]
             if k.startswith("sghmc.xi.")]
    assert bool(sghmc) == (case == 5)
    assert_jax(out[0][0], jstate, jtrace, sghmc)


def test_dp_only_c6_body_is_eager_one_process_and_jax_mesh(tmp_path):
    """4 C6 chains, one a process, each sweeping on JAX's draws for its
    chain (``MeshBatchedTrainer._pg`` keeps its share of the list)."""
    kw = dict(KW, case=6, x_dim=2, pg_particles=5)
    leaves, y, control = stacked(4)
    iters, c = 3, 4
    cfg = JConfig(**kw)
    jmct = JMultiChain(cfg, JSSMData(y=jnp.asarray(y),
                                     control=jnp.asarray(control)), c,
                       mesh=j_make_mesh(4, ep=1, x_dim=2),
                       pg_fn=j_make_pg_fn(cfg))
    key = jax.random.key(11)
    keys = jax.random.split(jax.random.split(key)[1],
                            iters * c).reshape(iters, c)
    n, d = leaves["x"].shape[1] - 1, leaves["x"].shape[2]
    draws = [{"pg": [to_torch_draws(jax_pg_draws(
        jax.random.split(keys[t, i], 3)[2], n, cfg.pg_particles, d,
        cfg.pg_ancestor_trace)) for i in range(c)]} for t in range(iters)]
    jstate, jtrace = jmct.run(jmct.init_state(jax_deep_params(leaves)),
                              iters, key, chunk_size=iters)
    spec = dict(cfg=kw, leaves=leaves, y=y, control=control, iters=iters,
                draws=draws)
    single = chains_job(CPU, dict(spec, capture=False))
    out = body_and_eager(spec, tmp_path)
    for body, eager in out:
        assert_bits(body, eager)
        assert_same(body, single, rtol=1e-12)
    assert not np.array_equal(out[0][0]["state"]["params.x"].numpy(),
                              leaves["x"])
    assert_jax(out[0][0], jstate, np.asarray(jtrace))


def test_dp_only_deep_chains_and_their_recursion(tmp_path):
    """Deep C4 chains: training with the inter-layer normals drawn whole
    and cut to the share, then ``multichain_moments`` by the recursion,
    each process its own chains' rows."""
    leaves, y, control = stacked(4, n_hidden=1)
    spec = dict(cfg=dict(KW, x_dim=2, case=4, n_layers=2), leaves=leaves,
                y=y, control=control, iters=3,
                moments=dict(test_len=5, seed=2))
    single = chains_job(CPU, dict(spec, capture=False))
    for body, eager in body_and_eager(spec, tmp_path):
        assert_bits(body, eager)
        assert_same(body, single, rtol=1e-12)
        assert_moments(body["moments"], single["moments"], rtol=1e-12)
        assert body["launches"] == 0 and body["rollout_calls"] == []


def test_dp_only_datasets_and_the_collectives_each_mesh_reports(tmp_path):
    """Four stacked datasets, one a process: the body against the eager
    run bit for bit and the one-process run at 1e-12.  In the same
    processes, the groups whose all-reduces a step issues, as each kind of
    trainer reads them: none on 'dp' alone, 'ep' and 'sp' on gloo."""
    names = ["ballbeam", "drive", "gas_furnace", "dryer"]
    spec = dict(cfg=dict(case=4), names=names, iters=3, mesh=(4, 1))
    leaves, y, control = stacked(4)
    chains = dict(cfg=dict(KW, case=4, x_dim=2), leaves=leaves, y=y,
                  control=control, iters=1)
    seq = dict(chains, leaves={k: v[0] for k, v in leaves.items()},
               mesh=(4,), axis="sp")
    out = ranks(jobs_in_turn, [
        ("body", "datasets", dict(spec, capture="body")),
        ("eager", "datasets", dict(spec, capture=False)),
        ("dp4", "chains", dict(chains, mesh=(4, 1), refuse=True)),
        ("dp2ep2", "chains", dict(chains, mesh=(2, 2), refuse=True)),
        ("sp4", "sequence", dict(seq, refuse=True))], tmp_path)
    single = datasets_job(CPU, dict(spec, mesh=None, capture=False))
    for r in out:
        body, eager = r["body"][0], r["eager"][0]
        assert_bits(body, eager)
        assert_same(body, single, rtol=1e-12, atol=1e-12)
        assert body["step_collectives"] == ()
        assert r["dp4"][0]["step_collectives"] == ()
        assert "CUDA device" in r["dp4"][0]["refusal"]
        assert r["dp2ep2"][0]["step_collectives"] == (("ep", "gloo"),)
        assert "'ep' on gloo" in r["dp2ep2"][0]["refusal"]
        assert r["sp4"][0]["step_collectives"] == (("sp", "gloo"),)
        assert "'sp' on gloo" in r["sp4"][0]["refusal"]
        assert all(r[k][0]["replays"] is None for k in r)


def _collectives(backend, dp, ep, sp):
    """What a trainer on that mesh reports (the test above reads it from
    real gloo groups): the step all-reduces over 'ep' and 'sp', never over
    'dp'."""
    return tuple((axis, backend) for axis, size in (("ep", ep), ("sp", sp))
                 if size > 1)


CAPTURED, EAGER = "captured", "eager"
RULE_TABLE = [
    # backend, (dp, ep, sp), device, capture → outcome
    ("gloo", (1, 1, 1), "cuda", None, CAPTURED),
    ("gloo", (4, 1, 1), "cuda", None, CAPTURED),
    ("gloo", (4, 1, 1), "cuda", True, CAPTURED),
    ("gloo", (4, 1, 1), "cuda", False, EAGER),
    ("gloo", (4, 1, 1), "cpu", None, EAGER),
    ("gloo", (4, 1, 1), "cpu", True, "CUDA device"),
    ("gloo", (2, 2, 1), "cuda", None, EAGER),
    ("gloo", (2, 2, 1), "cuda", True, "'ep' on gloo"),
    ("gloo", (2, 2, 1), "cpu", True, "'ep' on gloo"),
    ("gloo", (2, 2, 1), "cuda", False, EAGER),
    ("gloo", (1, 1, 4), "cuda", None, EAGER),
    ("gloo", (1, 1, 4), "cuda", True, "'sp' on gloo"),
    ("nccl", (1, 1, 1), "cuda", None, CAPTURED),
    ("nccl", (4, 1, 1), "cuda", None, CAPTURED),
    ("nccl", (2, 2, 1), "cuda", None, CAPTURED),
    ("nccl", (2, 2, 1), "cpu", None, EAGER),
    ("nccl", (2, 2, 1), "cuda", True, CAPTURED),
    ("nccl", (2, 2, 1), "cuda", False, EAGER),
    ("nccl", (1, 1, 4), "cuda", None, CAPTURED),
    ("nccl", (1, 1, 4), "cpu", None, EAGER),
    ("nccl", (1, 1, 4), "cuda", True, CAPTURED),
    ("nccl", (1, 4, 1), "cpu", True, "CUDA device"),
]


@pytest.mark.parametrize("backend,sizes,device,capture,outcome", RULE_TABLE,
                         ids=[f"{b}-dp{s[0]}ep{s[1]}sp{s[2]}-{d}-{c}"
                              for b, s, d, c, _ in RULE_TABLE])
def test_the_capture_rule(backend, sizes, device, capture, outcome):
    args = (capture, device == "cuda", _collectives(backend, *sizes))
    if outcome in (CAPTURED, EAGER):
        assert capture_rule(*args) is (outcome == CAPTURED)
    else:
        with pytest.raises(ValueError, match=outcome):
            capture_rule(*args)
