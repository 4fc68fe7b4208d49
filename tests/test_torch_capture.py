"""The step that the card captures in a CUDA graph, run plainly on the CPU.

On the card ``Trainer.run`` replays one captured outer iteration and
``thin_posterior`` one captured sampler sub-step (``utils/graphs.py``).
The step they capture reads its draws from static buffers, works on the
state in place and writes its nll into a static trace.  Here the same code
runs without the graph (``Trainer._replay`` and ``eval.rollout._thin`` on
the CPU), under a guard that raises on any host read from the port
(``tests/torch_host_guard.py``), and is held:

- against eager ``outer_step`` bit for bit: the trace and every tensor of
  the state (leaves, SG-HMC chain, window, counts, Adam's moments and step);
- against the JAX ``Trainer`` at the existing tests' tolerances (C4 rtol
  1e-12, the rest 1e-9) with JAX's draws injected: C4 over 200 iterations;
  C5 and C2 across the window-fill boundary (70 iterations at
  ``window_size`` 64); C6 with the sweep's draws; deep C4; windowed kink;
  8 C4 chains and two stacked datasets under ``BatchedTrainer``.

Then the thinning sub-step likewise, a checkpoint moving between the two
paths bit-equal (``CHECKPOINT_FORMAT`` 1), and the refusals: ``capture=True``
on the CPU and under a gloo mesh whose step all-reduces, a CPU generator for
a captured step.  The meshed step's body: tests/test_torch_dist_capture.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.parallel import multidataset as jmd

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.eval import rollout
from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import SSMData, params_from_numpy
from ffvd_tpu_torch.parallel import MultiChainTrainer
from ffvd_tpu_torch.parallel.multidataset import (MultiDatasetTrainer,
                                                  stack_datasets)
from ffvd_tpu_torch.utils import graphs
from ffvd_tpu_torch.utils.checkpoint import (CHECKPOINT_FORMAT,
                                             CheckpointManager)
from tests import test_torch_trainer as c4t
from tests import test_torch_trainer_pg as pgt
from tests.test_torch_deep import (D, M, by_path, deep_model,
                                   jax_trainer_run)
from tests.test_torch_minibatch import W, kink_model
from tests.test_torch_multichain import jax_multichain
from tests.torch_host_guard import no_host_reads

torch.set_num_threads(2)

TOL = dict(rtol=1e-9, atol=1e-12)


def small(kw, leaves, y, control, pg=False):
    """A trainer of a small model and a factory of fresh states."""
    cfg = FFVDConfig(**kw)
    tr = Trainer(cfg, SSMData(y=torch.as_tensor(y),
                              control=torch.as_tensor(control)),
                 pg_fn=make_pg_fn(cfg) if pg else None)
    return tr, lambda: tr.init_state(params_from_numpy(leaves))


def eager(tr, state, n, draws=None, gen=None, chunk=500):
    return tr.run(state, n, chunk_size=chunk, draws=draws, generator=gen,
                  capture=False)[1]


def replayed(tr, state, n, draws=None, gen=None, chunks=None):
    """``run``'s captured path without the graph: ``Trainer._replay``, which
    on the CPU runs the step plainly, in ``chunks`` (default one)."""
    it = iter(draws) if draws is not None else None
    with no_host_reads():
        return torch.cat([tr._replay(state, gen, it, k)
                          for k in (chunks or [n])])


def assert_same(a, b, trace_a, trace_b):
    """Bit for bit: the traces and every tensor of the two states."""
    assert torch.equal(trace_a, trace_b)
    ta, tb = a.tensors(), b.tensors()
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert x.shape == y.shape and torch.equal(x, y), i


def assert_jax(state, trace, jstate, jtrace, tol=TOL):
    np.testing.assert_allclose(trace.numpy(), jtrace, **tol)
    jl = by_path(jstate.params)
    for k, v in state.params.leaves().items():
        np.testing.assert_allclose(v.detach().numpy(), jl[k], err_msg=k,
                                   **tol)


def test_c4_200_iterations(monkeypatch):
    """C4 draws nothing: 200 iterations, held at JAX's rtol 1e-12; the
    static trace is cut to 64 rows so its flush runs too."""
    monkeypatch.setattr(graphs, "TRACE_CAP", 64)
    cfg = FFVDConfig(dataset="ballbeam", case=4)
    tr, a = c4t._port(cfg)
    _, b = c4t._port(cfg)
    ta = eager(tr, a, 200, chunk=100)
    tb = replayed(tr, b, 200, chunks=[120, 80])
    assert_same(a, b, ta, tb)
    assert tr._graph.graph.capture is False and b.step == 200
    _, jtrace = c4t._jax_trace(JConfig(dataset="ballbeam", case=4), 200)
    np.testing.assert_allclose(tb.numpy(), jtrace, rtol=1e-12)


@pytest.mark.parametrize("case", [5, 2])
def test_sampler_across_the_window_fill(case):
    """70 iterations at window_size 64: the ring fills at iteration 64 and
    the feed's bound stops growing; JAX's sub-step normals and feeds."""
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=case,
              window_size=64)
    leaves, y, control = deep_model(11, n=24, n_hidden=0)
    jstate, jtrace, draws = jax_trainer_run(kw, leaves, y, control, 70)
    tr, fresh = small(kw, leaves, y, control)
    a, b = fresh(), fresh()
    ta, tb = eager(tr, a, 70, draws), replayed(tr, b, 70, draws, chunks=[
        60, 10])
    assert_same(a, b, ta, tb)
    assert b.window_count == 64 and b.step == 70
    assert_jax(b, tb, jstate, jtrace)


def test_sampler_from_the_generator():
    """C5 drawing its normals and feed from one generator: the plain step
    and eager ``outer_step`` consume it alike."""
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=5,
              window_size=4)
    tr, fresh = small(kw, *deep_model(12, n=24, n_hidden=0))
    a, b = fresh(), fresh()
    ga, gb = (torch.Generator().manual_seed(5) for _ in range(2))
    assert_same(a, b, eager(tr, a, 6, gen=ga), replayed(tr, b, 6, gen=gb))
    assert torch.equal(ga.get_state(), gb.get_state())


def test_c6_with_the_sweep_draws():
    jcfg = JConfig(dataset="ballbeam", case=6)
    jstate, jtrace, draws = pgt._jax_run(jcfg, 2)
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.model.params import init_params_from_warmstart
    cfg = FFVDConfig(dataset="ballbeam", case=6)
    ds = create_dataset("ballbeam")
    tr = Trainer(cfg, SSMData(y=torch.as_tensor(ds.y_train),
                              control=torch.as_tensor(ds.control)),
                 pg_fn=make_pg_fn(cfg))
    fresh = lambda: tr.init_state(init_params_from_warmstart(
        load_warmstart("ballbeam")))
    a, b = fresh(), fresh()
    ta, tb = eager(tr, a, 2, draws), replayed(tr, b, 2, draws)
    assert_same(a, b, ta, tb)
    assert_jax(b, tb, jstate, jtrace)


@pytest.mark.parametrize("what", ["deep", "windowed"])
def test_deep_and_windowed(what):
    if what == "deep":
        kw = dict(dataset="flutter", num_inducing=M, x_dim=D, n_layers=2,
                  case=4)
        leaves, y, control = deep_model(5, n=40)
    else:
        leaves, y, control = kink_model()
        kw = dict(dataset="kink", num_inducing=8, x_dim=2, minibatch_size=W,
                  case=4)
    jstate, jtrace, draws = jax_trainer_run(kw, leaves, y, control, 3)
    tr, fresh = small(kw, leaves, y, control)
    a, b = fresh(), fresh()
    ta, tb = eager(tr, a, 3, draws), replayed(tr, b, 3, draws)
    assert_same(a, b, ta, tb)
    assert_jax(b, tb, jstate, jtrace)


def test_eight_c4_chains():
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=4)
    base, y, control = deep_model(13, n=24, n_hidden=0)
    rng = np.random.RandomState(0)
    leaves = {k: np.stack([v + 1e-3 * rng.randn(*v.shape)
                           for _ in range(8)]) for k, v in base.items()}
    jstate, jtrace, draws = jax_multichain(kw, leaves, y, control, 5)
    mct = MultiChainTrainer(FFVDConfig(**kw), SSMData(
        y=torch.as_tensor(y), control=torch.as_tensor(control)), 8)
    fresh = lambda: mct.init_state(params_from_numpy(leaves))
    a, b = fresh(), fresh()
    ta, tb = eager(mct, a, 5, draws), replayed(mct, b, 5, draws)
    assert_same(a, b, ta, tb)
    assert tb.shape == (5, 8)
    assert_jax(b, tb, jstate, jtrace, dict(rtol=1e-10, atol=1e-13))


def test_eight_c5_chains_from_the_generator():
    """The batched sampler with a feed of one slot a chain, drawn."""
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=5,
              window_size=3)
    base, y, control = deep_model(14, n=24, n_hidden=0)
    leaves = {k: np.stack([v] * 8) for k, v in base.items()}
    mct = MultiChainTrainer(FFVDConfig(**kw), SSMData(
        y=torch.as_tensor(y), control=torch.as_tensor(control)), 8)
    a, b = (mct.init_state(params_from_numpy(leaves)) for _ in range(2))
    ga, gb = (torch.Generator().manual_seed(2) for _ in range(2))
    assert_same(a, b, eager(mct, a, 5, gen=ga), replayed(mct, b, 5, gen=gb))


def test_two_stacked_datasets():
    names = ("drive", "gas_furnace")
    jdata, jparams, _ = jmd.stack_datasets(names, dtype=jnp.float64, m=12)
    jmt = jmd.MultiDatasetTrainer(JConfig(dataset="drive", case=4,
                                          num_inducing=12), jdata)
    jstate, jtrace = jmt.run(jmt.init_state(jparams), 5, jax.random.key(0),
                             chunk_size=5)
    data, params, _ = stack_datasets(names, m=12)
    mt = MultiDatasetTrainer(FFVDConfig(dataset="drive", case=4,
                                        num_inducing=12), data)
    a, b = mt.init_state(params), mt.init_state(params)
    ta, tb = eager(mt, a, 5, chunk=2), replayed(mt, b, 5, chunks=[2, 3])
    assert_same(a, b, ta, tb)
    assert_jax(b, tb, jstate, np.asarray(jtrace))


@pytest.mark.parametrize("injected", [False, True],
                         ids=["generator", "thin_noise"])
def test_thinning_sub_step(injected):
    """``thin_posterior``'s sub-step through its graph's static buffers
    equals the eager chain: samples, moved state and the generator."""
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=5)
    tr, fresh = small(kw, *deep_model(15, n=24, n_hidden=0))
    state = fresh()
    tr.run(state, 2, generator=torch.Generator().manual_seed(1))
    noise = None
    if injected:
        g = torch.Generator().manual_seed(9)
        noise = {k: torch.randn((3, 4) + tuple(v.shape), generator=g,
                                dtype=v.dtype)
                 for k, v in tr.subset.split(state.params).items()}
    ga, gb = (torch.Generator().manual_seed(3) for _ in range(2))
    sa, moved_a = rollout.thin_posterior(tr, state, 3, 4, ga, noise,
                                         capture=False)
    with no_host_reads():
        sb, moved_b = rollout._thin(tr, state, 3, 4, gb, noise, None,
                                    graph=False)
    for p, q in zip(sa + [moved_a.params], sb + [moved_b.params]):
        for k in tr.subset.paths:
            assert torch.equal(p.leaves()[k], q.leaves()[k]), k
    for f in ("xi", "g", "g2", "p"):
        for k in tr.subset.paths:
            assert torch.equal(getattr(moved_a.sghmc, f)[k],
                               getattr(moved_b.sghmc, f)[k])
    assert torch.equal(ga.get_state(), gb.get_state())
    # the samples are copies: the next call reuses the graph's buffers
    again, _ = rollout._thin(tr, state, 1, 1, gb, None, None, graph=False)
    assert torch.equal(sb[0].leaves()[tr.subset.paths[0]],
                       sa[0].leaves()[tr.subset.paths[0]])
    assert tr._thin_graph.graph.capture is False and again


@pytest.mark.parametrize("first", ["replayed", "eager"])
def test_checkpoint_moves_between_the_paths(first, tmp_path):
    """Save after 4 iterations of one path, restore into a fresh state and
    run 4 more on the other: bit-equal to 8 uninterrupted iterations.  The
    file is format 1; a file written on the card (Adam ``capturable``)
    restores on the CPU with the CPU's Adam."""
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=5,
              window_size=3)
    tr, fresh = small(kw, *deep_model(16, n=24, n_hidden=0))
    paths = {"replayed": lambda s, g: replayed(tr, s, 4, gen=g),
             "eager": lambda s, g: eager(tr, s, 4, gen=g)}
    second = "eager" if first == "replayed" else "replayed"
    ref, g_ref = fresh(), torch.Generator().manual_seed(8)
    t_ref = torch.cat([paths[first](ref, g_ref), paths[first](ref, g_ref)])

    state, g = fresh(), torch.Generator().manual_seed(8)
    t1 = paths[first](state, g)
    manager = CheckpointManager(tmp_path)
    manager.save(4, state, g)
    payload = torch.load(tmp_path / "ckpt_000000004.pt", weights_only=True)
    assert payload["format"] == CHECKPOINT_FORMAT == 1
    payload["adam"]["param_groups"][0]["capturable"] = True
    torch.save(payload, tmp_path / "ckpt_000000004.pt")

    back, g2 = fresh(), torch.Generator()
    manager.restore(back, generator=g2)
    assert back.adam.param_groups[0]["capturable"] is False
    assert back.step == 4 and back.window_count == 3
    t2 = paths[second](back, g2)
    assert_same(ref, back, t_ref, torch.cat([t1, t2]))


def test_capture_true_raises_on_the_cpu():
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=5)
    tr, fresh = small(kw, *deep_model(17, n=24, n_hidden=0))
    state = fresh()
    with pytest.raises(ValueError, match="CUDA device"):
        tr.run(state, 1, generator=torch.Generator(), capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        rollout.thin_posterior(tr, state, 1, 1, torch.Generator(),
                               capture=True)
    assert state.step == 0 and not hasattr(tr, "_graph")
    tr.run(state, 1, generator=torch.Generator())   # the default: eager
    assert state.step == 1 and not hasattr(tr, "_graph")


def test_a_captured_step_refuses_a_cpu_generator():
    with pytest.raises(ValueError, match="CUDA generator"):
        graphs.StepGraph(lambda d: None, {}, True, torch.Generator())


def test_capture_true_raises_under_a_mesh(tmp_path):
    """A mesh refuses capture only for what its step holds: a world-1 mesh
    issues no collective, so on the CPU ``capture=True`` raises for the
    CPU and the default runs eagerly; a gloo mesh whose step all-reduces
    over 'ep' refuses with the backend named, on every process."""
    from ffvd_tpu_torch.parallel import make_mesh
    from ffvd_tpu_torch.parallel.distributed import spawn_local
    from ffvd_tpu_torch.parallel.rank_jobs import raise_job
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=4)
    base, y, control = deep_model(18, n=24, n_hidden=0)
    leaves = {k: np.stack([v] * 2) for k, v in base.items()}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mct = MultiChainTrainer(FFVDConfig(**kw), SSMData(
            y=torch.as_tensor(y), control=torch.as_tensor(control)), 2,
            mesh=make_mesh(1))
        state = mct.init_state(params_from_numpy(leaves))
        assert mct.step_collectives == ()
        with pytest.raises(ValueError, match="CUDA device"):
            mct.run(state, 1, capture=True)
        assert not mct.capture_mode(state, None)
        _, trace = mct.run(state, 2)
        assert trace.shape == (2, 2) and state.step == 2
        assert not hasattr(mct, "_graph")
    finally:
        dist.destroy_process_group()
    spec = dict(cfg=kw, leaves=leaves, y=y, control=control, iters=1,
                mesh=(1, 2), capture=True)
    said = spawn_local(raise_job, 2, "gloo", "cpu", args=(spec,),
                       timeout=240, tmpdir=str(tmp_path))
    assert len(said) == 2 and said[0] == said[1]
    assert "'ep' on gloo" in said[0] and "CUDA device" not in said[0]


def test_the_feed_bound_is_the_device_count():
    """The window feed is drawn below the count on the device: with one
    snapshot in the ring every feed is slot 0."""
    kw = dict(dataset="flutter", num_inducing=M, x_dim=D, case=5,
              window_size=8)
    tr, fresh = small(kw, *deep_model(19, n=24, n_hidden=0))
    state = fresh()
    tr.outer_step(state, torch.Generator().manual_seed(0))
    assert state.window_count == 1
    g = torch.Generator().manual_seed(1)
    for _ in range(20):
        fed = tr._feed_params(state, g, None)
        for k in tr.subset.paths:
            assert torch.equal(fed.leaves()[k], state.window[k][0])
    state.counts[1] = 5
    seen = {int(torch.randint(0, 2 ** 62, (1,), generator=g) % 5)
            for _ in range(200)}
    assert seen == set(range(5))

