"""How long the port's CUDA-graph steps live (``utils/graphs.py``), on the
CPU, where each step's body runs plainly through the same objects that
hold it on the card.

- No graph refers back to the trainer that holds it: with the cyclic
  collector off, dropping a trainer frees the graphs of its training step
  (``Trainer._replay``), thinning sub-step (``eval.rollout._thin``) and
  rollout recursion (``recursion_rollout``), for one process's
  ``Trainer``, ``MultiChainTrainer`` and ``MultiDatasetTrainer``, and for
  a ``MultiChainTrainer`` on a 2-rank gloo 'ep' mesh and the row-share
  trainer of a ``SequenceShardedTrainer`` on a 2-rank 'sp' mesh.
- A trainer whose step all-reduces over NCCL (faked here by naming NCCL
  in its ``step_collectives``) keeps a graph only for the outermost call
  that made it (``graph_scope``): its counts stay (``graph_stats``), the
  graph goes, also when the call raises; ``run_with_checkpoints`` makes
  one graph for its whole call.  Other trainers keep theirs.
- The capture rule's default for the steps that all-reduce.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.eval import rollout
from ffvd_tpu_torch.inference.trainer import Trainer, capture_rule
from ffvd_tpu_torch.model.params import (SSMData, init_hidden_layers,
                                         init_params_random)
from ffvd_tpu_torch.parallel import MultiChainTrainer
from ffvd_tpu_torch.parallel.distributed import spawn_local
from ffvd_tpu_torch.parallel.multidataset import MultiDatasetTrainer
from ffvd_tpu_torch.parallel.rank_jobs import checkpoint_job
from ffvd_tpu_torch.parallel.sharding import stack_members
from ffvd_tpu_torch.utils import graphs
from ffvd_tpu_torch.utils.checkpoint import (CheckpointManager,
                                             run_with_checkpoints)

torch.set_num_threads(2)
CPU = torch.device("cpu")
N, D, M, U = 12, 2, 5, 1
KW = dict(dataset="ballbeam", num_inducing=M, x_dim=D, window_size=4,
          num_posterior_samples=2, posterior_sample_spacing=2)
NCCL_EP = (("ep", "nccl"),)
# The first Adam of a process imports torch._dynamo, and that import leaves
# the frames of its callers, and their locals, in reference cycles: make it
# here, before a test turns the cyclic collector off.
torch.optim.Adam([torch.zeros(1, requires_grad=True)])


def model(seed=0, n_layers=1):
    """(leaves of a random cold start, y, control) at N transitions."""
    g = torch.Generator().manual_seed(seed)
    params = init_params_random(N, D, M, U, generator=g)
    if n_layers > 1:
        params = dataclasses.replace(params, hidden=init_hidden_layers(
            n_layers - 1, params, generator=g))
    rng = np.random.RandomState(seed)
    return (params, torch.as_tensor(rng.randn(N, 1)),
            torch.as_tensor(rng.randn(N + 1, U)))


def trainer(case=4, n_layers=1, kind="one", seed=0):
    """A trainer of ``model`` and its first state: one process's
    ``Trainer``, a ``MultiChainTrainer`` of 2 chains ("chains") or a
    ``MultiDatasetTrainer`` of 2 copies of the data ("datasets")."""
    params, y, control = model(seed, n_layers)
    cfg = FFVDConfig(case=case, n_layers=n_layers, **KW)
    if kind == "one":
        tr = Trainer(cfg, SSMData(y=y, control=control))
        return tr, tr.init_state(params)
    two = stack_members([params, params])
    if kind == "chains":
        tr = MultiChainTrainer(cfg, SSMData(y=y, control=control), 2)
    else:
        tr = MultiDatasetTrainer(cfg, SSMData(
            y=torch.stack([y, y]), control=torch.stack([control, control])))
    return tr, tr.init_state(two)


@pytest.fixture
def no_cycle_collector():
    """The cyclic collector off: only reference counting frees."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def make_graph(tr, state, what):
    """Run ``what``'s step of ``tr`` through its graph's body; return the
    graph object the trainer keeps."""
    gen = torch.Generator().manual_seed(5)
    if what == "train":
        tr._replay(state, gen, None, 3, False)
        return tr._graph
    if what == "thin":
        rollout._thin(tr, state, 2, 2, gen, None, None, graph=False)
        return tr._thin_graph
    p = state.params
    lead = tuple(tr.lead)
    noise = torch.randn(lead + (3, 4, D), generator=gen, dtype=p.x.dtype)
    hidden = [torch.randn_like(noise) for _ in p.hidden]
    controls = torch.randn(4, U, generator=gen, dtype=p.x.dtype)
    rollout.recursion_rollout(tr, p, controls, noise, hidden, capture=False)
    return tr._rollout_graph


CASES = {  # what → (case, layers)
    "train": (4, 1), "thin": (5, 1), "recursion": (4, 2)}


# MultiDatasetTrainer evaluates, thinning and rolling out, through
# one-process Trainers ("one").
DROPS = [(w, k) for w in CASES for k in ("one", "chains", "datasets")
         if k != "datasets" or w == "train"]


@pytest.mark.parametrize("what,kind", DROPS,
                         ids=[f"{w}-{k}" for w, k in DROPS])
def test_dropping_the_trainer_frees_its_graphs(what, kind,
                                               no_cycle_collector):
    case, layers = CASES[what]
    tr, state = trainer(case, layers, kind)
    g = make_graph(tr, state, what)
    refs = [weakref.ref(g), weakref.ref(g.graph)]
    del g
    assert [r() is None for r in refs] == [False, False]
    del tr
    assert [r() is None for r in refs] == [True, True]
    assert state.params.x.shape[-1] == D       # the state outlives them


def mesh_lifetime_job(dev, spec):
    """On a 2-rank gloo mesh: the training step's graph of a
    ``MultiChainTrainer`` over 'ep' (spec "ep") or of a
    ``SequenceShardedTrainer``'s row-share trainer over 'sp' ("sp"), run
    through its body; then, with the cyclic collector off, whether the
    trainer's collectives are gloo's and whether dropping it freed the
    graph."""
    from ffvd_tpu_torch.parallel.sequence import (SequenceShardedTrainer,
                                                  make_seq_mesh)
    from ffvd_tpu_torch.parallel.sharding import make_mesh
    params, y, control = model()
    cfg = FFVDConfig(case=4, **KW)
    data = SSMData(y=y, control=control)
    if spec == "ep":
        tr = MultiChainTrainer(cfg, data, 2, mesh=make_mesh(2, ep=2, x_dim=D))
        state = tr.init_state(stack_members([params, params]))
    else:
        tr = SequenceShardedTrainer(Trainer(cfg, data),
                                    make_seq_mesh(2)).trainer
        state = tr.init_state(params)
    tr._replay(state, torch.Generator().manual_seed(5), None, 3, False)
    collectives = tr.step_collectives
    gc.collect()
    gc.disable()
    try:
        ref = weakref.ref(tr._graph)
        del tr
        return collectives, ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("axis", ["ep", "sp"])
def test_meshed_trainers_free_their_graphs(axis, tmp_path):
    out = spawn_local(mesh_lifetime_job, 2, "gloo", "cpu", args=(axis,),
                      timeout=240, tmpdir=str(tmp_path))
    assert out == [(((axis, "gloo"),), True)] * 2


class BodyTrainer(Trainer):
    """``run`` through the captured path's body (``_replay`` run plainly,
    as the CPU runs what the card replays), its step named as NCCL's."""

    step_collectives = NCCL_EP

    def capture_mode(self, state, capture):
        return capture is not False

    def _replay(self, state, generator, draws, n, capture=None):
        return super()._replay(state, generator, draws, n, False)


def watch_graphs(monkeypatch):
    """A list that gets a weakref to every ``TrainGraph`` made."""
    made = []
    init = graphs.TrainGraph.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        made.append(weakref.ref(self))

    monkeypatch.setattr(graphs.TrainGraph, "__init__", spy)
    return made


def body_trainer(collectives=NCCL_EP):
    params, y, control = model()
    tr = BodyTrainer(FFVDConfig(case=4, **KW), SSMData(y=y, control=control))
    tr.step_collectives = collectives
    return tr, tr.init_state(params)


@pytest.mark.parametrize("collectives", [NCCL_EP, (("ep", "gloo"),), ()],
                         ids=["nccl", "gloo", "none"])
def test_a_graph_of_nccl_lives_for_the_call(collectives, monkeypatch,
                                            no_cycle_collector):
    made = watch_graphs(monkeypatch)
    tr, state = body_trainer(collectives)
    _, trace = tr.run(state, 7, chunk_size=3)
    assert trace.shape == (7,) and len(made) == 1
    per_call = collectives == NCCL_EP
    assert tr.graphs_per_call is per_call
    assert ("_graph" in vars(tr)) is not per_call
    assert (made[0]() is None) is per_call
    stats = graphs.graph_stats(tr)
    assert stats == {"captured": False, "replays": 0, "capture_s": None,
                     "pool_bytes": None}
    tr.run(state, 2)                   # a second call makes its own graph
    assert len(made) == (2 if per_call else 1)


def test_run_with_checkpoints_makes_one_graph(monkeypatch, tmp_path,
                                              no_cycle_collector):
    made = watch_graphs(monkeypatch)
    tr, state = body_trainer()
    mgr = CheckpointManager(tmp_path)
    _, trace = run_with_checkpoints(tr, state, 9, mgr, every=3)
    assert trace.shape == (9,) and mgr.all_steps() == [3, 6, 9]
    assert len(made) == 1 and made[0]() is None
    assert "_graph" not in vars(tr)


def test_scopes_nest_and_release_on_raise(no_cycle_collector):
    tr, state = body_trainer()
    with graphs.graph_scope(tr):
        with graphs.graph_scope(tr):
            tr._replay(state, None, None, 2, False)
        g = weakref.ref(tr._graph)
        tr._replay(state, None, None, 1, False)      # the same graph
        assert tr._graph is g()
    assert g() is None and "_graph" not in vars(tr)
    with pytest.raises(RuntimeError, match="mid-call"):
        with graphs.graph_scope(tr):
            tr._replay(state, None, None, 1, False)
            g = weakref.ref(tr._graph)
            raise RuntimeError("mid-call")
    assert g() is None and "_graph" not in vars(tr)


@pytest.mark.parametrize("what", ["thin", "recursion"])
def test_nccl_thinning_and_recursion_graphs_live_for_the_call(
        what, no_cycle_collector):
    case, layers = CASES[what]
    tr, state = trainer(case, layers)
    tr.step_collectives = NCCL_EP
    attr = "_thin_graph" if what == "thin" else "_rollout_graph"
    with graphs.graph_scope(tr):
        g = weakref.ref(make_graph(tr, state, what))
    assert g() is None and attr not in vars(tr)
    assert graphs.graph_stats(tr, attr)["captured"] is False
    if what == "recursion":                   # a scope of its own
        with pytest.raises(AttributeError, match=attr):
            make_graph(tr, state, what)


def test_checkpoint_job_full_mode_is_bit_exact(tmp_path):
    """``checkpoint_job``'s "full" mode in one process: the uninterrupted
    call, the call saving every ``first`` iterations, and the run resumed
    from its checkpoint at ``first`` give the same trace and state."""
    params, y, control = model()
    leaves = {k: v.numpy() for k, v in params.leaves().items()}
    spec = dict(cfg=dict(case=4, **KW), dtype="float64", leaves=leaves,
                y=y.numpy(), control=control.numpy(), iters=8, first=4,
                trainer="sequence", mode="full", dir=str(tmp_path))
    out = checkpoint_job(CPU, spec)
    assert out["files"] == ["ckpt_000000004.pt", "ckpt_000000008.pt"]
    want = out["uninterrupted"]
    for got in (out, out["checkpointed"]):
        assert torch.equal(got["trace"], want["trace"])
        assert set(got["state"]) == set(want["state"])
        for k, v in got["state"].items():
            assert torch.equal(v, want["state"][k]), k
    assert want["seconds"] > 0 and want["replays"] is None


@pytest.mark.parametrize("axis", ["ep", "sp"])
def test_the_default_captures_nccl_collectives(axis):
    assert capture_rule(None, True, ((axis, "nccl"),)) is True
    assert capture_rule(None, True, ((axis, "gloo"),)) is False
    assert capture_rule(None, False, ((axis, "nccl"),)) is False
