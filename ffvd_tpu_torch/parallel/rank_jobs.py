"""Jobs for the processes of a sharded run, and their one-process twins.

Each job takes the rank's device and one ``spec`` dict, builds the trainer
on a mesh of the started process group (``spec["mesh"]``; None: one
process, no group), runs it and returns plain CPU tensors that the caller
compares: the whole nll trace, the whole state, moments, launch rows and
times.  ``spawn_local`` pickles the job by name, so it lives in this
importable module (never in a script's ``__main__``), and it imports no
JAX: the tests hold these results against the JAX package in their own
process, ``chip_smoke.py`` against the one-process run on the card.

A spec holds numpy or torch values only: ``cfg`` (FFVDConfig keywords),
``dtype`` ("float32"/"float64"), the data (``y``, ``control`` and for
datasets ``mask``), the whole stacked ``leaves`` (path → (C, ...)), the
iteration count ``iters``, the training generator's ``seed``, optional
``draws`` (one dict of whole ``outer_step`` keywords per iteration) and
``capture``: ``Trainer.run``'s argument (None, True, False) for training
and evaluation, or "body", the captured step's body run through
``Trainer._replay`` (on the CPU, plainly: the CPU's view of what the card
replays).  ``sync_check`` (replays) and ``refuse`` ask for the checks of
a captured run (``_capture_checks``).  ``hold_trainer``: the process keeps
the job's trainer referenced (``HELD``) until it exits, past its
``destroy_process_group``.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# Trainers that jobs with ``spec["hold_trainer"]`` keep alive for the rest
# of the process.
HELD = []


def _to(obj, dev, dtype):
    """Tensors and arrays of ``obj`` (nested dicts and lists) on ``dev``;
    floating ones in ``dtype``."""
    if isinstance(obj, dict):
        return {k: _to(v, dev, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, dev, dtype) for v in obj)
    if isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        t = torch.as_tensor(obj)
        return t.to(dev, dtype if t.is_floating_point() else None)
    return obj


def _cpu(obj):
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    return obj


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _generator(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _mesh(spec):
    from ffvd_tpu_torch.parallel.sequence import make_seq_mesh
    from ffvd_tpu_torch.parallel.sharding import make_mesh
    shape = spec.get("mesh")
    if shape is None:
        return None
    if spec.get("axis") == "sp":
        return make_seq_mesh(shape[0])
    dp, ep = shape
    return make_mesh(dp * ep, ep=ep, x_dim=spec["cfg"].get("x_dim", 4))


def _state_dict(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``TrainState`` by its ``state_pspec`` key."""
    out = {f"params.{k}": v for k, v in state.params.leaves().items()}
    if state.sghmc is not None:
        for f in ("xi", "g", "g2", "p"):
            out.update({f"sghmc.{f}.{k}": v
                        for k, v in getattr(state.sghmc, f).items()})
    out.update({f"window.{k}": v for k, v in state.window.items()})
    if state.adam is not None:
        for k, p in zip(state.adam_paths(),
                        state.adam.param_groups[0]["params"]):
            st = state.adam.state.get(p, {})
            for f in ("exp_avg", "exp_avg_sq"):
                if f in st:
                    out[f"adam.{f}.{k}"] = st[f]
    return _cpu(out)


def _run_capture(spec) -> Optional[bool]:
    """``spec["capture"]`` for the runs after training: "body" takes the
    default."""
    capture = spec.get("capture")
    return None if capture == "body" else capture


def _train(trainer, state, spec, gen, draws):
    """``spec["iters"]`` iterations of ``trainer`` as ``spec["capture"]``
    says (the module docstring).  Returns (state, the whole trace)."""
    capture = spec.get("capture")
    if capture == "body":
        it = iter(draws) if draws is not None else None
        return state, trainer._gather_trace(
            trainer._replay(state, gen, it, spec["iters"]))
    return trainer.run(state, spec["iters"], generator=gen, draws=draws,
                       chunk_size=spec.get("chunk", 500), capture=capture)


def _capture_checks(trainer, state, spec, gen, dev) -> dict:
    """After a run: the replays of the trainer's last training graph
    (None: it ran eagerly or plainly), all its ``utils.graphs.
    graph_stats``, and the collectives its step issues; with
    ``spec["sync_check"]`` (k), k more replays with the card's sync debug
    mode at "error" (any host synchronisation inside raises), in one
    ``graph_scope`` with the warm-ups and capture of a graph that the run
    released, and the replays after them and under "error"; with
    ``spec["refuse"]``, the message of ``run(capture=True)``'s
    ``ValueError`` (None if it ran); with ``spec["hold_trainer"]``, the
    trainer goes to ``HELD``, and the graphs it still holds are named."""
    from ffvd_tpu_torch.utils import graphs
    stats = graphs.graph_stats(trainer)
    captured = stats is not None and stats["captured"]
    out = {"replays": stats["replays"] if captured else None,
           "graph_stats": stats,
           "step_collectives": trainer.step_collectives}
    k = spec.get("sync_check")
    if k and captured and dev.type == "cuda":
        with graphs.graph_scope(trainer):
            out["sync_check_recaptured"] = "_graph" not in vars(trainer)
            if out["sync_check_recaptured"]:
                trainer._replay(state, gen, None, graphs.WARMUP + 1, True)
            before = trainer._graph.graph.replays
            torch.cuda.synchronize(dev)
            torch.cuda.set_sync_debug_mode("error")
            try:
                trainer._replay(state, gen, None, k, True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize(dev)
            out["replays_after_sync_check"] = trainer._graph.graph.replays
            out["sync_check_replays"] = (out["replays_after_sync_check"]
                                         - before)
    if spec.get("refuse"):
        try:
            trainer.run(state, 1, generator=gen, capture=True)
            out["refusal"] = None
        except ValueError as exc:
            out["refusal"] = str(exc)
    if spec.get("hold_trainer"):
        HELD.append(trainer)
        out["held_live_graphs"] = [a for a in graphs.GRAPH_ATTRS
                                   if a in vars(trainer)]
    return out


def _timed_iters(trainer, state, n: int, gen, dev, capture=None) -> dict:
    """ms per iteration over a call of ``n`` iterations (with the warm-ups
    and capture of a graph that lives for one call, as a user's call runs
    it), then over a second call of ``n`` in one ``graph_scope`` with the
    first (replays only), and the share of the wall time this process
    spent inside the collectives: ``torch.profiler``'s host time of
    ``distributed.COLLECTIVE_LABEL`` over n/10 more in the same scope (the
    whole all-reduce under gloo, which waits for it; the enqueue only
    under NCCL; inside a replayed graph none is seen).  ``capture`` as in
    ``Trainer.run``."""
    from ffvd_tpu_torch.parallel.distributed import COLLECTIVE_LABEL
    from ffvd_tpu_torch.utils.graphs import graph_scope
    from ffvd_tpu_torch.utils.timing import hard_sync

    def timed_call(m):
        hard_sync(dev)
        t0 = time.perf_counter()
        trainer.run(state, m, generator=gen, capture=capture)
        hard_sync(dev)
        return time.perf_counter() - t0

    m = max(n // 10, 2)
    with graph_scope(trainer):
        wall = timed_call(n)
        again = timed_call(n)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            p_wall = timed_call(m)
    coll = [e for e in prof.key_averages() if e.key == COLLECTIVE_LABEL]
    coll_s = sum(e.cpu_time_total for e in coll) * 1e-6
    return {"ms_per_iter": 1e3 * wall / n, "iters": n,
            "ms_per_iter_second_call": 1e3 * again / n,
            "collective_share": coll_s / p_wall,
            "collectives_per_iter": sum(e.count for e in coll) / m,
            "profiled_iters": m}


def _chain_trainer(dev, spec, mesh):
    """(``MultiChainTrainer`` over the whole stacked ``leaves``, the whole
    params)."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
    from ffvd_tpu_torch.parallel.sharding import MultiChainTrainer
    dtype = DTYPES[spec.get("dtype", "float64")]
    cfg = FFVDConfig(**spec["cfg"])
    data = SSMData(y=_to(spec["y"], dev, dtype),
                   control=_to(spec["control"], dev, dtype))
    mct = MultiChainTrainer(cfg, data, spec["leaves"]["x"].shape[0],
                            mesh=mesh,
                            pg_fn=make_pg_fn(cfg) if cfg.case == 6 else None)
    return mct, GPSSMParams.from_leaves(_to(spec["leaves"], dev, dtype))


def _dataset_trainer(dev, spec, mesh):
    """(``MultiDatasetTrainer`` on ``spec["names"]``, the whole stacked
    params, the real lengths)."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.parallel.multidataset import (MultiDatasetTrainer,
                                                      stack_datasets)
    dtype = DTYPES[spec.get("dtype", "float64")]
    data, params, lens = stack_datasets(spec["names"], m=spec.get("m"),
                                        device=dev, dtype=dtype)
    return (MultiDatasetTrainer(FFVDConfig(**spec["cfg"]), data, mesh=mesh),
            params, lens)


def _sequence_trainer(dev, spec, mesh):
    """(the 'sp' trainer of one model, or the ``Trainer`` with no mesh,
    the params)."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
    from ffvd_tpu_torch.parallel.sequence import SequenceShardedTrainer
    dtype = DTYPES[spec.get("dtype", "float64")]
    cfg = FFVDConfig(**spec["cfg"])
    data = SSMData(y=_to(spec["y"], dev, dtype),
                   control=_to(spec["control"], dev, dtype))
    tr = Trainer(cfg, data, pg_fn=make_pg_fn(cfg) if cfg.case == 6 else None)
    if mesh is not None:
        tr = SequenceShardedTrainer(tr, mesh).trainer
    return tr, GPSSMParams.from_leaves(_to(spec["leaves"], dev, dtype))


def chains_job(dev, spec) -> dict:
    """``MultiChainTrainer`` over the whole ``leaves``: ``iters``
    iterations, then (``spec["moments"]``: test_len, seed, optionally its
    own ``capture``) the chains' ``multichain_moments``.  Returns the
    whole trace and state, the training seconds, the moments, this
    process's rollout launches and the recursion's and thinning's
    replays, with ``moments["check_plain"]`` each launch's largest
    difference from the plain rollout on the same inputs and seed, with
    ``spec["timed"]`` (iterations) ``_timed_iters``'s numbers, and
    ``_capture_checks``'."""
    from ffvd_tpu_torch.eval.ensemble import multichain_moments
    from ffvd_tpu_torch.ops import rollout as ro
    from ffvd_tpu_torch.parallel.sharding import (MultiChainTrainer,
                                                  gather_chain_state)
    from ffvd_tpu_torch.utils.graphs import graph_stats
    dtype = DTYPES[spec.get("dtype", "float64")]
    mesh = _mesh(spec)
    mct, params = _chain_trainer(dev, spec, mesh)
    cfg, data = mct.cfg, mct.data
    state = mct.init_state(params)
    gen = _generator(dev, spec.get("seed", 0))
    draws = _to(spec.get("draws"), dev, dtype)
    _sync(dev)
    t0 = time.perf_counter()
    state, trace = _train(mct, state, spec, gen, draws)
    _sync(dev)
    out = {"trace": _cpu(trace), "train_s": time.perf_counter() - t0}
    whole = state if mesh is None else gather_chain_state(state, mesh)
    out["state"] = _state_dict(whole)
    capture = _run_capture(spec)
    if spec.get("moments"):
        mo = spec["moments"]
        ro.rollout.log.clear()
        ro.rollout.launches = 0
        calls, plain_err, batched = [], [], ro.rollout_batched

        def spy(**kw):      # (rows, row_offset) of every call, either device
            calls.append((kw["x0"].shape[0], kw.get("row_offset", 0)))
            if not mo.get("check_plain"):
                return batched(**kw)
            g = kw["generator"]
            twin = torch.Generator(device=g.device)
            twin.set_state(g.get_state())
            xs, vs = batched(**kw)
            xr, vr = ro.rollout_reference_batched(**{**kw,
                                                     "generator": twin})
            plain_err.append(max(float((xs - xr).abs().max()),
                                 float((vs - vr).abs().max())))
            return xs, vs

        ro.rollout_batched = spy
        try:
            chains, _ = multichain_moments(
                mct, state, mo["test_len"],
                generator=_generator(dev, mo["seed"]),
                thin_generator=_generator(dev, mo["seed"] + 1),
                noise=_to(mo.get("noise"), dev, dtype),
                capture=mo.get("capture", capture))
        finally:
            ro.rollout_batched = batched
        out["moments"] = chains
        out["rollout_calls"] = calls
        out["launches"] = ro.rollout.launches
        out["launch_rows"] = [rows for rows, _ in ro.rollout.log]
        out["plain_max_abs_err"] = plain_err
        for key, attr in (("rollout_replays", "_rollout_graph"),
                          ("thin_replays", "_thin_graph")):
            st = graph_stats(mct, attr)
            out[key] = st["replays"] if st and st["captured"] else None
        if mo.get("check_whole") and mesh is not None:
            # The same moments of the gathered state in one launch of all
            # C×S rows (a comparison, after the counts were read).
            one = MultiChainTrainer(cfg, data, mct.n_whole)
            out["moments_one_launch"], _ = multichain_moments(
                one, whole, mo["test_len"],
                generator=_generator(dev, mo["seed"]),
                thin_generator=_generator(dev, mo["seed"] + 1),
                noise=_to(mo.get("noise"), dev, dtype))
    if spec.get("timed"):
        out["timed"] = _timed_iters(mct, state, spec["timed"], gen, dev,
                                    capture)
    out.update(_capture_checks(mct, state, spec, gen, dev))
    return out


def datasets_job(dev, spec) -> dict:
    """``MultiDatasetTrainer`` on ``spec["names"]`` (``stack_datasets``,
    ``spec["m"]`` inducing points), ``iters`` iterations, then
    ``evaluate`` (``spec["eval_seed"]``) on the whole list.  Returns the
    whole trace, the whole state and the results dict."""
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.parallel.sharding import gather_chain_state
    mesh = _mesh(spec)
    names = spec["names"]
    mdt, params, lens = _dataset_trainer(dev, spec, mesh)
    state = mdt.init_state(params)
    gen = _generator(dev, spec.get("seed", 0))
    _sync(dev)
    t0 = time.perf_counter()
    state, trace = _train(mdt, state, spec, gen, None)
    _sync(dev)
    train_s = time.perf_counter() - t0
    out = {"trace": _cpu(trace), "train_s": train_s,
           **_capture_checks(mdt, state, spec, gen, dev)}
    whole = state if mesh is None else gather_chain_state(state, mesh)
    out["state"] = _state_dict(whole)
    if spec.get("eval_seed") is not None:
        from ffvd_tpu_torch.ops import rollout as ro
        ro.rollout.log.clear()
        ro.rollout.launches = 0
        out["results"] = mdt.evaluate(
            state, [create_dataset(n) for n in names], lens,
            generator=_generator(dev, spec["eval_seed"]))
        out["launches"] = ro.rollout.launches
        out["launch_rows"] = [rows for rows, _ in ro.rollout.log]
        out["launch_resident"] = [p.resident for _, p in ro.rollout.log]
    return out


def sequence_job(dev, spec) -> dict:
    """``Trainer`` of one model (``leaves`` unstacked), ``iters``
    iterations, on an 'sp' mesh through ``SequenceShardedTrainer`` or in
    one process.  Returns the trace and the state, and with
    ``spec["timed"]`` ``_timed_iters``'s numbers."""
    dtype = DTYPES[spec.get("dtype", "float64")]
    tr, params = _sequence_trainer(dev, spec, _mesh(spec))
    state = tr.init_state(params)
    gen = _generator(dev, spec.get("seed", 0))
    state, trace = _train(tr, state, spec, gen,
                          _to(spec.get("draws"), dev, dtype))
    out = {"trace": _cpu(trace), "state": _state_dict(state)}
    if spec.get("timed"):
        out["timed"] = _timed_iters(tr, state, spec["timed"], gen, dev,
                                    _run_capture(spec))
    out.update(_capture_checks(tr, state, spec, gen, dev))
    return out


def grads_job(dev, spec) -> Dict[str, torch.Tensor]:
    """Per-leaf gradients of one training objective, through the trainer's
    own hooks: the ('dp','ep') chain trainer (``spec["axis"]`` "ep") or the
    'sp' trainer ("sp"), ``autograd.grad`` of this process's objective,
    then ``_reduce_grads``, then gathered whole.  With ``mesh`` None it is
    the unsharded ``autograd.grad``.  ``spec["start"]``: the objective on
    the window at that start (a one-element tensor; training with
    ``minibatch_size``).  Returns path → gradient, and "nll"."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.inference.trainer import Trainer, grads_of
    from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
    from ffvd_tpu_torch.parallel.sequence import SequenceShardedTrainer
    from ffvd_tpu_torch.parallel.sharding import (MultiChainTrainer,
                                                  gather_leaves)
    dtype = DTYPES[spec.get("dtype", "float64")]
    cfg = FFVDConfig(**spec["cfg"])
    mesh = _mesh(spec)
    data = SSMData(y=_to(spec["y"], dev, dtype),
                   control=_to(spec["control"], dev, dtype))
    leaves = _to(spec["leaves"], dev, dtype)
    eps = _to(spec.get("eps"), dev, dtype)
    start = _to(spec.get("start"), dev, dtype)
    if spec.get("axis") == "sp":
        tr = Trainer(cfg, data,
                     pg_fn=make_pg_fn(cfg) if cfg.case == 6 else None)
        if mesh is not None:
            tr = SequenceShardedTrainer(tr, mesh).trainer
        params = GPSSMParams.from_leaves(
            {k: v.requires_grad_(True) for k, v in leaves.items()})
    else:
        tr = MultiChainTrainer(cfg, data, leaves["x"].shape[0], mesh=mesh)
        local = tr.init_state(GPSSMParams.from_leaves(leaves)).params
        eps = None if eps is None else [tr._share(e) for e in eps]
        params = GPSSMParams.from_leaves(
            {k: v.detach().requires_grad_(True)
             for k, v in local.leaves().items()})
    paths = list(params.leaves())
    with torch.enable_grad():
        nll = tr.train_nll(params, start=start, eps=eps)
        grads = grads_of(nll, list(params.leaves().values()))
    grads = dict(zip(paths, tr._reduce_grads(paths, grads)))
    nll = tr._reduce_nll(nll.detach())
    if spec.get("axis") != "sp":
        grads = gather_leaves(grads, tr.place, mesh)
        nll = tr._gather_trace(nll[None])[0]
    return _cpu({**grads, "nll": nll})


def roundtrip_job(dev, spec) -> Dict[str, bool]:
    """The whole state of ``iters`` one-process iterations, cut to this
    process's share (``shard_chain_state``) and gathered back
    (``gather_chain_state``): key → whether it is the whole state's tensor
    exactly."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
    from ffvd_tpu_torch.parallel.sharding import (MultiChainTrainer,
                                                  gather_chain_state,
                                                  shard_chain_state)
    dtype = DTYPES[spec.get("dtype", "float64")]
    data = SSMData(y=_to(spec["y"], dev, dtype),
                   control=_to(spec["control"], dev, dtype))
    mct = MultiChainTrainer(FFVDConfig(**spec["cfg"]), data,
                            spec["leaves"]["x"].shape[0])
    state = mct.init_state(GPSSMParams.from_leaves(
        _to(spec["leaves"], dev, dtype)))
    mct.run(state, spec["iters"], generator=_generator(dev, 0))
    mesh = _mesh(spec)
    back = _state_dict(gather_chain_state(shard_chain_state(state, mesh),
                                          mesh))
    whole = _state_dict(state)
    return {k: k in back and torch.equal(back[k], v)
            for k, v in whole.items()}


def checkpoint_job(dev, spec) -> dict:
    """A run of ``spec["trainer"]`` ("chains", "datasets" or "sequence")
    through ``utils/checkpoint.py`` in the directory ``spec["dir"]``.

    ``spec["mode"]`` "resume": ``run_with_checkpoints`` to iteration
    ``spec["first"]``, a restore into a fresh ``init_state`` with a
    generator of another seed, then on to ``iters``.  "full": after 3
    untimed iterations, ``run`` to ``iters`` uninterrupted, then
    ``run_with_checkpoints`` to ``iters`` saving every ``first``, each
    from a fresh state and timed, then the same restore of checkpoint
    ``first`` and on to ``iters``.  "restore": a restore of checkpoint
    ``spec["first"]`` into a fresh state, then on to ``iters``.
    ``spec["rank_seeds"]``: each process seeds its generator with seed +
    rank.  Returns the trace of the iterations run after the restore
    (with those before it in "resume" and "full"), the whole state at the
    end and right after the restore ("restored"), and the directory's
    files once the run is over; with the trace, whole state, seconds and
    replays of the "checkpointed" call (and in "full" of the
    "uninterrupted" one)."""
    from ffvd_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                 run_with_checkpoints)
    from ffvd_tpu_torch.utils.graphs import graph_stats
    mesh = _mesh(spec)
    tr, params = {"chains": _chain_trainer, "datasets": _dataset_trainer,
                  "sequence": _sequence_trainer}[spec["trainer"]](
                      dev, spec, mesh)[:2]

    def whole(state):
        return _state_dict(tr._whole_state(state))

    seed = spec.get("seed", 0)
    if spec.get("rank_seeds"):
        seed += torch.distributed.get_rank()
    mgr = CheckpointManager(spec["dir"], max_to_keep=spec.get("keep", 3))
    first, out, traces = spec["first"], {}, []

    def timed(key, fn, *args, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        state, trace = fn(*args, generator=_generator(dev, seed), **kw)
        _sync(dev)
        st = graph_stats(tr)
        out[key] = {"trace": _cpu(trace), "state": whole(state),
                    "seconds": time.perf_counter() - t0,
                    "replays": st["replays"] if st and st["captured"]
                    else None}
        return trace

    if spec["mode"] == "full":
        # Communicators, handles and workspaces first, untimed.
        tr.run(tr.init_state(params), 3, generator=_generator(dev, seed))
        timed("uninterrupted", tr.run, tr.init_state(params), spec["iters"])
    if spec["mode"] in ("resume", "full"):
        upto = first if spec["mode"] == "resume" else spec["iters"]
        traces.append(timed("checkpointed", run_with_checkpoints, tr,
                            tr.init_state(params), upto, mgr,
                            every=first)[:first])
    gen = _generator(dev, seed + 1000)
    state = mgr.restore(tr.init_state(params), step=first,
                        generator=gen, trainer=tr)
    # A copy: on the CPU the one-process state dict holds the live leaves.
    restored = {k: v.clone() for k, v in whole(state).items()}
    state, trace = run_with_checkpoints(tr, state, spec["iters"], mgr,
                                        every=spec["iters"], generator=gen)
    traces.append(trace)
    return {"trace": _cpu(torch.cat(traces)), "state": whole(state),
            "restored": restored,
            "files": sorted(p.name for p in mgr._dir.iterdir()),
            **out, **_capture_checks(tr, state, spec, gen, dev)}


def raise_job(dev, spec) -> Optional[str]:
    """The job ``spec["job"]`` (default "chains") of ``JOBS``, expected to
    raise on every process: a chain that starts non-finite
    (``FloatingPointError``), ranks whose generators differ at a
    checkpoint (``RuntimeError``), or a capture that the mesh's backend
    refuses (``ValueError``).  Returns the message (None if nothing was
    raised)."""
    try:
        JOBS[spec.get("job", "chains")](dev, spec)
    except (FloatingPointError, RuntimeError, ValueError) as exc:
        return str(exc)
    return None


JOBS = {"chains": chains_job, "datasets": datasets_job,
        "sequence": sequence_job, "checkpoint": checkpoint_job}


def jobs_in_turn(dev, plan) -> dict:
    """Several jobs, one after another, in one set of processes (each
    builds its own mesh on the started group): ``plan`` is a list of
    (name, job kind in ``JOBS``, spec).  Returns name → (result, seconds
    by this process's clock)."""
    out = {}
    for name, kind, spec in plan:
        t0 = time.perf_counter()
        res = JOBS[kind](dev, spec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[name] = (res, time.perf_counter() - t0)
        # Progress on stderr: where a set of ranks stops, if it does.
        print(f"rank_jobs {dev}: {name} done in {out[name][1]:.1f} s",
              file=sys.stderr, flush=True)
    return out
