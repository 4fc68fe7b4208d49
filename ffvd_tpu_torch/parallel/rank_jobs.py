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
``draws`` (one dict of whole ``outer_step`` keywords per iteration).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


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
    from ffvd_tpu_torch.parallel.sharding import _adam_paths
    out = {f"params.{k}": v for k, v in state.params.leaves().items()}
    if state.sghmc is not None:
        for f in ("xi", "g", "g2", "p"):
            out.update({f"sghmc.{f}.{k}": v
                        for k, v in getattr(state.sghmc, f).items()})
    out.update({f"window.{k}": v for k, v in state.window.items()})
    if state.adam is not None:
        for k, p in zip(_adam_paths(state),
                        state.adam.param_groups[0]["params"]):
            st = state.adam.state.get(p, {})
            for f in ("exp_avg", "exp_avg_sq"):
                if f in st:
                    out[f"adam.{f}.{k}"] = st[f]
    return _cpu(out)


def _timed_iters(trainer, state, n: int, gen, dev) -> dict:
    """ms per iteration over ``n`` iterations, and the share of the wall
    time this process spent inside the collectives: ``torch.profiler``'s
    host time of ``distributed.COLLECTIVE_LABEL`` over n/10 more (the
    whole all-reduce under gloo, which waits for it; the enqueue only
    under NCCL)."""
    from ffvd_tpu_torch.parallel.distributed import COLLECTIVE_LABEL
    from ffvd_tpu_torch.utils.timing import hard_sync
    hard_sync(dev)
    t0 = time.perf_counter()
    trainer.run(state, n, generator=gen)
    hard_sync(dev)
    wall = time.perf_counter() - t0
    m = max(n // 10, 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        p0 = time.perf_counter()
        trainer.run(state, m, generator=gen)
        hard_sync(dev)
        p_wall = time.perf_counter() - p0
    coll = [e for e in prof.key_averages() if e.key == COLLECTIVE_LABEL]
    coll_s = sum(e.cpu_time_total for e in coll) * 1e-6
    return {"ms_per_iter": 1e3 * wall / n, "iters": n,
            "collective_share": coll_s / p_wall,
            "collectives_per_iter": sum(e.count for e in coll) / m,
            "profiled_iters": m}


def chains_job(dev, spec) -> dict:
    """``MultiChainTrainer`` over the whole ``leaves``: ``iters``
    iterations, then (``spec["moments"]``: test_len, seed) the chains'
    ``multichain_moments``.  Returns the whole trace and state, the
    moments, this process's rollout launches and, with ``spec["timed"]``
    (iterations), ``_timed_iters``'s numbers."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.ensemble import multichain_moments
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
    from ffvd_tpu_torch.ops import rollout as ro
    from ffvd_tpu_torch.parallel.sharding import (MultiChainTrainer,
                                                  gather_chain_state)
    dtype = DTYPES[spec.get("dtype", "float64")]
    cfg = FFVDConfig(**spec["cfg"])
    mesh = _mesh(spec)
    data = SSMData(y=_to(spec["y"], dev, dtype),
                   control=_to(spec["control"], dev, dtype))
    mct = MultiChainTrainer(cfg, data, spec["leaves"]["x"].shape[0],
                            mesh=mesh,
                            pg_fn=make_pg_fn(cfg) if cfg.case == 6 else None)
    state = mct.init_state(GPSSMParams.from_leaves(
        _to(spec["leaves"], dev, dtype)))
    gen = _generator(dev, spec.get("seed", 0))
    draws = _to(spec.get("draws"), dev, dtype)
    state, trace = mct.run(state, spec["iters"], generator=gen, draws=draws,
                           chunk_size=spec.get("chunk", 500))
    out = {"trace": _cpu(trace)}
    whole = state if mesh is None else gather_chain_state(state, mesh)
    out["state"] = _state_dict(whole)
    if spec.get("moments"):
        mo = spec["moments"]
        ro.rollout.log.clear()
        ro.rollout.launches = 0
        calls, batched = [], ro.rollout_batched

        def spy(**kw):      # (rows, row_offset) of every call, either device
            calls.append((kw["x0"].shape[0], kw.get("row_offset", 0)))
            return batched(**kw)

        ro.rollout_batched = spy
        try:
            chains, _ = multichain_moments(
                mct, state, mo["test_len"],
                generator=_generator(dev, mo["seed"]),
                thin_generator=_generator(dev, mo["seed"] + 1),
                noise=_to(mo.get("noise"), dev, dtype))
        finally:
            ro.rollout_batched = batched
        out["moments"] = chains
        out["rollout_calls"] = calls
        out["launches"] = ro.rollout.launches
        out["launch_rows"] = [rows for rows, _ in ro.rollout.log]
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
        out["timed"] = _timed_iters(mct, state, spec["timed"], gen, dev)
    return out


def datasets_job(dev, spec) -> dict:
    """``MultiDatasetTrainer`` on ``spec["names"]`` (``stack_datasets``,
    ``spec["m"]`` inducing points), ``iters`` iterations, then
    ``evaluate`` (``spec["eval_seed"]``) on the whole list.  Returns the
    whole trace, the whole state and the results dict."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.parallel.multidataset import (MultiDatasetTrainer,
                                                      stack_datasets)
    from ffvd_tpu_torch.parallel.sharding import gather_chain_state
    dtype = DTYPES[spec.get("dtype", "float64")]
    cfg = FFVDConfig(**spec["cfg"])
    mesh = _mesh(spec)
    names = spec["names"]
    data, params, lens = stack_datasets(names, m=spec.get("m"), device=dev,
                                        dtype=dtype)
    mdt = MultiDatasetTrainer(cfg, data, mesh=mesh)
    state = mdt.init_state(params)
    gen = _generator(dev, spec.get("seed", 0))
    t0 = time.perf_counter()
    state, trace = mdt.run(state, spec["iters"], generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    out = {"trace": _cpu(trace), "train_s": train_s}
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
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import GPSSMParams, SSMData
    from ffvd_tpu_torch.parallel.sequence import SequenceShardedTrainer
    dtype = DTYPES[spec.get("dtype", "float64")]
    cfg = FFVDConfig(**spec["cfg"])
    mesh = _mesh(spec)
    data = SSMData(y=_to(spec["y"], dev, dtype),
                   control=_to(spec["control"], dev, dtype))
    tr = Trainer(cfg, data, pg_fn=make_pg_fn(cfg) if cfg.case == 6 else None)
    if mesh is not None:
        tr = SequenceShardedTrainer(tr, mesh).trainer
    state = tr.init_state(GPSSMParams.from_leaves(
        _to(spec["leaves"], dev, dtype)))
    gen = _generator(dev, spec.get("seed", 0))
    state, trace = tr.run(state, spec["iters"], generator=gen,
                          draws=_to(spec.get("draws"), dev, dtype),
                          chunk_size=spec.get("chunk", 500))
    out = {"trace": _cpu(trace), "state": _state_dict(state)}
    if spec.get("timed"):
        out["timed"] = _timed_iters(tr, state, spec["timed"], gen, dev)
    return out


def grads_job(dev, spec) -> Dict[str, torch.Tensor]:
    """Per-leaf gradients of one training objective, through the trainer's
    own hooks: the ('dp','ep') chain trainer (``spec["axis"]`` "ep") or the
    'sp' trainer ("sp"), ``autograd.grad`` of this process's objective,
    then ``_reduce_grads``, then gathered whole.  With ``mesh`` None it is
    the unsharded ``autograd.grad``.  Returns path → gradient, and "nll"."""
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
        nll = tr.train_nll(params, eps=eps)
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


def raise_job(dev, spec) -> Optional[str]:
    """``chains_job`` whose chain ``spec["bad"]`` starts non-finite: every
    process must raise the same ``FloatingPointError``; returns its
    message (None if nothing was raised)."""
    try:
        chains_job(dev, spec)
    except FloatingPointError as exc:
        return str(exc)
    return None


JOBS = {"chains": chains_job, "datasets": datasets_job,
        "sequence": sequence_job}


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
    return out
