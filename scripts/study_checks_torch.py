#!/usr/bin/env python3
"""The card-against-host checks behind two study pins the card missed
(ROADMAP Queue 3, S1 and S3): one fixed protocol, run on the card.

    python scripts/study_checks_torch.py > study_checks.json

**S1, actuator C4.**  From the vendored warm start, 4000 iterations
through ``study_torch.train`` (the study's run), trained these ways:

- ``card_fp32``: captured on the card in fp32, as the study ran it;
- ``card_fp32_eager``: the same, eager (``capture=False``);
- ``card_fp64``: captured on the card in fp64;
- ``cpu_fp32``, ``cpu_fp64``: on the host;
- ``card_fp32_s<n>``, ``card_fp64_s<n>``, ``cpu_fp32_s<n>`` for the starts
  n in ``STARTS``: the warm start perturbed by 1e-6 (``init_jitter``, seed
  n, the drive 12k study's starts), so the three setups start each from
  one point.

The host trainings run in ``HOST_WORKERS`` processes of one thread each
while the card trains.  Each point records its first and last training
nll and the largest after the first quarter of the iterations (a late
spike).  Every trained point is then rolled out ``DRAWS`` times by the
plain float64 rollout on the host, with normals from one host
generator (seed 0): the same normals for every point, so their RMSEs
differ by the point alone.  ``card_fp32`` is also rolled out through the
kernel with those normals and with the kernel's own noise.  Each pair of
traces that should agree (``card_fp64``/``cpu_fp64``,
``card_fp32_eager``/``card_fp32``, ``card_fp32``/``cpu_fp32``) is
reported as bit-equal or not, with the first iteration at which it parts
by more than 1e-6 relative and its largest relative difference over the
first 10, 100, 1000 and all iterations.

**The fp32 gradient, card against host.**  At the warm start and at each
``card_fp64`` and ``card_fp32`` endpoint above, rounded to float32: the
actuator C4 training gradient in fp32 on the card and on the host, each
against the fp64 gradient on the host at the same rounded leaves.  Per
point, each setup's largest leaf error over that leaf's largest fp64
gradient, and the leaf it falls on.

**S3, flutter C5 under ds64 in fp32.**  ``SAMPLER_ITERATIONS`` outer
iterations from the warm start with the same sampler normals and window
feeds (drawn on the host, seed 55), captured and eager on the card and
eager on the host: the trace pairs as above, and the largest relative
difference of a leaf, card against host.

**S2 and S4, ballbeam C2 and C6 (``--sampler``).**  Every random number
of ``SHARED_ITERATIONS`` iterations drawn once on the host in fp64 (the
sweep's ``pg=`` draws, SG-HMC's ``noise=`` and the window feed, from a
generator seeded per iteration) and cast per setup: ``card_fp32``
(captured), ``cpu_fp32``, ``card_fp64`` and ``cpu_fp64`` train from the
warm start on them (the host runs in worker processes while the card
works); the trace pairs as above.  Then ``SAMPLER_STARTS`` starts
jittered by 1e-6 (the S1 check's starts 2-5) run 4000 iterations as the
members of one ``MultiChainTrainer``, once in fp32 and once in fp64 on
the card.  Every endpoint is evaluated ``DRAWS`` times in fp64 on the
card with shared rollout normals (seed 0) and, for C2, the same thinning
normals (a fresh SG-HMC chain from a generator seeded 0); the members
also by their own ``evaluate()``.

Prints one JSON line, with the card and its power limit:
``python scripts/study_checks_torch.py`` the S1/S3 checks,
``--sampler [--out FILE]`` the S2/S4 ones (FILE rewritten after every
stage).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import multiprocessing
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from precision_hold_torch import card_name  # noqa: E402
import study_torch  # noqa: E402

ITERATIONS = 4000
DRAWS = 20
STARTS = tuple(range(2, 12))
HOST_WORKERS = 6
JITTER = 1e-6
SAMPLER_ITERATIONS = 5
SHARED_ITERATIONS = 200
SHARED_SEED = 7700
SAMPLER_STARTS = STARTS[:4]
SAMPLER_PAIRS = (("card_fp32", "cpu_fp32"), ("card_fp64", "cpu_fp64"),
                 ("card_fp32", "card_fp64"))
PAIRS = (("card_fp64", "cpu_fp64"), ("card_fp32_eager", "card_fp32"),
         ("card_fp32", "cpu_fp32"))


def _spec(start):
    return study_torch._spec(f"actuator_s{start}", "check", "actuator", 4,
                             start, "c4", True,
                             init_jitter=JITTER if start else 0.0)


def _dtype(name):
    return torch.float64 if name == "fp64" else torch.float32


def _host_train(start, dtype_name, iterations):
    """One host training in its own process: its leaves, trace, seconds."""
    torch.set_num_threads(1)
    model, train_s, _ = study_torch.train(_spec(start), iterations, "cpu",
                                          _dtype(dtype_name))
    return ({k: v.detach().numpy() for k, v in model.params.leaves().items()},
            model.nll_trace.numpy(), train_s)


def _pair(a, b) -> dict:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
    parted = np.nonzero(rel > 1e-6)[0]
    return {"bit_equal": bool(np.array_equal(a, b)),
            "first_rel_1e-6": int(parted[0]) if parted.size else None,
            **{f"max_rel_{n}": float(rel[:n].max())
               for n in (10, 100, 1000) if n < rel.size},
            "max_rel_all": float(rel.max())}


def actuator_c4(device, iterations=ITERATIONS, draws=DRAWS,
                starts=STARTS) -> dict:
    """S1: the actuator C4 points, their plain rollouts and trace pairs;
    also the trained points' leaves (for ``fp32_gradient_error``)."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.model.params import params_from_numpy
    host_jobs = {"cpu_fp32": (0, "fp32"), "cpu_fp64": (0, "fp64"),
                 **{f"cpu_fp32_s{s}": (s, "fp32") for s in starts}}
    card_jobs = {"card_fp32": (0, "fp32", None),
                 "card_fp32_eager": (0, "fp32", False),
                 "card_fp64": (0, "fp64", None),
                 **{f"card_{p}_s{s}": (s, p, None)
                    for s in starts for p in ("fp32", "fp64")}}
    points, traces, seconds = {}, {}, {}
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(min(HOST_WORKERS, len(host_jobs)),
                                mp_context=ctx) as pool:
        futures = {name: pool.submit(_host_train, s, dt, iterations)
                   for name, (s, dt) in host_jobs.items()}
        for name, (s, dt, capture) in card_jobs.items():
            model, seconds[name], _ = study_torch.train(
                _spec(s), iterations, device, _dtype(dt), capture=capture)
            if name == "card_fp32":
                kept = model
            points[name] = {k: v.detach().cpu().numpy()
                            for k, v in model.params.leaves().items()}
            traces[name] = model.nll_trace.cpu().numpy()
        for name, fut in futures.items():
            points[name], traces[name], seconds[name] = fut.result()

    cfg = kept.cfg
    shape = (cfg.num_posterior_samples, kept.dataset.n_test,
             kept.params.x.shape[1])
    g = torch.Generator().manual_seed(0)
    noises = [torch.randn(shape, generator=g, dtype=torch.float64)
              for _ in range(draws)]
    plain = {}
    for name, leaves in points.items():
        host = FFVDModel(cfg, device="cpu", dtype=torch.float64,
                         params=params_from_numpy(leaves))
        plain[name] = [host.evaluate(noise=n)["rmse"] for n in noises]
    kernel = [kept.evaluate(noise=n.to(kept.device, kept.dtype))["rmse"]
              for n in noises]
    own = [kept.evaluate()["rmse"] for _ in range(draws)]
    return {"iterations": iterations, "draws": draws, "jitter": JITTER,
            "points": {name: {"nll_first": float(t[0]),
                              "nll_last": float(t[-1]),
                              "nll_max_late": float(t[len(t) // 4:].max()),
                              "train_s": seconds[name],
                              "rmse_plain_fp64": plain[name],
                              "rmse_median": float(np.median(plain[name]))}
                       for name, t in traces.items()},
            "card_fp32_kernel": kernel, "card_fp32_own_draws": own,
            "max_rel_kernel_vs_plain": max(
                abs(a - b) / abs(b)
                for a, b in zip(kernel, plain["card_fp32"])),
            "pairs": {f"{a}|{b}": _pair(traces[a], traces[b])
                      for a, b in PAIRS}}, points


def fp32_gradient_error(device, points) -> dict:
    """The fp32 training gradient of actuator C4 on the card and on the
    host against the host's fp64 one, at the warm start and at the card's
    trained ``points``, all rounded to float32."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.inference.trainer import Trainer, grads_of
    from ffvd_tpu_torch.model.params import (
        SSMData, init_params_from_warmstart, params_from_numpy,
        params_to_numpy)
    cfg = FFVDConfig(dataset="actuator", case=4)
    ds = create_dataset("actuator")
    trainers = {}
    for dev, dt in ((device, torch.float32), ("cpu", torch.float32),
                    ("cpu", torch.float64)):
        as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        trainers[(str(dev), dt)] = Trainer(cfg, SSMData(
            y=as_t(ds.y_train), control=as_t(ds.control)))

    def grad(leaves, dev, dt):
        p = params_from_numpy(leaves, device=dev, dtype=dt)
        req = {k: v.requires_grad_(True) for k, v in p.leaves().items()}
        nll = trainers[(str(dev), dt)].train_nll(type(p).from_leaves(req))
        return {k: g.detach().cpu().double().numpy()
                for k, g in zip(req, grads_of(nll, list(req.values())))}

    start = params_to_numpy(init_params_from_warmstart(
        load_warmstart("actuator")))
    named = {"warm_start": start,
             **{k: v for k, v in points.items() if k.startswith("card_fp")
                and not k.endswith("eager")}}
    out = {}
    for name, leaves in named.items():
        leaves = {k: np.asarray(v, np.float32).astype(np.float64)
                  for k, v in leaves.items()}
        ref = grad(leaves, "cpu", torch.float64)
        row = {}
        for setup, dev in (("card", device), ("host", "cpu")):
            g = grad(leaves, dev, torch.float32)
            err = {k: float(np.abs(g[k] - ref[k]).max()
                            / max(np.abs(ref[k]).max(), 1e-300))
                   for k in ref}
            worst = max(err, key=err.get)
            row[setup] = {"max_rel": err[worst], "leaf": worst}
        out[name] = row
    ratio = [r["card"]["max_rel"] / max(r["host"]["max_rel"], 1e-300)
             for r in out.values()]
    return {"points": out, "median_card_over_host": float(np.median(ratio))}


def flutter_c5_ds64(device, iterations=SAMPLER_ITERATIONS) -> dict:
    """S3: flutter C5 under ds64 in fp32 with shared sampler draws,
    captured and eager on the card and eager on the host."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
    from ffvd_tpu_torch.model.params import (SSMData,
                                             init_params_from_warmstart)
    cfg = FFVDConfig(dataset="flutter", case=5, collapse_precision="ds64")
    ds = create_dataset("flutter")
    ws = load_warmstart("flutter")
    g = torch.Generator().manual_seed(55)
    draws, runs = None, {}
    for name, dev, capture in (("cpu", "cpu", False),
                               ("card", device, None),
                               ("card_eager", device, False)):
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        tr = Trainer(cfg, SSMData(y=as_t(ds.y_train),
                                  control=as_t(ds.control)))
        state = tr.init_state(init_params_from_warmstart(
            ws, device=dev, dtype=torch.float32))
        if draws is None:
            sub = tr.subset.split(state.params)
            draws = [{"noise": {k: torch.randn(
                (len(SUBSTEP_FLAGS),) + tuple(v.shape), generator=g,
                dtype=torch.float32) for k, v in sub.items()},
                "feed": int(torch.randint(0, i + 1, (), generator=g))}
                for i in range(iterations)]
        state, trace = tr.run(state, iterations, capture=capture, draws=[
            {"noise": {k: v.to(dev) for k, v in d["noise"].items()},
             "feed": d["feed"]} for d in draws])
        runs[name] = (trace.cpu().numpy(),
                      {k: v.detach().cpu().double() for k, v
                       in state.params.leaves().items()})
    leaf_rel = max(
        float(((runs["card"][1][k] - v).abs().max()
               / v.abs().max().clamp_min(1e-300)))
        for k, v in runs["cpu"][1].items())
    return {"iterations": iterations,
            "nll_last": {k: float(v[0][-1]) for k, v in runs.items()},
            "pairs": {"card_eager|card": _pair(runs["card_eager"][0],
                                               runs["card"][0]),
                      "card|cpu": _pair(runs["card"][0], runs["cpu"][0])},
            "max_rel_leaf_card_vs_cpu": leaf_rel}


def _sampler_trainer(case, dev, dtype):
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import SSMData
    cfg = FFVDConfig(dataset="ballbeam", case=case)
    ds = create_dataset("ballbeam")
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return Trainer(cfg, SSMData(y=as_t(ds.y_train), control=as_t(ds.control)),
                   pg_fn=make_pg_fn(cfg) if case == 6 else None)


def _warm(dev, dtype):
    from ffvd_tpu_torch.data import load_warmstart
    from ffvd_tpu_torch.model.params import init_params_from_warmstart
    return init_params_from_warmstart(load_warmstart("ballbeam"), device=dev,
                                      dtype=dtype)


def shared_draw(tr, i: int) -> dict:
    """Iteration ``i``'s draws, made on the host in fp64 from a generator
    seeded ``SHARED_SEED + i``: C6's sweep draws (``pg_draws``), or C2's 21
    sub-steps' normals and its window feed."""
    from ffvd_tpu_torch.inference.particle_gibbs import pg_draws
    from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS
    g = torch.Generator().manual_seed(SHARED_SEED + i)
    host = _warm("cpu", torch.float64)
    if tr.cfg.case_config.x_pg:
        return {"pg": pg_draws(tr.cfg, host, g)}
    sub = tr.subset.split(host)
    return {"noise": {k: torch.randn((len(SUBSTEP_FLAGS),) + tuple(v.shape),
                                     generator=g, dtype=torch.float64)
                      for k, v in sub.items()},
            "feed": int(torch.randint(0, min(i + 1, tr.cfg.window_size), (),
                                      generator=g))}


def _cast(d, dev, dtype):
    if isinstance(d, dict):
        return {k: _cast(v, dev, dtype) for k, v in d.items()}
    if torch.is_tensor(d):
        return d.to(dev, dtype if d.is_floating_point() else d.dtype)
    return d


def shared_run(case, dev, dtype, iterations, capture=None):
    """``iterations`` of ballbeam C``case`` from the warm start on the
    shared draws: (nll trace, leaves), as numpy."""
    tr = _sampler_trainer(case, dev, dtype)
    state = tr.init_state(_warm(dev, dtype))
    draws = (_cast(shared_draw(tr, i), dev, dtype) for i in range(iterations))
    state, trace = tr.run(state, iterations, capture=capture, draws=draws)
    return (trace.cpu().numpy(),
            {k: v.detach().cpu().numpy()
             for k, v in state.params.leaves().items()})


def _host_shared(case, dtype_name, iterations):
    torch.set_num_threads(1)
    return shared_run(case, "cpu", _dtype(dtype_name), iterations, False)


def endpoint_rmse(case, leaves, device, draws):
    """An endpoint's RMSEs in fp64 on ``device`` over ``draws``
    evaluations with the shared rollout normals (a host generator seeded
    0) and, for C2, the thinning normals of the model's generator seeded 0
    (a fresh SG-HMC chain): every endpoint sees the same draws."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.model.params import params_from_numpy
    model = FFVDModel(FFVDConfig(dataset="ballbeam", case=case, seed=0),
                      device=device, dtype=torch.float64,
                      params=params_from_numpy(leaves))
    g = torch.Generator().manual_seed(0)
    shape = (model.cfg.num_posterior_samples, model.dataset.n_test,
             model.params.x.shape[1])
    return [model.evaluate(noise=torch.randn(
        shape, generator=g, dtype=torch.float64).to(model.device))["rmse"]
        for _ in range(draws)]


def member_state(trainer, state, i):
    """Member ``i`` of a chain-stacked ``TrainState`` as a one-model state:
    its leaves, SG-HMC chain and window (Adam starts afresh; ``evaluate``
    does not read it)."""
    from ffvd_tpu_torch.parallel.sharding import member
    st = trainer.init_state(member(state.params, i))
    with torch.no_grad():
        if state.sghmc is not None:
            st.sghmc.assign_(state.sghmc.map(lambda t: t[i]))
        for k, w in state.window.items():
            st.window[k].copy_(w[i])
        st.counts.copy_(state.counts)
    return st


def jittered_chains(case, dev, dtype, iterations, starts):
    """The ``starts`` (jittered by ``JITTER``) as the members of one
    ``MultiChainTrainer`` on ``dev``: each member's leaves, its own
    ``evaluate()`` RMSE and the group's seconds."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.ensemble import jitter_params
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.parallel.sharding import (MultiChainTrainer, member,
                                                  stack_members)
    models = [FFVDModel(FFVDConfig(dataset="ballbeam", case=case, seed=s),
                        device=dev, dtype=dtype) for s in starts]
    cfg = models[0].cfg
    mct = MultiChainTrainer(cfg, models[0].data, len(starts),
                            pg_fn=make_pg_fn(cfg) if case == 6 else None)
    state = mct.init_state(stack_members([
        jitter_params(m.params, JITTER, s) for m, s in zip(models, starts)]))
    gen = torch.Generator(device=models[0].device).manual_seed(starts[0])
    study_torch._sync(models[0].device)
    t0 = time.time()
    state, trace = mct.run(state, iterations, generator=gen)
    study_torch._sync(models[0].device)
    seconds = time.time() - t0
    out = []
    for i, m in enumerate(models):
        m.state = member_state(m.trainer, state, i)
        out.append({"leaves": {k: v.detach().cpu().numpy() for k, v
                               in member(state.params, i).leaves().items()},
                    "rmse_own": m.evaluate()["rmse"],
                    "nll_last": float(trace[-1, i])})
    return out, seconds


def sampler_checks(device, case, iterations=SHARED_ITERATIONS,
                   long_iterations=ITERATIONS, draws=DRAWS,
                   starts=SAMPLER_STARTS, host=None, save=None) -> dict:
    """S2 (case 2) or S4 (case 6): the shared-draw pairs, then the
    jittered fp32 and fp64 chains on the card, every endpoint rolled out
    in fp64 on the card with shared draws.  ``host``: the futures of
    this case's host runs ({"cpu_fp32": ..., "cpu_fp64": ...}), submitted
    by the caller so that they overlap the card's work; run here in one
    process when None.  ``save(partial)`` is called after each stage."""
    save = save or (lambda partial: None)
    out = {"case": f"C{case}", "iterations": iterations,
           "long_iterations": long_iterations, "draws": draws,
           "starts": list(starts)}
    t0 = time.time()
    runs = {f"card_{p}": shared_run(case, device, _dtype(p), iterations)
            for p in ("fp32", "fp64")}
    runs.update({f"cpu_{p}": (host[f"cpu_{p}"].result() if host
                              else _host_shared(case, p, iterations))
                 for p in ("fp32", "fp64")})
    rmse = {k: endpoint_rmse(case, r[1], device, draws)
            for k, r in runs.items()}
    out["pairs"] = {f"{a}|{b}": _pair(runs[a][0], runs[b][0])
                    for a, b in SAMPLER_PAIRS}
    out["shared"] = {k: {"nll_last": float(r[0][-1]),
                         "rmse_fp64": rmse[k],
                         "rmse_median": float(np.median(rmse[k]))}
                     for k, r in runs.items()}
    out["shared_seconds"] = time.time() - t0
    save(out)
    out["jittered"], out["jittered_seconds"] = {}, {}
    for p in ("fp32", "fp64"):
        members, out["jittered_seconds"][p] = jittered_chains(
            case, device, _dtype(p), long_iterations, starts)
        for s, m in zip(starts, members):
            r = endpoint_rmse(case, m["leaves"], device, draws)
            out["jittered"][f"card_{p}_s{s}"] = {
                "nll_last": m["nll_last"], "rmse_own": m["rmse_own"],
                "rmse_fp64": r, "rmse_median": float(np.median(r))}
        save(out)
    return out

def main(device=None, sampler=None, out_path=None, **kw) -> dict:
    """The checks on ``device`` (the card unless the caller asks for the
    CPU): S1 and S3, ``kw`` going to ``actuator_c4``; or, with
    ``sampler`` (a dict of ``sampler_checks`` keywords, ``{}`` for the
    protocol's), S4 and S2, written to ``out_path`` after every stage."""
    from ffvd_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    t0 = time.time()
    out = {"card": card_name(torch) if device.type == "cuda" else "cpu"}

    def save(name):
        def put(partial):
            out[name] = partial
            out["seconds"] = time.time() - t0
            if out_path:
                Path(out_path).write_text(json.dumps(out))
            done = sorted(k for k in partial
                          if k in ("pairs", "shared", "jittered"))
            print(f"[{out['seconds']:.0f} s] {name}: {done}",
                  file=sys.stderr, flush=True)
        return put

    if sampler is not None:
        n = sampler.get("iterations", SHARED_ITERATIONS)
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(4, mp_context=ctx) as pool:
            host = {case: {f"cpu_{p}": pool.submit(_host_shared, case, p, n)
                           for p in ("fp32", "fp64")} for case in (6, 2)}
            out["c6"] = sampler_checks(device, 6, host=host[6],
                                       save=save("c6"), **sampler)
            out["c2"] = sampler_checks(device, 2, host=host[2],
                                       save=save("c2"), **sampler)
    else:
        out["actuator_c4"], points = actuator_c4(device, **kw)
        out["fp32_gradient"] = fp32_gradient_error(device, points)
        out["flutter_c5_ds64"] = flutter_c5_ds64(device)
    out["seconds"] = time.time() - t0
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    main(sampler={} if "--sampler" in args else None,
         out_path=args[args.index("--out") + 1] if "--out" in args else None)
