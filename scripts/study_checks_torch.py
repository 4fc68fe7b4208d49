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

Prints one JSON line, with the card and its power limit.
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


def main(device=None, **kw) -> dict:
    """The checks on ``device`` (the card unless the caller asks for the
    CPU); ``kw`` goes to ``actuator_c4``."""
    from ffvd_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    t0 = time.time()
    out = {"card": card_name(torch) if device.type == "cuda" else "cpu"}
    out["actuator_c4"], points = actuator_c4(device, **kw)
    out["fp32_gradient"] = fp32_gradient_error(device, points)
    out["flutter_c5_ds64"] = flutter_c5_ds64(device)
    out["seconds"] = time.time() - t0
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
