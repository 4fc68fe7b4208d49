#!/usr/bin/env python3
"""The full-protocol study of ``ffvd_tpu_torch``: the case populations of
the JAX package's study scripts, run on one GPU and kept in one resumable
JSON file.

    python scripts/study_torch.py [--arms c4_six,c2,...]
        [--out tests/golden_torch/study_h100.json] [--quick]
        [--device cuda|cpu] [--dtype fp32|fp64] [--match REGEX]
        [--stop-after SECONDS] [--commit TEXT]

Each run is the path a user runs: ``FFVDModel(cfg, device=...)`` from the
vendored warm start (``file_id=3``), ``fit`` for the protocol's 4000 outer
iterations (2 × ``iterations=2000``), ``evaluate()`` (10 rollouts,
RMSE/NLL over the first 30 test steps).  One model a run ("mode":
"trainer"); the seeds are independent draws of the port's generators, not
JAX's streams, so a run is held against the JAX population, never against
the JAX run of the same seed.  The arms, each keyed by the tags of the JAX
artifact it mirrors:

- ``c4_six``: C4 on the six datasets, seed 0 (``tests/golden/
  run_ours_e2e.py`` → ``ours_e2e_tpu_fp32.json`` ``<dataset>``);
- ``c2``, ``c3``: ballbeam C2 seeds 0-8, C3 seeds 0-5 (the same script →
  ``ballbeam_C2``, ``ballbeam_C2_seed1..8``; ``ballbeam_C3``,
  ``ballbeam_C3_seed1..5``);
- ``c5_ballbeam``: ballbeam C5 seeds 0-4 (``escape_validation.py`` →
  ``ballbeam_C5_s0..4``);
- ``c5_flutter``: flutter C5 seeds 0-4, native and
  ``collapse_precision="ds64"`` (→ ``flutter_C5_s0..4``,
  ``flutter_C5_s0..4_ds64``);
- ``c6_ballbeam``: ballbeam C6 seeds 0-4 (P=100, ancestor trace, the
  defaults), with mixing diagnostics from a side sweep of
  ``make_pg_fn(cfg, with_stats=True)`` every 400 iterations on the current
  parameters, its generator seeded 1000 + seed (``pg_c6_study.py`` →
  ``ballbeam_C6_ancestor_s0..4``);
- ``deep2``: C4 with ``n_layers=2`` on flutter and drive, seeds 0-2
  (``run_ours_e2e.py`` → ``<dataset>_C4_deep2``, ``..._seed1``,
  ``..._seed2``);
- ``drive12k``: drive C4 with ``rollout_qsqrt_dim0=True`` for 12,000
  iterations (``fp32_stall_study.py`` → ``drive_long12k_s<n>``, ``_ds64``,
  ``_fp64cpu``), three arms a start: native and ds64 in ``--dtype``, and
  native in fp64 on the same device, which stands for the JAX study's fp64
  CPU control and keeps its tag.  C4 training draws nothing, so seeds alone
  would repeat one run: start 1 is the exact warm start, starts 2-5 add
  ``init_jitter=1e-6`` (``eval/ensemble.py::jitter_params``, the perturbed
  start of an ensemble's chains).  Each arm is
  ``scripts/precision_hold_torch.py::run_arm``.

A record holds the run's settings, ``iterations`` (the length of its
training nll trace), ``rmse`` and ``nll``, the first and last training
nll, the learned ``Q``, ``max_Q`` and ``budget_s2C2``, ``train_s`` (``fit``
with the device synchronised, CUDA-graph capture included),
``it_per_s``, ``eval_ms``; ``clip_saturated`` where the kernel hypers are
sampled (C2, C3, C5: a log hyper within 1e-3 of ``log_clip_bounds``, as
``tests/golden/escape_validation.py:86-90``); ``mixing_mean`` and
``mixing_seq`` on C6.  The file's ``header`` names the card (``nvidia-smi
--query-gpu=name,power.limit``), torch, the commit and the date, and
``calls`` lists each call that added runs.

The file resumes: a run whose tag is present is skipped, so the study can
be split over calls (``--arms``, ``--match`` to keep only tags matching a
regular expression, ``--stop-after`` to start no run after that many
seconds).  ``--quick`` keeps the widths and cuts every run (C4 and deep
50 iterations, C2/C3/C5 3, C6 2, the 12k arms 50) and every arm to its
first seed; a quick file and a full one never mix.  It runs on ``cuda``
unless given ``--device cpu`` (fp64 on the CPU, as the port's tests run),
and raises where there is no card.

**The other arms** (the rest of the JAX study layer):

- ``c6_ballbeam_fp64``, ``c2_fp64``: ``c6_ballbeam`` and C2 seeds 0-4 in
  fp64 on the card (tags ``..._fp64card``): does the fp64 card land in
  JAX's populations where fp32 does not (ROADMAP Queue 3, S2 and S4);
- ``actuator_prec``: actuator C4 under ``collapse_precision="ds64"`` and
  ``"hybrid"`` from the 11 starts of ``study_checks_torch.py``'s S1 check
  (``actuator_ds64_j0..10``, ``actuator_hybrid_j0..10``: j0 the warm
  start, j1..10 its starts 2-11, jittered by 1e-6);
- ``c6_drive``, ``c6_live``, ``c6_p500``, ``c6_matrix``: the C6 dataset
  matrix of ``tests/golden/pg_c6_study.py`` and ``pg_live_sweep.py``,
  under the JAX tags (drive ancestor s0-7 with the mixing side sweep,
  ballbeam live s0-4 and live P=500 s0-2, drive and ballbeam ancestor
  P=500, gas_furnace, dryer, flutter and actuator ancestor s0-2, flutter
  deep-2 s0-2).  Each series of seeds runs as the members of one
  ``MultiChainTrainer`` ("mode": "chains"): started exactly at the warm
  start (the members' params stacked, no jitter), the batched sweep
  drawing every member's sweep from one generator seeded with the first
  seed, each member then evaluated as a run of its own (its
  ``FFVDModel``, host generator seeded with its seed).  A drive member
  above RMSE 1.5 is evaluated 9 more times and once at ``num=40``
  (``<tag>_redraw``, after ``tests/golden/pg_c6_redraw.py``);
- ``ensemble``: the 27 entries of ``tests/golden/ensemble_study.py``
  through ``fit_ensemble`` / ``ensemble_evaluate``, keyed
  ``ensemble/<JAX tag>`` (the JAX tags of the C4 rows are the dataset
  names, which ``c4_six`` holds);
- ``nll_slip``: ``tests/golden/nll_study.py``'s drive and flutter C4 with
  ``rollout_qsqrt_dim0=True``, seeds 1-3 in ``--dtype`` and
  ``_slip_fp64cpu_s1`` in fp64 on the same device;
- ``coldstart``: ``tests/golden/hybrid_coldstart_study.py``'s kink cold
  start (N=120, M=20, D=1, a random start), seeds 0-4 × native, ds64,
  hybrid (the last 500 of 4000 iterations on the float64 segment), with
  the final nll under the ds64 bound and 1- and 5-step RMSE;
- ``stall``: ``tests/golden/fp32_stall_study.py``'s flutter 12k native
  and ds64, and the polish schedules on drive and flutter (4000, then
  4000 at lr/10; 4000, 2000 at lr/10, 2000 at lr/100);
- ``escape``: ``tests/golden/escape_validation.py``'s flutter C5 seeds
  0-3 under ``"hybrid"`` and seeds 0-2 with ``sghmc_spike_clip=10``;
- ``c2_precision``: ``tests/golden/c2_precision_study.py``'s ballbeam C2
  seeds 20-24, native and "dsprecal": ``model/ds_collapse.py::ds_precal``
  (the Kmm factorisation in float64) in place of ``kernel_precal`` in the
  C2 objective, substituted here as the JAX script substitutes it.

**The last arms** (ROADMAP Queue 3, F2, and item 23):

- ``flutter_fp64``: flutter in fp64 on the same device, the float64
  reference the ds64 runs of ``c5_flutter`` and ``stall`` are read
  against: C5 seeds 0-4 (``flutter_C5_s0..4_fp64card``) and the ``stall``
  arm's flutter C4 12k (``flutter_long12k_s1_fp64cpu``, the JAX study's
  tag pattern for its fp64 control);
- ``config4``: BASELINE.md config 4, C4 on drive and flutter at
  ``x_dim`` 2, 4 and 6 with ``num_posterior_samples=20`` and
  ``posterior_sample_spacing=50`` (keys of ``tests/golden/
  ours_config4_xdims.json``: ``drive_xd2`` .. ``flutter_xd6``;
  ``--quick`` keeps drive's three, so the x_dim 6 launch is exercised);
- ``config2``: BASELINE.md config 2, C4 with ``kernel_type="LinearK"``
  on gas_furnace and dryer (``gas_furnace_C4_linear``,
  ``dryer_C4_linear``; the JAX package has no record of them).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from precision_hold_torch import card_name, fitted_summary, run_arm  # noqa: E402

OUT = ROOT / "tests" / "golden_torch" / "study_h100.json"
ARMS = ("c4_six", "c2", "c3", "c5_ballbeam", "c5_flutter", "c6_ballbeam",
        "deep2", "drive12k", "c6_ballbeam_fp64", "c2_fp64", "actuator_prec",
        "c6_drive", "c6_live", "c6_p500", "c6_matrix", "ensemble",
        "nll_slip", "coldstart", "stall", "escape", "c2_precision",
        "flutter_fp64", "config4", "config2")
SIX = ("ballbeam", "drive", "gas_furnace", "dryer", "actuator", "flutter")
FULL = {"c4": 4000, "sampler": 4000, "c6": 4000, "12k": 12000,
        "cold": 4000, "polish": 8000}
QUICK = {"c4": 50, "sampler": 3, "c6": 2, "12k": 50, "cold": 20,
         "polish": 8}
MIXING_EVERY = 400
JITTER_12K = 1e-6
# The S1 check's starts (scripts/study_checks_torch.py): the warm start,
# then starts 2-11 jittered by 1e-6.
S1_STARTS = (0,) + tuple(range(2, 12))
COLD_TAIL = {"full": 500, "quick": 5}
POLISH = {"polish": ((0.5, 1.0), (0.5, 0.1)),
          "polish2": ((0.5, 1.0), (0.25, 0.1), (0.25, 0.01))}
REDRAW_ABOVE = 1.5


def _spec(tag, arm, dataset, case, seed, kind, first, **kw):
    return {"tag": tag, "arm": arm, "dataset": dataset, "case": case,
            "seed": seed, "kind": kind, "first": first,
            "collapse_precision": kw.get("collapse_precision", "native"),
            "n_layers": kw.get("n_layers", 1),
            "init_jitter": kw.get("init_jitter", 0.0),
            "dtype": kw.get("dtype"), "cfg": kw.get("cfg", {}),
            "mode": kw.get("mode", "trainer"), "group": kw.get("group"),
            "extra": kw.get("extra", {})}


def _chains(arm, prefix, dataset, seeds, cfg, extra=None, n_layers=1):
    """A series of C6 seeds run as the members of one MultiChainTrainer."""
    return [_spec(f"{prefix}_s{s}", arm, dataset, 6, s, "c6", s in seeds[:2],
                  cfg=cfg, mode="chains", group=prefix, n_layers=n_layers,
                  extra=extra or {}) for s in seeds]


def _ensemble_runs(arm):
    out = []
    for ds in SIX:
        out.append(_spec(f"ensemble/{ds}", arm, ds, 4, 0, "c4", ds == SIX[0],
                         mode="ensemble", extra={"chains": 4}))
        out.append(_spec(f"ensemble/{ds}_1chain_n40spread", arm, ds, 4, 0,
                         "c4", ds == SIX[0], mode="ensemble",
                         extra={"chains": 1}))
        out.append(_spec(f"ensemble/{ds}_jit4", arm, ds, 4, 0, "c4",
                         ds == SIX[0], mode="ensemble", init_jitter=1e-3,
                         extra={"chains": 4}))
        out.append(_spec(f"ensemble/{ds}_deep2_ens4", arm, ds, 4, 0, "c4",
                         ds == SIX[0], mode="ensemble", n_layers=2,
                         extra={"chains": 4}))
    out.append(_spec("ensemble/flutter_C5", arm, "flutter", 5, 0, "sampler",
                     True, mode="ensemble", extra={"chains": 4}))
    out.append(_spec("ensemble/ballbeam_C2_ens4", arm, "ballbeam", 2, 10,
                     "sampler", True, mode="ensemble", extra={"chains": 4}))
    out.append(_spec("ensemble/flutter_C6_ens4", arm, "flutter", 6, 0, "c6",
                     True, mode="ensemble", extra={"chains": 4}))
    return out


def arm_runs(arm: str) -> list:
    """The runs of one arm, in order; ``first`` marks each group's first
    seed (the run ``--quick`` keeps)."""
    if arm == "c4_six":
        return [_spec(ds, arm, ds, 4, 0, "c4", True) for ds in SIX]
    if arm in ("c2", "c3"):
        case, n = (2, 9) if arm == "c2" else (3, 6)
        return [_spec(f"ballbeam_C{case}" + (f"_seed{s}" if s else ""), arm,
                      "ballbeam", case, s, "sampler", s == 0)
                for s in range(n)]
    if arm == "c5_ballbeam":
        return [_spec(f"ballbeam_C5_s{s}", arm, "ballbeam", 5, s, "sampler",
                      s == 0) for s in range(5)]
    if arm == "c5_flutter":
        return [_spec(f"flutter_C5_s{s}{sfx}", arm, "flutter", 5, s,
                      "sampler", s == 0, collapse_precision=prec)
                for prec, sfx in (("native", ""), ("ds64", "_ds64"))
                for s in range(5)]
    if arm == "c6_ballbeam":
        return [_spec(f"ballbeam_C6_ancestor_s{s}", arm, "ballbeam", 6, s,
                      "c6", s == 0, extra={"mixing": True})
                for s in range(5)]
    if arm == "deep2":
        return [_spec(f"{ds}_C4_deep2" + (f"_seed{s}" if s else ""), arm, ds,
                      4, s, "c4", s == 0, n_layers=2)
                for ds in ("flutter", "drive") for s in range(3)]
    if arm == "drive12k":
        return [_spec(f"drive_long12k_s{s}{sfx}", arm, "drive", 4, s, "12k",
                      s == 1, collapse_precision=prec, dtype=dt,
                      init_jitter=0.0 if s == 1 else JITTER_12K)
                for s in range(1, 6)
                for prec, sfx, dt in (("native", "", None),
                                      ("ds64", "_ds64", None),
                                      ("native", "_fp64cpu", "fp64"))]
    if arm == "c6_ballbeam_fp64":
        return [_spec(f"ballbeam_C6_ancestor_s{s}_fp64card", arm, "ballbeam",
                      6, s, "c6", s == 0, dtype="fp64",
                      extra={"mixing": True}) for s in range(5)]
    if arm == "c2_fp64":
        return [_spec("ballbeam_C2" + (f"_seed{s}" if s else "")
                      + "_fp64card", arm, "ballbeam", 2, s, "sampler", s == 0,
                      dtype="fp64") for s in range(5)]
    if arm == "actuator_prec":
        return [_spec(f"actuator_{prec}_j{j}", arm, "actuator", 4, start,
                      "c4", j == 0, collapse_precision=prec,
                      init_jitter=JITTER_12K if start else 0.0)
                for prec in ("ds64", "hybrid")
                for j, start in enumerate(S1_STARTS)]
    mix = {"mixing": True}
    if arm == "c6_drive":
        return _chains(arm, "drive_C6_ancestor", "drive", tuple(range(8)),
                       {}, {"mixing": True, "redraw": True})
    if arm == "c6_live":
        return _chains(arm, "ballbeam_C6_live", "ballbeam", tuple(range(5)),
                       {"pg_ancestor_trace": False}, mix)
    if arm == "c6_p500":
        p500 = {"pg_particles": 500}
        return (_chains(arm, "ballbeam_C6_liveP500", "ballbeam", (0, 1, 2),
                        {**p500, "pg_ancestor_trace": False})
                + _chains(arm, "drive_C6_ancestorP500", "drive",
                          tuple(range(5)), p500)
                + _chains(arm, "ballbeam_C6_ancestorP500", "ballbeam",
                          (0, 1, 2), p500))
    if arm == "c6_matrix":
        return ([r for ds in ("gas_furnace", "dryer", "flutter", "actuator")
                 for r in _chains(arm, f"{ds}_C6_ancestor", ds, (0, 1, 2),
                                  {})]
                + _chains(arm, "flutter_C6_deep2", "flutter", (0, 1, 2), {},
                          n_layers=2))
    if arm == "ensemble":
        return _ensemble_runs(arm)
    if arm == "nll_slip":
        slip = {"rollout_qsqrt_dim0": True}
        return [_spec(f"{ds}_slip_seed{s}", arm, ds, 4, s, "c4", s == 1,
                      cfg=slip, extra={"variance": True})
                for ds in ("drive", "flutter") for s in (1, 2, 3)] + [
                _spec(f"{ds}_slip_fp64cpu_s1", arm, ds, 4, 1, "c4", True,
                      cfg=slip, dtype="fp64", extra={"variance": True})
                for ds in ("drive", "flutter")]
    if arm == "coldstart":
        return [_spec(f"kink_cold_{prec}_s{s}", arm, "kink", 4, s, "cold",
                      s == 0, collapse_precision=prec)
                for s in range(5) for prec in ("native", "ds64", "hybrid")]
    if arm == "stall":
        slip = {"rollout_qsqrt_dim0": True}
        return ([_spec(f"flutter_long12k_s1{sfx}", arm, "flutter", 4, 1,
                       "12k", True, collapse_precision=prec)
                 for prec, sfx in (("native", ""), ("ds64", "_ds64"))]
                + [_spec(f"{ds}_{name}_s1", arm, ds, 4, 1, "polish", True,
                         cfg=slip, extra={"variance": True,
                                          "schedule": name})
                   for ds in ("drive", "flutter") for name in POLISH])
    if arm == "escape":
        return ([_spec(f"flutter_C5_s{s}_hybrid", arm, "flutter", 5, s,
                       "sampler", s == 0, collapse_precision="hybrid")
                 for s in range(4)]
                + [_spec(f"flutter_C5_sp10_s{s}", arm, "flutter", 5, s,
                         "sampler", s == 0, cfg={"sghmc_spike_clip": 10.0})
                   for s in range(3)])
    if arm == "c2_precision":
        return [_spec(f"ballbeam_C2_{name}_s{s}", arm, "ballbeam", 2, s,
                      "sampler", s == 20, extra={"dsprecal": dsp})
                for s in range(20, 25)
                for name, dsp in (("native", False), ("dsprecal", True))]
    if arm == "flutter_fp64":
        return ([_spec(f"flutter_C5_s{s}_fp64card", arm, "flutter", 5, s,
                       "sampler", s == 0, dtype="fp64") for s in range(5)]
                + [_spec("flutter_long12k_s1_fp64cpu", arm, "flutter", 4, 1,
                         "12k", True, dtype="fp64")])
    if arm == "config4":
        return [_spec(f"{ds}_xd{xd}", arm, ds, 4, 0, "c4", ds == "drive",
                      cfg={"x_dim": xd, "num_posterior_samples": 20,
                           "posterior_sample_spacing": 50})
                for ds in ("drive", "flutter") for xd in (2, 4, 6)]
    if arm == "config2":
        return [_spec(f"{ds}_C4_linear", arm, ds, 4, 0, "c4", True,
                      cfg={"kernel_type": "LinearK"})
                for ds in ("gas_furnace", "dryer")]
    raise ValueError(f"unknown arm {arm!r}; the arms are {', '.join(ARMS)}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _clip_saturated(cfg, params) -> bool:
    bounds = cfg.log_clip_bounds
    if bounds is None:
        return False
    lo, hi = bounds
    return any(bool(a.max() >= hi - 1e-3 or a.min() <= lo + 1e-3)
               for a in (params.kernel.log_variance.detach(),
                         params.kernel.log_lengthscales.detach()))


def _config(spec: dict, **over):
    from ffvd_tpu_torch.config import FFVDConfig
    return FFVDConfig(dataset=spec["dataset"], case=spec["case"],
                      iterations=2000, seed=spec["seed"],
                      n_layers=spec["n_layers"],
                      collapse_precision=spec["collapse_precision"],
                      **{**spec["cfg"], **over})


@contextlib.contextmanager
def dsprecal(on: bool = True):
    """The C2 objective with the Kmm factorisation in float64
    (``model/ds_collapse.py::ds_precal``, cast back to the leaves' dtype)
    in place of ``kernel_precal``, as ``tests/golden/
    c2_precision_study.py:13-16`` substitutes it: the objective's module
    (``model/elbo.py``) sees a copy of ``model/conditionals.py`` whose
    ``kernel_precal`` is that.  A no-op when ``on`` is false."""
    if not on:
        yield
        return
    import types
    from ffvd_tpu_torch.model import conditionals, elbo
    from ffvd_tpu_torch.model.ds_collapse import ds_precal

    def precal(kernel_type, kparams, z, jitter=1e-5):
        pre = ds_precal(kernel_type, kparams, z, jitter)
        return conditionals.Precal(lm=pre.lm.to(z.dtype),
                                   lm_inv=pre.lm_inv.to(z.dtype))

    proxy = types.ModuleType("conditionals_dsprecal")
    proxy.__dict__.update(conditionals.__dict__)
    proxy.kernel_precal = precal
    elbo.cond = proxy
    try:
        yield
    finally:
        elbo.cond = conditionals


def _mixing_stats(stats_fn, model, params, gen) -> dict:
    _, st = stats_fn(params, gen, model.data)
    return {k: float(v) for k, v in st.items()}


def train(spec: dict, iterations: int, device, dtype, capture=None,
          draws=None):
    """Build the spec's ``FFVDModel`` (from the warm start, perturbed by the
    spec's ``init_jitter`` as ``eval/ensemble.py::jitter_params`` perturbs
    an ensemble's chains, when it is not 0) and ``fit`` it.  Returns the
    model, the training seconds and, where the spec asks for them (C6), the
    mixing diagnostics of a side sweep every ``MIXING_EVERY`` iterations.
    ``draws`` (one ``Trainer.run`` draw dict an iteration) replaces the
    training draws; the tests inject them."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.eval.ensemble import jitter_params
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    cfg = _config(spec)
    model = FFVDModel(cfg, device=device, dtype=dtype, capture=capture)
    if spec["init_jitter"]:
        model.state = model.trainer.init_state(
            jitter_params(model.params, spec["init_jitter"], spec["seed"]))
    mix = bool(spec["extra"].get("mixing"))
    if mix:
        stats_fn = make_pg_fn(cfg, with_stats=True)
        gen = torch.Generator(device=model.device).manual_seed(
            1000 + spec["seed"])
    segment = MIXING_EVERY if mix else iterations
    mixing, train_s, done = [], 0.0, 0
    while done < iterations:
        n = min(segment, iterations - done)
        _sync(model.device)
        t0 = time.time()
        with dsprecal(spec["extra"].get("dsprecal", False)):
            if draws is None:
                model.fit(n)
            else:
                model.state, nlls = model.trainer.run(
                    model.state, n, generator=model.train_generator,
                    capture=model.capture, draws=draws[done:done + n])
                model.nll_trace = torch.cat([model.nll_trace, nlls])
        _sync(model.device)
        train_s += time.time() - t0
        done += n
        if mix:
            mixing.append(_mixing_stats(stats_fn, model, model.params, gen))
    return model, train_s, mixing


def _variance_fields(model, ev) -> dict:
    """The predictive-variance fields of ``tests/golden/nll_study.py`` and
    ``fp32_stall_study.py``: the first and mean 30-step v̂, the mean 30-step
    squared error, the learned R."""
    pv = np.asarray(ev["predict_y_var"], np.float64)
    err = (np.asarray(ev["predict_y"], np.float64)[:30]
           - np.asarray(model.dataset.y_test, np.float64)[:30])
    r = model.params.rchol_diag.detach().double().cpu() ** 2
    return {"v_first": float(pv.reshape(-1)[0]),
            "v30_mean": float(pv[:30].mean()),
            "err30_sq_mean": float((err ** 2).mean()),
            "R": r.tolist()}


def evaluated(model, spec: dict, train_s: float, mixing: list) -> dict:
    """The record of a trained model: ``evaluate()`` and the fitted
    summary."""
    t0 = time.time()
    with dsprecal(spec["extra"].get("dsprecal", False)):
        ev = model.evaluate()
    eval_ms = (time.time() - t0) * 1e3
    nll = model.nll_trace.cpu()
    rec = {"rmse": ev["rmse"], "nll": ev["nll"],
           "nll_first": float(nll[0]), "nll_last": float(nll[-1]),
           **fitted_summary(torch, model.params),
           "iterations": int(nll.numel()), "train_s": train_s,
           "it_per_s": nll.numel() / train_s, "eval_ms": eval_ms}
    if not model.cfg.case_config.kernel_optimization:
        rec["clip_saturated"] = _clip_saturated(model.cfg, model.params)
    if mixing:
        rec["mixing_mean"] = {k: sum(m[k] for m in mixing) / len(mixing)
                              for k in mixing[0]}
        rec["mixing_seq"] = mixing
    if spec["extra"].get("variance"):
        rec.update(_variance_fields(model, ev))
    if spec["extra"].get("dsprecal") is not None:
        rec["final_elbo"] = -float(nll[-1])
    return rec


def run_model(spec: dict, iterations: int, device, dtype) -> dict:
    """One run of a C4, sampler, deep or C6 spec: ``train``, then
    ``evaluate()``."""
    model, train_s, mixing = train(spec, iterations, device, dtype)
    return evaluated(model, spec, train_s, mixing)


def run_chains(specs: list, iterations: int, device, dtype,
               draws=None) -> dict:
    """The C6 seeds ``specs`` (one config) as the members of one
    ``MultiChainTrainer``, started exactly at the warm start (each seed's
    ``FFVDModel`` params stacked: ``stack_params`` with neither generator
    nor normals, and each deep member with its own seed's hidden layers,
    as the one-model runner builds them), the sweeps from one generator
    seeded with the first seed.  Each member is then evaluated as a run
    of its own.  ``draws``: one ``Trainer.run`` draw dict an iteration,
    its "pg" a list of the members' sweep draws (the tests inject them).
    Returns {tag: record}."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.parallel.sharding import (MultiChainTrainer, member,
                                                  stack_members)
    models = [FFVDModel(_config(s), device=device, dtype=dtype)
              for s in specs]
    cfg, dev = models[0].cfg, models[0].device
    mct = MultiChainTrainer(cfg, models[0].data, len(specs),
                            pg_fn=make_pg_fn(cfg))
    state = mct.init_state(stack_members([m.params for m in models]))
    gen = torch.Generator(device=dev).manual_seed(specs[0]["seed"])
    mix = bool(specs[0]["extra"].get("mixing"))
    stats_fn = make_pg_fn(cfg, with_stats=True)
    side = [torch.Generator(device=dev).manual_seed(1000 + s["seed"])
            for s in specs]
    segment = MIXING_EVERY if mix else iterations
    mixing = [[] for _ in specs]
    traces, train_s, done = [], 0.0, 0
    while done < iterations:
        n = min(segment, iterations - done)
        _sync(dev)
        t0 = time.time()
        state, nlls = mct.run(state, n, generator=gen, draws=(
            None if draws is None else draws[done:done + n]))
        _sync(dev)
        train_s += time.time() - t0
        traces.append(nlls)
        done += n
        if mix:
            for i, m in enumerate(models):
                mixing[i].append(_mixing_stats(
                    stats_fn, m, member(state.params, i), side[i]))
    trace = torch.cat(traces)
    out = {}
    for i, (spec, m) in enumerate(zip(specs, models)):
        m.state = m.trainer.init_state(member(state.params, i))
        m.nll_trace = trace[:, i]
        rec = evaluated(m, spec, train_s, mixing[i])
        rec["chains"] = len(specs)
        out[spec["tag"]] = rec
        if spec["extra"].get("redraw") and rec["rmse"] > REDRAW_ABOVE:
            out[spec["tag"] + "_redraw"] = {
                "recorded_outlier": rec["rmse"],
                "rmse_draws_num10": [rec["rmse"]] + [
                    m.evaluate()["rmse"] for _ in range(9)],
                "rmse_num40": m.evaluate(num_samples=40)["rmse"],
                "iterations": rec["iterations"], "train_s": train_s}
    return out


def run_ensemble(spec: dict, iterations: int, device, dtype) -> dict:
    """One entry of ``tests/golden/ensemble_study.py``: 4 chains through
    ``fit_ensemble`` (seeds ``seed``..``seed``+3; ``init_jitter`` on chains
    1-3), pooled by ``ensemble_evaluate``; or one chain evaluated with 40
    rollouts, with and without the spread term."""
    from ffvd_tpu_torch.eval.ensemble import ensemble_evaluate, fit_ensemble
    cfg = _config(spec)
    if spec["extra"]["chains"] == 1:
        model, train_s, _ = train(spec, iterations, device, dtype)
        t0 = time.time()
        res = model.evaluate(num_samples=40, spread=True)
        res_ns = model.evaluate(num_samples=40)
        rec = {"rmse": res["rmse"], "nll": res["nll"],
               "nll_no_spread": res_ns["nll"],
               "iterations": int(model.nll_trace.numel())}
    else:
        _sync(device)
        t0 = time.time()
        models = fit_ensemble(cfg, spec["extra"]["chains"], device=device,
                              dtype=dtype, init_jitter=spec["init_jitter"],
                              num_iterations=iterations)
        _sync(device)
        train_s = time.time() - t0
        t0 = time.time()
        res = ensemble_evaluate(models)
        rec = {k: res[k] for k in ("rmse", "nll", "nll_no_spread",
                                   "per_chain")}
        rec["iterations"] = min(int(m.nll_trace.numel()) for m in models)
    rec.update(train_s=train_s, eval_ms=(time.time() - t0) * 1e3,
               chains=spec["extra"]["chains"])
    return rec


def run_cold(spec: dict, quick: bool, device, dtype) -> dict:
    """One arm of ``tests/golden/hybrid_coldstart_study.py``: kink data
    (N=120, its seed), a random start (M=20, D=1, generator seeded with
    the seed), C4 for 4000 iterations in chunks of 1000 (hybrid: the last
    500 on the float64 segment), then the 1- and 5-step RMSE of 10
    rollouts and the final nll under the trained and the ds64 bound."""
    import dataclasses
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data.synthetic import generate_kink
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import init_params_random
    seed, total = spec["seed"], (QUICK if quick else FULL)["cold"]
    ds = generate_kink(n=120, seed=seed)
    params = init_params_random(
        n=ds.n_train, x_dim=1, m=20, control_dim=0,
        generator=torch.Generator().manual_seed(seed), device=device,
        dtype=dtype)
    cfg = FFVDConfig(case=4, num_inducing=20, x_dim=1,
                     collapse_precision=spec["collapse_precision"],
                     hybrid_tail_iters=COLD_TAIL["quick" if quick
                                                 else "full"],
                     iterations=total // 2)
    model = FFVDModel(cfg, device=device, dtype=dtype, dataset=ds,
                      params=params)
    _sync(model.device)
    t0 = time.time()
    model.fit(total, chunk_size=1000)
    _sync(model.device)
    train_s = time.time() - t0
    t0 = time.time()
    ev1 = model.evaluate_quick(num_samples=10, horizon=1)
    ev5 = model.evaluate_quick(num_samples=10, horizon=5)
    eval_ms = (time.time() - t0) * 1e3
    ruler = Trainer(dataclasses.replace(cfg, collapse_precision="ds64"),
                    model.data)
    with torch.no_grad():
        nll64 = float(ruler.nll_fn(model.params, model.data))
    nll = model.nll_trace.cpu()
    return {"nll_final_own_bound": float(nll[-1]),
            "nll_final_ds64_bound": nll64,
            **fitted_summary(torch, model.params),
            "rmse_h1": ev1["rmse"], "rmse_h5": ev5["rmse"],
            "iterations": int(nll.numel()), "train_s": train_s,
            "it_per_s": nll.numel() / train_s, "eval_ms": eval_ms}


def run_polish(spec: dict, iterations: int, device, dtype) -> dict:
    """A polish schedule of ``tests/golden/fp32_stall_study.py``: the
    phases' iterations at the default lr, then lr/10 (and lr/100), Adam's
    moments carried over (a new ``Trainer`` at the phase's lr, as the JAX
    script makes one, and the state's Adam set to its lr)."""
    import dataclasses
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.inference.trainer import Trainer
    cfg = _config(spec)
    model = FFVDModel(cfg, device=device, dtype=dtype)
    _sync(model.device)
    t0 = time.time()
    for frac, factor in POLISH[spec["extra"]["schedule"]]:
        if factor != 1.0:
            model.trainer = Trainer(dataclasses.replace(
                cfg, adam_lr=cfg.adam_lr * factor), model.data)
            for group in model.state.adam.param_groups:
                group["lr"] = model.trainer.adam_lr
        model.fit(int(round(iterations * frac)))
    _sync(model.device)
    return evaluated(model, spec, time.time() - t0, [])


def _iterations(spec: dict, quick: bool) -> int:
    return (QUICK if quick else FULL)[spec["kind"]]


def run_one(spec: dict, quick: bool, device, dtype, card: str) -> dict:
    """The record of one run.  The previous run's models and CUDA graphs
    are collected first, outside its timing."""
    gc.collect()
    iterations = _iterations(spec, quick)
    if spec["dtype"] is not None:
        dtype = torch.float64 if spec["dtype"] == "fp64" else torch.float32
    if spec["mode"] == "ensemble":
        rec = run_ensemble(spec, iterations, device, dtype)
    elif spec["kind"] == "12k":
        out = run_arm(torch, spec["dataset"], spec["collapse_precision"],
                      iterations, spec["seed"], card, dtype, device=device,
                      init_jitter=spec["init_jitter"])
        rec = {k: out[k] for k in (
            "rmse", "nll", "nll_first", "nll_last", "budget_s2C2", "Q",
            "max_Q", "iterations", "it_per_s", "eval_ms", "v_first",
            "v30_mean")}
        rec["train_s"] = out["train_seconds"]
    elif spec["kind"] == "cold":
        rec = run_cold(spec, quick, device, dtype)
    elif spec["kind"] == "polish":
        rec = run_polish(spec, iterations, device, dtype)
    else:
        rec = run_model(spec, iterations, device, dtype)
    return _record(spec, dtype, device, card, rec)


def _record(spec: dict, dtype, device, card: str, rec: dict) -> dict:
    out = {"arm": spec["arm"], "dataset": spec["dataset"],
           "case": f"C{spec['case']}", "seed": spec["seed"],
           "init_jitter": spec["init_jitter"],
           "collapse_precision": spec["collapse_precision"],
           "dtype": "fp64" if dtype == torch.float64 else "fp32",
           "n_layers": spec["n_layers"],
           "mode": spec["mode"], "device": device.type, "card": card, **rec}
    if spec["cfg"]:
        out["cfg"] = spec["cfg"]
    return out


def run_group(specs: list, quick: bool, device, dtype, card: str) -> dict:
    """The records of one chains-mode group (``run_chains``)."""
    gc.collect()
    spec = specs[0]
    if spec["dtype"] is not None:
        dtype = torch.float64 if spec["dtype"] == "fp64" else torch.float32
    recs = run_chains(specs, _iterations(spec, quick), device, dtype)
    by_tag = {s["tag"]: s for s in specs}
    return {t: _record(by_tag[t.removesuffix("_redraw")], dtype, device,
                       card, r) for t, r in recs.items()}


def _commit() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def load_study(path: Path, header: dict) -> dict:
    """The study file, or a new one with ``header``; a quick file and a
    full one, or a card's and a host's, never mix."""
    if not path.exists():
        return {"header": header, "calls": [], "runs": {}}
    doc = json.loads(path.read_text())
    for key in ("quick", "device"):
        if doc["header"][key] != header[key]:
            raise ValueError(
                f"{path}: its runs have {key}={doc['header'][key]!r}, this "
                f"call {key}={header[key]!r}; use another --out")
    return doc


def save_study(path: Path, doc: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(doc, indent=1))
    os.replace(tmp, path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["fp32", "fp64"], default=None,
                    help="fp32 on the card and fp64 on the CPU by default")
    ap.add_argument("--match", default=None,
                    help="run only the tags this regular expression matches")
    ap.add_argument("--stop-after", type=float, default=None,
                    help="start no run after this many seconds")
    ap.add_argument("--commit", default=None,
                    help="the commit to record (default: git rev-parse HEAD)")
    args = ap.parse_args(argv)

    from ffvd_tpu_torch.utils.device import default_dtype, resolve_device
    device = resolve_device(args.device)
    dtype = default_dtype(device, args.dtype)
    runs = [r for arm in args.arms.split(",") for r in arm_runs(arm)]
    if args.quick:
        runs = [r for r in runs if r["first"]]
    if args.match:
        runs = [r for r in runs if re.search(args.match, r["tag"])]

    card = card_name(torch) if device.type == "cuda" else "cpu"
    now = datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds")
    call = {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "commit": args.commit or _commit(),
            "date": now}
    path = Path(args.out)
    doc = load_study(path, {**call, "quick": args.quick,
                            "device": device.type})
    entry = {**call, "arms": args.arms, "ran": []}
    t_start = time.time()
    ran, skipped, arm_s, done_groups = [], [], {}, set()
    for spec in runs:
        group = ([r for r in runs if r["group"] == spec["group"]]
                 if spec["mode"] == "chains" else [spec])
        if spec["mode"] == "chains":
            if spec["group"] in done_groups:
                continue
            done_groups.add(spec["group"])
        if all(r["tag"] in doc["runs"] for r in group):
            skipped += [r["tag"] for r in group]
            print(f"skip {', '.join(r['tag'] for r in group)}", flush=True)
            continue
        if (args.stop_after is not None
                and time.time() - t_start > args.stop_after):
            print(f"stop before {spec['tag']}: --stop-after "
                  f"{args.stop_after} s", flush=True)
            break
        t0 = time.time()
        recs = (run_group(group, args.quick, device, dtype, card)
                if spec["mode"] == "chains"
                else {spec["tag"]: run_one(spec, args.quick, device, dtype,
                                           card)})
        arm_s[spec["arm"]] = arm_s.get(spec["arm"], 0.0) + time.time() - t0
        doc["runs"].update(recs)
        if not entry["ran"]:
            doc["calls"].append(entry)
        entry["ran"] += list(recs)
        save_study(path, doc)
        ran += list(recs)
        for tag, rec in recs.items():
            print(json.dumps({tag: {k: rec[k] for k in (
                "rmse", "nll", "train_s", "it_per_s", "eval_ms")
                if k in rec}}), flush=True)
    summary = {"ran": ran, "skipped": skipped, "arm_seconds": arm_s,
               "seconds": time.time() - t_start, "out": str(path)}
    print(json.dumps({"study": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
