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
"""

from __future__ import annotations

import argparse
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

import torch  # noqa: E402

from precision_hold_torch import card_name, fitted_summary, run_arm  # noqa: E402

OUT = ROOT / "tests" / "golden_torch" / "study_h100.json"
ARMS = ("c4_six", "c2", "c3", "c5_ballbeam", "c5_flutter", "c6_ballbeam",
        "deep2", "drive12k")
SIX = ("ballbeam", "drive", "gas_furnace", "dryer", "actuator", "flutter")
FULL = {"c4": 4000, "sampler": 4000, "c6": 4000, "12k": 12000}
QUICK = {"c4": 50, "sampler": 3, "c6": 2, "12k": 50}
MIXING_EVERY = 400
JITTER_12K = 1e-6


def _spec(tag, arm, dataset, case, seed, kind, first, **kw):
    return {"tag": tag, "arm": arm, "dataset": dataset, "case": case,
            "seed": seed, "kind": kind, "first": first,
            "collapse_precision": kw.get("collapse_precision", "native"),
            "n_layers": kw.get("n_layers", 1),
            "init_jitter": kw.get("init_jitter", 0.0),
            "dtype": kw.get("dtype")}


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
                      "c6", s == 0) for s in range(5)]
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


def train(spec: dict, iterations: int, device, dtype, capture=None):
    """Build the spec's ``FFVDModel`` (from the warm start, perturbed by the
    spec's ``init_jitter`` as ``eval/ensemble.py::jitter_params`` perturbs
    an ensemble's chains, when it is not 0) and ``fit`` it.  Returns the
    model, the training seconds and, on C6, the mixing diagnostics of a
    side sweep every ``MIXING_EVERY`` iterations."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.ensemble import jitter_params
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    cfg = FFVDConfig(dataset=spec["dataset"], case=spec["case"],
                     iterations=2000, seed=spec["seed"],
                     n_layers=spec["n_layers"],
                     collapse_precision=spec["collapse_precision"])
    model = FFVDModel(cfg, device=device, dtype=dtype, capture=capture)
    if spec["init_jitter"]:
        model.state = model.trainer.init_state(
            jitter_params(model.params, spec["init_jitter"], spec["seed"]))
    c6 = spec["kind"] == "c6"
    if c6:
        stats_fn = make_pg_fn(cfg, with_stats=True)
        gen = torch.Generator(device=model.device).manual_seed(
            1000 + spec["seed"])
    segment = MIXING_EVERY if c6 else iterations
    mixing, train_s, done = [], 0.0, 0
    while done < iterations:
        n = min(segment, iterations - done)
        _sync(model.device)
        t0 = time.time()
        model.fit(n)
        _sync(model.device)
        train_s += time.time() - t0
        done += n
        if c6:
            _, st = stats_fn(model.params, gen, model.data)
            mixing.append({k: float(v) for k, v in st.items()})
    return model, train_s, mixing


def run_model(spec: dict, iterations: int, device, dtype) -> dict:
    """One run of a C4, sampler, deep or C6 spec: ``train``, then
    ``evaluate()``."""
    model, train_s, mixing = train(spec, iterations, device, dtype)
    t0 = time.time()
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
    return rec


def run_one(spec: dict, quick: bool, device, dtype, card: str) -> dict:
    """The record of one run.  The previous run's models and CUDA graphs
    are collected first, outside its timing."""
    gc.collect()
    iterations = (QUICK if quick else FULL)[spec["kind"]]
    if spec["dtype"] is not None:
        dtype = torch.float64 if spec["dtype"] == "fp64" else torch.float32
    if spec["kind"] == "12k":
        out = run_arm(torch, spec["dataset"], spec["collapse_precision"],
                      iterations, spec["seed"], card, dtype, device=device,
                      init_jitter=spec["init_jitter"])
        rec = {k: out[k] for k in (
            "rmse", "nll", "nll_first", "nll_last", "budget_s2C2", "Q",
            "max_Q", "iterations", "it_per_s", "eval_ms")}
        rec["train_s"] = out["train_seconds"]
    else:
        rec = run_model(spec, iterations, device, dtype)
    return {"arm": spec["arm"], "dataset": spec["dataset"],
            "case": f"C{spec['case']}", "seed": spec["seed"],
            "init_jitter": spec["init_jitter"],
            "collapse_precision": spec["collapse_precision"],
            "dtype": "fp64" if dtype == torch.float64 else "fp32",
            "n_layers": spec["n_layers"],
            "mode": "trainer", "device": device.type, "card": card, **rec}


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
    ran, skipped, arm_s = [], [], {}
    for spec in runs:
        if spec["tag"] in doc["runs"]:
            skipped.append(spec["tag"])
            print(f"skip {spec['tag']}", flush=True)
            continue
        if (args.stop_after is not None
                and time.time() - t_start > args.stop_after):
            print(f"stop before {spec['tag']}: --stop-after "
                  f"{args.stop_after} s", flush=True)
            break
        t0 = time.time()
        rec = run_one(spec, args.quick, device, dtype, card)
        arm_s[spec["arm"]] = arm_s.get(spec["arm"], 0.0) + time.time() - t0
        doc["runs"][spec["tag"]] = rec
        if not entry["ran"]:
            doc["calls"].append(entry)
        entry["ran"].append(spec["tag"])
        save_study(path, doc)
        ran.append(spec["tag"])
        print(json.dumps({spec["tag"]: {k: rec[k] for k in (
            "rmse", "nll", "train_s", "it_per_s", "eval_ms")}}), flush=True)
    summary = {"ran": ran, "skipped": skipped, "arm_seconds": arm_s,
               "seconds": time.time() - t_start, "out": str(path)}
    print(json.dumps({"study": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
