#!/usr/bin/env python3
"""The precision hold of PARITY §2f on one GPU, for ``ffvd_tpu_torch``.

    python scripts/precision_hold_torch.py [--arms ds64,native]
        [--dataset drive] [--iterations 12000] [--seed 1]
        [--precision fp32|fp64]

Trains C4 with the settings of the JAX package's extended-training study
(``tests/golden/fp32_stall_study.py:109-119``: seed 1,
``rollout_qsqrt_dim0=True``, 12,000 iterations, fp32 on the card), once
per arm of ``collapse_precision``, then evaluates.  C4 draws nothing in
training, so an arm is deterministic given the warm start.  ``--precision
fp64`` runs the arms with fp64 parameters on the card: the native fp64 arm
is the optimum the float64 segment aims at (the JAX study's fp64 CPU
control, ``*_fp64cpu``).  Prints one JSON
line per arm: RMSE, 30-step NLL, the learned Q and its maximum, the
posterior-variance budget Σ exp(log σ²)·C² (``tests/golden/
fp32_mixed_control.py:109``), the first predictive variance, training
seconds and it/s, the ``evaluate()`` milliseconds, and the card with its
power limit.  The JAX package's
bracket for drive (``tests/test_study_artifacts.py:168-186``) is a budget
in [1.161, 1.493] and max Q < 5e-6 for the ds64 arm; one seed is a report,
not a gate.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card_name(torch) -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(0)


def fitted_summary(torch, params) -> dict:
    """The learned Q, its maximum and the posterior-variance budget
    Σ exp(log σ²)·C² (``tests/golden/fp32_mixed_control.py:109``) of a
    fitted parameter set, in float64 on the host."""
    lv = params.kernel.log_variance.detach().double().cpu()
    c = params.c.detach().double().cpu()
    q = torch.exp(params.log_q.detach().double()).cpu()
    return {"budget_s2C2": float((torch.exp(lv)[:, None] * c * c).sum()),
            "Q": q.tolist(), "max_Q": float(q.max())}


def run_arm(torch, dataset: str, arm: str, iterations: int, seed: int,
            card: str, dtype, device="cuda", init_jitter: float = 0.0
            ) -> dict:
    """One arm: C4 from the warm start (perturbed by ``init_jitter`` as
    ``eval/ensemble.py::jitter_params`` perturbs an ensemble's chains, when
    it is not 0), ``fit(iterations)``, ``evaluate()``."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.ensemble import jitter_params
    cfg = FFVDConfig(dataset=dataset, case=4, iterations=2000, seed=seed,
                     rollout_qsqrt_dim0=True, collapse_precision=arm)
    model = FFVDModel(cfg, device=device, dtype=dtype)
    if init_jitter:
        model.state = model.trainer.init_state(
            jitter_params(model.params, init_jitter, seed))
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    model.fit(iterations)
    nll = model.nll_trace.cpu()
    train_s = time.time() - t0
    t1 = time.time()
    ev = model.evaluate()
    eval_ms = (time.time() - t1) * 1e3
    pv = ev["predict_y_var"]
    out = {"card": card, "dataset": dataset, "case": "C4", "arm": arm,
           "precision": str(model.dtype).replace("torch.float", "fp"),
           "device": model.device.type, "seed": seed,
           "init_jitter": init_jitter, "iterations": int(nll.numel()),
           "train_seconds": train_s, "it_per_s": nll.numel() / train_s,
           "eval_ms": eval_ms,
           "nll_first": float(nll[0]), "nll_last": float(nll[-1]),
           "rmse": ev["rmse"], "nll": ev["nll"],
           **fitted_summary(torch, model.params),
           "v_first": float(pv.reshape(-1)[0]),
           "v30_mean": float(pv[:30].mean())}
    if arm == "ds64" and dataset == "drive":
        out["in_jax_bracket"] = (1.161 <= out["budget_s2C2"] <= 1.493
                                 and out["max_Q"] < 5e-6)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", default="ds64,native")
    ap.add_argument("--dataset", default="drive")
    ap.add_argument("--iterations", type=int, default=12000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--precision", choices=["fp32", "fp64"], default="fp32")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("precision_hold_torch: needs a CUDA device")
    card = card_name(torch)
    dtype = torch.float32 if args.precision == "fp32" else torch.float64
    for arm in args.arms.split(","):
        print(json.dumps(run_arm(torch, args.dataset, arm, args.iterations,
                                 args.seed, card, dtype)), flush=True)


if __name__ == "__main__":
    main()
