#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port, the counterpart of
``bench.py``: FFVD training iterations per second on ballbeam C4 (M=100,
D=4), with the sampler cases, M=512, six datasets × M=512 and ds64 in
"extra".

    python scripts/bench_torch.py [--platform cpu] [--quick]

Runs ``ffvd_tpu_torch`` on ``cuda`` (``--platform cpu``: on the host) in
fp32, TF32 off, with bench.py's workloads and counts:

- ballbeam C4, 4000 outer iterations (2000 CLI iterations) in one
  ``Trainer.run``: ``value`` is their rate, ``time_2000_cli_iters_sec``
  their seconds, ``final_nll`` the last nll; then ``evaluate()`` (the CUDA
  rollout kernel on the card), timed as ``c4_evaluate_ms``;
- steady rates of C2 and C5 over 500 iterations each, M=512 over 200, six
  datasets × M=512 in one ``MultiDatasetTrainer`` over 200, drive C4 under
  ``collapse_precision="ds64"`` over 500.

PyTorch runs eagerly, so there is nothing to compile: where bench.py warms
up with a whole timed stretch, each workload here first runs ``WARMUP``
iterations, which pay the first-use costs (the CUDA libraries' handles,
the caching allocator), the six datasets 200 as in bench.py.  Each
stretch is timed by ``utils/timing.py::once_ms`` (CUDA events around it,
the card synchronised before).  ``vs_baseline`` divides the C4 rate by
the TF reference's on a CPU (``tests/golden/baseline_timing.json``), as
bench.py does.

XLA's cost analysis has no counterpart here: the FLOPs of an M=512
iteration are counted from the shapes (``c4_flops_per_iter``), and
``mfu_m512_vs_fp32_peak`` divides the achieved rate by the card's fp32
peak from ``PEAK_FP32_TFLOPS`` (TF32 is off, so fp32 work runs outside the
tensor cores), with ``peak_ref`` naming it; both are left out for a card
the table lacks.  ``card`` is the card's name and power limit as
``nvidia-smi`` gives them.  ``--quick`` cuts every count to a few
iterations.

Prints ONE json line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

WARMUP = 10
# fp32 peaks outside the tensor cores (NVIDIA data sheet), keyed by
# torch.cuda.get_device_name().
PEAK_FP32_TFLOPS = {"NVIDIA H100 80GB HBM3": ("H100 SXM", 67.0)}
COUNTS = {"c4": 4000, "sampler": 500, "m512": 200, "six": 200, "ds64": 500}
QUICK = {"c4": 5, "sampler": 2, "m512": 2, "six": 2, "ds64": 2}


def c4_flops_per_iter(n: int, d: int, m: int, din: int) -> float:
    """FLOPs of one collapsed (C4) training iteration, from the shapes: N
    transitions, D latent dims, M inducing points, Din GP inputs.  The
    forward pass, per latent dim:

        F_d = 2·M²·N        A = Lm⁻¹·K(Z, X̃)
            + 2·M²·N        the H-gram A·Aᵀ
            + 2·M·N         the a-vector A·Δx
            + 2·M·N         the trace term Σ A²
            + 3·Din·M·N     the scaled distances of K(X̃, Z)
            + 3·Din·M²      the scaled distances of K(Z, Z)
            + 4·M³/3        Cholesky (M³/3) and triangular inverse (M³/3)
                            of Kmm and of H
            + 2·M²          L_H⁻¹·a

    and the iteration is 3·D·F_d: the forward and a backward of twice its
    cost, the rule for a graph of matmuls (every backward of ``chol_and_inv``
    is matmuls too).  Elementwise work (exp, the Adam update) is left out."""
    f = (4 * m * m * n + 4 * m * n + 3 * din * m * n + 3 * din * m * m
         + 4 * m ** 3 / 3 + 2 * m * m)
    return 3.0 * d * f


def card_line() -> str | None:
    """`name, power.limit` as nvidia-smi gives them (None off the card)."""
    if not torch.cuda.is_available():
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def _build(cfg, dev, dtype):
    """(Trainer, its state) of ``cfg``'s dataset from its warm start."""
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import (SSMData,
                                             init_params_from_warmstart)
    ds = create_dataset(cfg.dataset)
    params = init_params_from_warmstart(load_warmstart(cfg.dataset,
                                                       cfg.file_id),
                                        device=dev, dtype=dtype)
    if cfg.num_inducing != params.z.shape[0]:
        from ffvd_tpu_torch.parallel.multidataset import _resize_inducing
        params = _resize_inducing(params, cfg.num_inducing, cfg.seed)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    tr = Trainer(cfg, SSMData(y=as_t(ds.y_train), control=as_t(ds.control)))
    return tr, tr.init_state(params)


def _timed_run(trainer, state, iters: int, gen):
    """(ms, state, trace) of one ``trainer.run`` of ``iters`` iterations in
    one chunk, timed by ``utils/timing.py``."""
    from ffvd_tpu_torch.utils.timing import once_ms
    out = {}

    def run():
        out["state"], out["trace"] = trainer.run(state, iters,
                                                 chunk_size=iters,
                                                 generator=gen)
    ms = once_ms(run, state.params.x.device)
    if not bool(torch.isfinite(out["trace"]).all()):
        raise FloatingPointError("non-finite nll during the benchmark")
    return ms, out["state"], out["trace"]


def _steady_rate(trainer, state, iters: int, gen, warmup: int) -> float:
    """Iterations per second over ``iters`` iterations after ``warmup``."""
    trainer.run(state, warmup, chunk_size=max(warmup, 1), generator=gen)
    ms, _, _ = _timed_run(trainer, state, iters, gen)
    return iters / (ms / 1e3)


def measure(device: str = "cuda", quick: bool = False) -> dict:
    """The benchmark's JSON line as a dict (module docstring)."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import DATASETS, FFVDConfig
    from ffvd_tpu_torch.parallel.multidataset import (MultiDatasetTrainer,
                                                      stack_datasets)
    from ffvd_tpu_torch.utils.device import resolve_device
    from ffvd_tpu_torch.utils.timing import once_ms
    dev = resolve_device(device)
    dtype = torch.float32
    counts = QUICK if quick else COUNTS
    warm = 1 if quick else WARMUP
    platform = "gpu" if dev.type == "cuda" else "cpu"
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    model = FFVDModel(FFVDConfig(dataset="ballbeam", case=4), device=dev,
                      dtype=dtype)
    tr = model.trainer
    tr.run(model.state, warm, chunk_size=warm, generator=gen(0))
    total = counts["c4"]
    ms, model.state, nlls = _timed_run(tr, model.state, total, gen(0))
    rate = total / (ms / 1e3)
    # evaluate(): one rollout launch on the card; the first call builds
    # the kernel.
    model.evaluate()
    eval_ms = once_ms(model.evaluate, dev)

    base = ROOT / "tests/golden/baseline_timing.json"
    vs = (rate / json.loads(base.read_text())["tf_iters_per_sec"]
          if base.exists() else None)
    extra = {"time_2000_cli_iters_sec": ms / 1e3,
             "final_nll": float(nlls[-1]), "platform": platform,
             "dtype": "float32", "c4_evaluate_ms": eval_ms,
             "card": card_line()}

    for case in (2, 5):
        t, s = _build(FFVDConfig(dataset="ballbeam", case=case), dev, dtype)
        extra[f"c{case}_iters_per_sec_steady"] = _steady_rate(
            t, s, counts["sampler"], gen(case), warm)

    cfg512 = FFVDConfig(dataset="ballbeam", case=4, num_inducing=512)
    t, s = _build(cfg512, dev, dtype)
    r512 = _steady_rate(t, s, counts["m512"], gen(512), warm)
    flops = c4_flops_per_iter(t.data.y.shape[0], cfg512.x_dim, 512,
                              s.params.z.shape[1])
    achieved = flops * r512
    extra.update(m512_ms_per_iter_steady=1e3 / r512,
                 m512_gflops_per_iter=flops / 1e9,
                 m512_achieved_tflops=achieved / 1e12)
    if dev.type == "cuda":
        peak = PEAK_FP32_TFLOPS.get(torch.cuda.get_device_name(dev))
        if peak is not None:
            extra["mfu_m512_vs_fp32_peak"] = achieved / (peak[1] * 1e12)
            extra["peak_ref"] = f"{peak[0]} fp32 {peak[1]:g} TFLOP/s"

    sdata, sparams, _ = stack_datasets(DATASETS, m=512, device=dev,
                                       dtype=dtype)
    mdt = MultiDatasetTrainer(cfg512, sdata)
    mstate = mdt.init_state(sparams)
    six = counts["six"]
    mdt.run(mstate, six, chunk_size=six, generator=gen(6512))
    ms6, _, _ = _timed_run(mdt, mstate, six, gen(6512))
    extra["six_ds_m512_ms_per_6model_iter_steady"] = ms6 / six
    extra["six_ds_m512_aggregate_iters_per_sec"] = 6 * six / (ms6 / 1e3)

    t, s = _build(FFVDConfig(dataset="drive", case=4,
                             collapse_precision="ds64"), dev, dtype)
    extra["ds64_drive_c4_iters_per_sec_steady"] = _steady_rate(
        t, s, counts["ds64"], gen(64), warm)

    finite = all(math.isfinite(v) for v in extra.values()
                 if isinstance(v, float))
    if not finite:
        raise FloatingPointError(f"a non-finite benchmark number: {extra}")
    return {"metric": f"ffvd_train_iters_per_sec_ballbeam_c4_{platform}",
            "value": rate, "unit": "iters/sec", "vs_baseline": vs,
            "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                    help="the device (default cuda; raises without one)")
    ap.add_argument("--quick", action="store_true",
                    help="a few iterations of each workload")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.platform, args.quick)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
