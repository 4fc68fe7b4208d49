#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one GPU.

    python scripts/profile_torch_train.py [--iters 50] [--precision fp32]
        [--cell c4|ds64|deep|window]

Trains one cell of PERF.md §4 (``ffvd_tpu_torch``): ``c4`` ballbeam C4,
``ds64`` the same with ``collapse_precision="ds64"`` (the collapsed segment
in float64), ``deep`` flutter C4 with ``n_layers=2``, ``window`` C4 on the
N=5000 kink data from a cold start with 256-step windows.  After a few warm-up
iterations it profiles ``--iters`` more with ``torch.profiler`` and prints
one JSON line:
iterations per second, the device's busy share of the window (union of the
CUDA kernel intervals over the wall time), CUDA kernels and host-device
synchronisations per iteration, and the ops with the most device time;
then the same for one ``evaluate()`` (the posterior rollouts; kernels per
rollout step for a recursion).  The training chrome trace goes to
``chiprun_out/profile_torch_train_<cell>.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _busy_us(events):
    """Length of the union of the CUDA events' time ranges, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _summary(prof, wall_us, n):
    """The device's busy share of ``wall_us``, and per each of ``n``
    repeats: CUDA kernels, host syncs or copies, and the 12 ops with the
    most device time (their calls and device µs)."""
    events = prof.events()
    cuda_ev = [e for e in events if str(e.device_type).endswith("CUDA")]
    syncs = [e for e in events
             if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "cudaMemcpyAsync", "cudaMemcpy")]
    dev_us = lambda a: getattr(a, "self_device_time_total",
                               getattr(a, "self_cuda_time_total", 0.0))
    top = sorted(prof.key_averages(), key=dev_us, reverse=True)[:12]
    return {"device_busy_share": _busy_us(cuda_ev) / wall_us,
            "cuda_kernels": len(cuda_ev) / n,
            "host_syncs_and_copies": len(syncs) / n,
            "top_device_ops": [{"name": a.key, "calls": a.count / n,
                                "device_us": dev_us(a) / n} for a in top]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--precision", choices=["fp32", "fp64"], default="fp32")
    ap.add_argument("--cell", choices=["c4", "ds64", "deep", "window"],
                    default="c4")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    dtype = torch.float32 if args.precision == "fp32" else torch.float64
    if args.cell == "window":
        from ffvd_tpu_torch.data import generate_kink
        from ffvd_tpu_torch.model.params import init_params_random
        model = FFVDModel(
            FFVDConfig(dataset="kink", case=4, minibatch_size=256),
            device="cuda", dtype=dtype, dataset=generate_kink(n=5000),
            params=init_params_random(
                5000, 4, 100, 0, generator=torch.Generator().manual_seed(0),
                device="cuda", dtype=dtype))
    else:
        cfg = {"c4": FFVDConfig(dataset="ballbeam", case=4),
               "ds64": FFVDConfig(dataset="ballbeam", case=4,
                                  collapse_precision="ds64"),
               "deep": FFVDConfig(dataset="flutter", case=4, n_layers=2),
               }[args.cell]
        model = FFVDModel(cfg, device="cuda", dtype=dtype)
    model.fit(20)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit(args.iters)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    model.evaluate()          # the first call builds the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as eprof:
        t0 = time.perf_counter()
        model.evaluate()
        torch.cuda.synchronize()
        eval_us = (time.perf_counter() - t0) * 1e6
    train = _summary(prof, wall_us, args.iters)
    ev = _summary(eprof, eval_us, 1)
    steps = model.dataset.n_test
    out = {
        "card": torch.cuda.get_device_name(0), "cell": args.cell,
        "precision": args.precision,
        "iterations": args.iters, "it_per_s": args.iters / wall_us * 1e6,
        "ms_per_iter": wall_us / args.iters / 1e3,
        "device_busy_share": train["device_busy_share"],
        "cuda_kernels_per_iter": train["cuda_kernels"],
        "host_syncs_and_copies_per_iter": train["host_syncs_and_copies"],
        "top_device_ops_per_iter": train["top_device_ops"],
        "evaluate": {"ms": eval_us / 1e3, "rollout_steps": steps,
                     "cuda_kernels_per_rollout_step": ev["cuda_kernels"]
                     / steps, **ev},
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(
        str(out_dir / f"profile_torch_train_{args.cell}.json"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
