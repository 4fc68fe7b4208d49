#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one GPU.

    python scripts/profile_torch_train.py [--iters 50] [--precision fp32]

Trains ballbeam C4 (``ffvd_tpu_torch``) for a few warm-up iterations, then
profiles ``--iters`` more with ``torch.profiler`` and prints one JSON line:
iterations per second, the device's busy share of the window (union of the
CUDA kernel intervals over the wall time), CUDA kernels and host-device
synchronisations per iteration, and the ops with the most device time.  The
chrome trace goes to ``chiprun_out/profile_torch_train.json``.
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--precision", choices=["fp32", "fp64"], default="fp32")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    dtype = torch.float32 if args.precision == "fp32" else torch.float64
    model = FFVDModel(FFVDConfig(dataset="ballbeam", case=4), device="cuda",
                      dtype=dtype)
    model.fit(20)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit(args.iters)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = prof.events()
    cuda_ev = [e for e in events if str(e.device_type).endswith("CUDA")]
    syncs = [e for e in events
             if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "cudaMemcpyAsync", "cudaMemcpy")]
    dev_us = lambda a: getattr(a, "self_device_time_total",
                               getattr(a, "self_cuda_time_total", 0.0))
    top = sorted(prof.key_averages(), key=dev_us, reverse=True)[:12]
    out = {
        "card": torch.cuda.get_device_name(0), "precision": args.precision,
        "iterations": args.iters, "it_per_s": args.iters / wall_us * 1e6,
        "ms_per_iter": wall_us / args.iters / 1e3,
        "device_busy_share": _busy_us(cuda_ev) / wall_us,
        "cuda_kernels_per_iter": len(cuda_ev) / args.iters,
        "host_syncs_and_copies_per_iter": len(syncs) / args.iters,
        "top_device_ops": [
            {"name": a.key, "calls_per_iter": a.count / args.iters,
             "device_us_per_iter": dev_us(a) / args.iters}
            for a in top],
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "profile_torch_train.json"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
