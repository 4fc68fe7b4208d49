#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one GPU.

    python scripts/profile_torch_train.py [--iters 50] [--precision fp32]
        [--cell c4|c5|ds64|deep|window|multichain|six_ds_m512] [--trace]

Trains one cell of PERF.md §4 (``ffvd_tpu_torch``): ``c4`` ballbeam C4,
``c5`` ballbeam C5 (21 SG-HMC sub-steps an iteration, and an evaluation
that thins 10 × 32 sub-steps), ``ds64`` the same as ``c4`` with ``collapse_precision="ds64"`` (the collapsed segment
in float64), ``deep`` flutter C4 with ``n_layers=2``, ``window`` C4 on the
N=5000 kink data from a cold start with 256-step windows, ``multichain``
ballbeam C4 as 8 chains of one ``MultiChainTrainer`` step, ``six_ds_m512``
all six datasets at M=512 in one ``MultiDatasetTrainer`` step (BASELINE
config 5).  It runs the cell twice, eagerly (``capture=False``) and
replaying CUDA graphs (the default, ``utils/graphs.py``): after 20
warm-up iterations (which include the capture) it profiles ``--iters``
more, one chunk, with ``torch.profiler``, and reports iterations per
second, the device's busy share of the window, CUDA kernels and host-device
synchronisations or copies per iteration and in the whole window (one
chunk reads the host once, for its NaN check), device time per iteration
by kernel class (Cholesky, triangular solves, gemm, other) and the ops with
the most device time; then the same for one evaluation (``evaluate()``, or
``multichain_moments`` / ``MultiDatasetTrainer.evaluate`` for the batched
cells; kernels per rollout step for a recursion).  One JSON line holds
both runs.  With ``--trace`` the captured run's training chrome trace
goes to ``chiprun_out/profile_torch_train_<cell>.json`` (tens of MB).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELLS = ["c4", "c5", "ds64", "deep", "window", "multichain",
         "six_ds_m512"]


def _model(cell, dtype, capture):
    """(train(n), evaluate(), evaluation steps) of a single-model cell."""
    import torch

    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    if cell == "window":
        from ffvd_tpu_torch.data import generate_kink
        from ffvd_tpu_torch.model.params import init_params_random
        model = FFVDModel(
            FFVDConfig(dataset="kink", case=4, minibatch_size=256),
            device="cuda", dtype=dtype, dataset=generate_kink(n=5000),
            params=init_params_random(
                5000, 4, 100, 0, generator=torch.Generator().manual_seed(0),
                device="cuda", dtype=dtype), capture=capture)
    else:
        cfg = {"c4": FFVDConfig(dataset="ballbeam", case=4),
               "c5": FFVDConfig(dataset="ballbeam", case=5),
               "ds64": FFVDConfig(dataset="ballbeam", case=4,
                                  collapse_precision="ds64"),
               "deep": FFVDConfig(dataset="flutter", case=4, n_layers=2),
               }[cell]
        model = FFVDModel(cfg, device="cuda", dtype=dtype, capture=capture)
    return (lambda n: model.fit(n), lambda: model.evaluate(),
            model.dataset.n_test)


def _batched(cell, dtype, capture):
    """(train(n), evaluate(), evaluation steps) of a batched cell."""
    import torch

    from ffvd_tpu_torch.config import DATASETS, FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.model.params import (SSMData,
                                             init_params_from_warmstart)
    from ffvd_tpu_torch.parallel import (MultiChainTrainer,
                                         MultiDatasetTrainer, stack_datasets)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if cell == "multichain":
        from ffvd_tpu_torch.eval.ensemble import multichain_moments
        ds = create_dataset("ballbeam")
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
        tr = MultiChainTrainer(FFVDConfig(dataset="ballbeam", case=4),
                               SSMData(y=as_t(ds.y_train),
                                       control=as_t(ds.control)), 8)
        state = tr.init_state(tr.stack_params(init_params_from_warmstart(
            load_warmstart("ballbeam"), device="cuda", dtype=dtype), gen))
        steps = ds.n_test
        evaluate = lambda: multichain_moments(
            tr, state, steps, generator=torch.Generator().manual_seed(1))
    else:
        data, params, lens = stack_datasets(DATASETS, device="cuda",
                                            dtype=dtype, m=512)
        tr = MultiDatasetTrainer(FFVDConfig(dataset="ballbeam", case=4,
                                            num_inducing=512), data)
        state = tr.init_state(params)
        dss = [create_dataset(n) for n in DATASETS]
        steps = sum(d.n_test for d in dss)
        evaluate = lambda: tr.evaluate(
            state, dss, lens, generator=torch.Generator().manual_seed(1))
    return (lambda n: tr.run(state, n, chunk_size=n, generator=gen,
                             capture=capture), evaluate, steps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--precision", choices=["fp32", "fp64"], default="fp32")
    ap.add_argument("--cell", choices=CELLS, default="c4")
    ap.add_argument("--trace", action="store_true",
                    help="write the captured run's chrome trace")
    args = ap.parse_args(argv)

    import torch

    from ffvd_tpu_torch.utils.device import resolve_device
    from ffvd_tpu_torch.utils.profiling import profile_window, summarize
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    resolve_device("cuda")
    dtype = torch.float32 if args.precision == "fp32" else torch.float64
    batched = args.cell in ("multichain", "six_ds_m512")
    out = {"card": torch.cuda.get_device_name(0), "cell": args.cell,
           "precision": args.precision, "iterations": args.iters}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for mode, capture in (("eager", False), ("captured", None)):
        train, evaluate, steps = (_batched if batched else _model)(
            args.cell, dtype, capture)
        train(20)                 # warm-up; the captured run captures here
        prof, wall_us = profile_window(lambda: train(args.iters))
        evaluate()                # the first call builds the kernel
        eprof, eval_us = profile_window(evaluate)
        tr = summarize(prof, wall_us, args.iters)
        ev = summarize(eprof, eval_us, 1)
        out[mode] = {
            "it_per_s": args.iters / wall_us * 1e6,
            "ms_per_iter": wall_us / args.iters / 1e3,
            "device_busy_share": tr["device_busy_share"],
            "cuda_kernels_per_iter": tr["cuda_kernels"],
            "host_syncs_and_copies_per_iter": tr["host_syncs_and_copies"],
            "host_syncs_and_copies_in_window":
                tr["host_syncs_and_copies"] * args.iters,
            "device_us_per_iter_by_class": tr["device_us_by_class"],
            "top_device_ops_per_iter": [
                {**op, "name": op["name"][:100]}
                for op in tr["top_device_ops"][:6]],
            "evaluate": {"ms": eval_us / 1e3, "rollout_steps": steps,
                         "cuda_kernels_per_rollout_step": ev["cuda_kernels"]
                         / steps,
                         **{k: v for k, v in ev.items()
                            if k != "top_device_ops"}},
        }
        if mode == "captured" and args.trace:
            prof.export_chrome_trace(
                str(out_dir / f"profile_torch_train_{args.cell}.json"))
    out["captured_speedup"] = (out["captured"]["it_per_s"]
                               / out["eager"]["it_per_s"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
