"""Train all six system-identification datasets in ONE batched step
(padded + masked + vmapped objective), then evaluate each — impossible in
the reference (one process = one dataset).

Run:  python examples_torch/02_all_datasets_one_jit.py  [--cpu] [--quick]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import time

import torch

from ffvd_tpu_torch.config import DATASETS, FFVDConfig
from ffvd_tpu_torch.data import create_dataset
from ffvd_tpu_torch.parallel.multidataset import (MultiDatasetTrainer,
                                                  stack_datasets)
from ffvd_tpu_torch.utils.device import default_dtype, resolve_device

DEVICE = resolve_device("cpu" if "--cpu" in sys.argv else "cuda")
QUICK = "--quick" in sys.argv             # a few iterations, for the tests

cfg = FFVDConfig(case=4, iterations=1 if QUICK else 2000)
stacked_data, stacked_params, lens = stack_datasets(
    DATASETS, device=DEVICE, dtype=default_dtype(DEVICE))
mdt = MultiDatasetTrainer(cfg, stacked_data)

state = mdt.init_state(stacked_params)
t0 = time.time()
state, nlls = mdt.run(state, cfg.total_iterations, chunk_size=1000,
                      generator=torch.Generator(DEVICE).manual_seed(0))
print(f"6 datasets x {cfg.total_iterations} iterations in "
      f"{time.time()-t0:.1f}s")

datasets = [create_dataset(n) for n in DATASETS]
results = mdt.evaluate(state, datasets, lens,
                       generator=torch.Generator().manual_seed(1))
for name, r in results.items():
    print(f"  {name:12s} RMSE={r['rmse']:.4f}")
