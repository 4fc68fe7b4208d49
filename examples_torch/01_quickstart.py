"""Quickstart: train the default FFVD benchmark (ballbeam, case C4) on the
card and evaluate free-running prediction — the equivalent of
`python FFVD_Main.py --file_index 5` in the reference.

Run:  python examples_torch/01_quickstart.py  [--cpu] [--quick]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import time

from ffvd_tpu_torch import FFVDConfig
from ffvd_tpu_torch.api import FFVDModel

DEVICE = "cpu" if "--cpu" in sys.argv else "cuda"
QUICK = "--quick" in sys.argv             # a few iterations, for the tests

cfg = FFVDConfig(dataset="ballbeam", case=4, iterations=2 if QUICK else 2000)
model = FFVDModel(cfg, device=DEVICE)

t0 = time.time()
model.fit()                                   # 2*iterations outer steps
print(f"trained {cfg.total_iterations} iterations in {time.time()-t0:.2f}s; "
      f"ELBO {-float(model.nll_trace[0]):.3f} -> "
      f"{-float(model.nll_trace[-1]):.3f}")

res = model.evaluate()                        # 10-sample posterior rollout
print(f"RMSE = {res['rmse']:.4f} (reference TF run: 0.0282)")
model.save_results("results/quickstart_ballbeam.npz")
