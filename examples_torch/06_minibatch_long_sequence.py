"""Random-window minibatch training on a long sequence — the reference's
dead batch plumbing (batch_placeholder, the batch≠Y_N H-scaling at
conditionals_multi_output.py:246-248) made live.

Each gradient evaluation sees one uniform window, so the GP-term cost per
step is O(window·M²) instead of O(N·M²); the optimizer updates over the
(N+1, D) trajectory remain O(N).

Run:  python examples_torch/06_minibatch_long_sequence.py  [--cpu] [--quick]
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data.synthetic import generate_kink
from ffvd_tpu_torch.model.params import init_params_random
from ffvd_tpu_torch.utils.device import default_dtype, resolve_device

DEVICE = resolve_device("cpu" if "--cpu" in sys.argv else "cuda")
QUICK = "--quick" in sys.argv             # a few iterations, for the tests
ITERS = 3 if QUICK else 300

N = 8000                                      # 16x the largest stock dataset
ds = generate_kink(n=N, seed=0)
params = init_params_random(n=N, x_dim=1, m=48, control_dim=0,
                            generator=torch.Generator().manual_seed(0),
                            device=DEVICE, dtype=default_dtype(DEVICE))

for window in (None, 256):
    cfg = FFVDConfig(case=4, num_inducing=48, x_dim=1,
                     minibatch_size=window)
    model = FFVDModel(cfg, device=DEVICE, dataset=ds, params=params)
    t0 = time.time()
    model.fit(num_iterations=ITERS, chunk_size=150)
    dt = time.time() - t0
    r = model.evaluate_quick(num_samples=5, horizon=5)
    label = "full batch" if window is None else f"window={window}"
    print(f"{label:>12}: {ITERS} iters in {dt:6.2f}s "
          f"({ITERS / dt:5.1f} it/s), 5-step RMSE = {r['rmse']:.4f}")
