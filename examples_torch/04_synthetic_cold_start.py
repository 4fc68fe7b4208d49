"""Train on generated kink-dynamics data from a cold start — no warm-start
checkpoint needed (the reference cannot do this at all).

Run:  python examples_torch/04_synthetic_cold_start.py  [--cpu] [--quick]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data.synthetic import generate_kink
from ffvd_tpu_torch.model.params import init_params_random
from ffvd_tpu_torch.utils.device import default_dtype, resolve_device

DEVICE = resolve_device("cpu" if "--cpu" in sys.argv else "cuda")
QUICK = "--quick" in sys.argv             # a few iterations, for the tests

ds = generate_kink(n=120, seed=0)
params = init_params_random(n=ds.n_train, x_dim=1, m=20, control_dim=0,
                            generator=torch.Generator().manual_seed(0),
                            device=DEVICE, dtype=default_dtype(DEVICE))
cfg = FFVDConfig(case=4, num_inducing=20, x_dim=1)
model = FFVDModel(cfg, device=DEVICE, dataset=ds, params=params)
model.fit(num_iterations=5 if QUICK else 4000, chunk_size=1000)

# Short-horizon free-run prediction reaches the observation-noise floor
# (noise std 0.2); long horizons decorrelate — the kink map mixes fast.
for h in (1, 5, 10):
    r = model.evaluate_quick(num_samples=10, horizon=h)
    print(f"{h:2d}-step-ahead RMSE = {r['rmse']:.4f} "
          f"(observation noise std = 0.2)")
