"""Case C6: particle Gibbs (conditional SMC) over the latent trajectory.

In the reference the PG assign is dead in the graph (base_model.py:137-138)
— so upstream "C6" trains with X frozen at the warm start.  Here the
conditional SMC really runs, by default the ancestor-traced variant:
coherent smoothing-posterior draws.

This example trains a short C6 run on ballbeam (the dataset and warm start
are in the repository) and prints the CSMC mixing diagnostics between
training segments:

  ref_survival   fraction of time steps where the retained reference
                 particle survives resampling (should sit well inside
                 (0.5, 1): surviving but not dominating),
  unique_frac    mean fraction of distinct pool members selected per
                 resampling step (1/P = total particle collapse),
  accepted       whether the sweep replaced X with a fresh trajectory,
  dx_mean_abs    mean |Δx| the sweep applied.

Run:  python examples_torch/09_particle_gibbs_c6.py  [--cpu] [--quick]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn

DEVICE = "cpu" if "--cpu" in sys.argv else "cuda"
QUICK = "--quick" in sys.argv             # a few iterations, for the tests
SEGMENT = 1 if QUICK else 100

cfg = FFVDConfig(dataset="ballbeam", case=6, iterations=150)  # 300 steps
model = FFVDModel(cfg, device=DEVICE)
assert model.cfg.pg_ancestor_trace          # the default

stats_fn = make_pg_fn(model.cfg, with_stats=True)
gen = torch.Generator(model.device).manual_seed(99)
for seg in range(3):
    model.fit(SEGMENT, chunk_size=SEGMENT)
    _, st = stats_fn(model.params, gen, model.data)
    print(f"after {SEGMENT * (seg + 1):3d} iters: "
          + "  ".join(f"{k}={float(v):.3f}" for k, v in sorted(st.items())))

res = model.evaluate_quick(num_samples=5)
print(f"quick eval: RMSE {res['rmse']:.4f}  NLL {res['nll']:.2f} "
      "(full-protocol 5-seed median: 0.0064 — PARITY §2b)")
