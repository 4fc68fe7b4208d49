"""Calibrated uncertainty: spread-mode evaluation and chain ensembles.

The reference's NLL estimator drops the across-rollout spread of the
per-sample predictive means (base_model.py:334-343), so its predictive
variance is far too small; ``evaluate(spread=True)`` adds it back, and
``fit_ensemble`` pools independent chains (seeds, or a jittered warm start
for the deterministic case) into one mixture.

Run:  python examples_torch/08_ensemble_calibration.py  [--cpu] [--quick]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from ffvd_tpu_torch import FFVDConfig
from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.eval import ensemble_evaluate, fit_ensemble

DEVICE = "cpu" if "--cpu" in sys.argv else "cuda"
QUICK = "--quick" in sys.argv             # a few iterations, for the tests
ITERS = 500        # demo-sized; the benchmark protocol is 2000
ITERS_SGHMC = 150  # C5 runs 21 grad evals/iteration
# --quick: one outer iteration a fit, and C5 thins fewer posterior samples
# (each 32 sampler sub-steps).
FIT = dict(num_iterations=1) if QUICK else {}
THIN = dict(num_posterior_samples=2, posterior_sample_spacing=2) if QUICK \
    else {}

# --- 1. single chain + spread-mode eval (C4 is deterministic) -----------
cfg = FFVDConfig(dataset="ballbeam", case=4, iterations=ITERS)
model = FFVDModel(cfg, device=DEVICE)
model.fit(**FIT)
plain = model.evaluate()
spread = model.evaluate(num_samples=40, spread=True)
print(f"single chain   : RMSE {plain['rmse']:.4f}  NLL {plain['nll']:.1f}")
print(f"  + spread eval: RMSE {spread['rmse']:.4f}  NLL {spread['nll']:.2f}"
      "   <- calibrated")

# --- 2. seed ensemble on a sampler case (chains genuinely differ) -------
cfg5 = FFVDConfig(dataset="ballbeam", case=5, iterations=ITERS_SGHMC, **THIN)
models = fit_ensemble(cfg5, 2, device=DEVICE, **FIT)
res = ensemble_evaluate(models)
chains = "/".join(f"{c['rmse']:.4f}" for c in res["per_chain"])
print(f"C5 seed ens(2) : RMSE {res['rmse']:.4f} (chains {chains})  "
      f"NLL {res['nll']:.2f} (no-spread {res['nll_no_spread']:.0f})")

# --- 3. jittered ensemble (diversity for the deterministic case) --------
jit_models = fit_ensemble(cfg, 2, device=DEVICE, init_jitter=1e-3, **FIT)
jres = ensemble_evaluate(jit_models)
print(f"C4 jit ens(2)  : RMSE {jres['rmse']:.4f}  NLL {jres['nll']:.2f}")
