"""Multi-output emission with a FULL emission-noise covariance, trained
end-to-end — a path the reference ships code for but never wires up (its
P>1 ELBO indexes a Cholesky ROW into the diagonal density,
dgp_model.py:250; see ffvd_tpu_torch/model/params.py:GPSSMParams.rchol).

Run:  python examples_torch/05_multidim_emission.py  [--cpu] [--quick]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data.synthetic import generate_linear
from ffvd_tpu_torch.model.params import init_params_random
from ffvd_tpu_torch.utils.device import default_dtype, resolve_device

DEVICE = resolve_device("cpu" if "--cpu" in sys.argv else "cuda")
QUICK = "--quick" in sys.argv             # a few iterations, for the tests

# A linear SSM observed through TWO output channels whose emission noise is
# genuinely correlated (corr = +0.6) — only a full R can represent that.
# A 1-D latent keeps the correlated noise identifiable (with many latent
# dims the free-form trajectory absorbs emission noise instead).
ds, truth = generate_linear(n=150, x_dim=1, y_dim=2, r_std=0.3, r_corr=0.6,
                            seed=0)
params = init_params_random(n=ds.n_train, x_dim=1, m=16, control_dim=0, p=2,
                            generator=torch.Generator().manual_seed(0),
                            device=DEVICE, dtype=default_dtype(DEVICE))
cfg = FFVDConfig(case=4, num_inducing=16, x_dim=1)   # emission_noise="auto"
model = FFVDModel(cfg, device=DEVICE, dataset=ds, params=params)
model.fit(num_iterations=5 if QUICK else 3000, chunk_size=1000)

l = model.params.rchol.detach().cpu().double().numpy()
r = l @ l.T
corr = r[0, 1] / (r[0, 0] * r[1, 1]) ** 0.5
true_r = truth["R_cov"] / ds.y_train_std ** 2   # data are z-normalized
print(f"learned emission noise covariance:\n{r}")
print(f"true (normalized) emission noise covariance:\n{true_r}")
print(f"learned cross-channel correlation: {corr:+.3f} (true +0.600, "
      f"off-diagonal Cholesky was TRAINED: L10 = {l[1, 0]:+.4f})")
res = model.evaluate_quick(num_samples=10, horizon=5)
print(f"5-step-ahead RMSE over both channels = {res['rmse']:.4f}")
