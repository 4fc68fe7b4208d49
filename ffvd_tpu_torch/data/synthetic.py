"""Synthetic GPSSM data generation.

A copy of ``ffvd_tpu/data/synthetic.py`` (numpy only; the port imports
nothing of the JAX package), so the same seed gives the same arrays in both
packages:

- ``generate_kink``: the classic kink-dynamics benchmark used across the
  GPSSM literature, x_{t+1} = 0.8 + (x_t + ε)·(1 − 5/(1 + e^{−2x_t})),
  observed with additive Gaussian noise.
- ``generate_linear``: a random stable linear-Gaussian SSM (the reference's
  'linear_dynamic_systems' path) with known (A, C, Q, R) for sampler
  validation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ffvd_tpu_torch.data.loaders import Dataset


def kink_fn(x: np.ndarray) -> np.ndarray:
    return 0.8 + (x + 0.2) * (1.0 - 5.0 / (1.0 + np.exp(-2.0 * x)))


def generate_kink(n: int = 120, process_noise_std: float = 0.05,
                  observation_noise_std: float = 0.2,
                  x0: float = 0.5, seed: int = 0) -> Dataset:
    """1-D kink dynamics, observed directly; 50/50 split + train-half
    normalization like create_dataset (FFVD_Main.py:160-168)."""
    rng = np.random.RandomState(seed)
    x = np.zeros(2 * n)
    x[0] = x0
    for t in range(2 * n - 1):
        x[t + 1] = kink_fn(x[t]) + process_noise_std * rng.randn()
    y = (x + observation_noise_std * rng.randn(2 * n))[:, None]
    half = n
    y_std = float(np.std(y[:half]))
    y_mean = float(np.mean(y[:half]))
    obs = (y - y_mean) / y_std
    return Dataset(name="kink", y_train=obs[:half], y_test=obs[half:],
                   control=np.zeros((2 * n, 0)), y_train_std=y_std,
                   y_train_mean=y_mean, control_mean=0.0, control_std=1.0)


def generate_linear(n: int = 200, x_dim: int = 2, y_dim: int = 1,
                    q_std: float = 0.1, r_std: float = 0.1,
                    r_corr: float = 0.0,
                    seed: int = 0) -> Tuple[Dataset, dict]:
    """Random stable linear SSM; returns the dataset and the true params.

    ``r_corr``: pairwise correlation of the emission noise across output
    channels (y_dim > 1) — exercises the full-Cholesky R emission path."""
    rng = np.random.RandomState(seed)
    a = rng.randn(x_dim, x_dim)
    a = 0.9 * a / np.max(np.abs(np.linalg.eigvals(a)))
    c = rng.randn(x_dim, y_dim)
    r_cov = (r_std ** 2) * ((1 - r_corr) * np.eye(y_dim)
                            + r_corr * np.ones((y_dim, y_dim)))
    r_chol = np.linalg.cholesky(r_cov)
    x = np.zeros((2 * n + 1, x_dim))
    ys = np.zeros((2 * n, y_dim))
    for t in range(2 * n):
        x[t + 1] = a @ x[t] + q_std * rng.randn(x_dim)
        ys[t] = c.T @ x[t + 1] + r_chol @ rng.randn(y_dim)
    half = n
    y_std = float(np.std(ys[:half]))
    y_mean = float(np.mean(ys[:half]))
    obs = (ys - y_mean) / y_std
    ds = Dataset(name="linear", y_train=obs[:half], y_test=obs[half:],
                 control=np.zeros((2 * n, 0)), y_train_std=y_std,
                 y_train_mean=y_mean, control_mean=0.0, control_std=1.0)
    truth = {"A": a, "C": c, "Q_std": q_std, "R_std": r_std,
             "R_cov": r_cov, "x": x}
    return ds, truth
