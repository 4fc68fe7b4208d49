"""System-identification dataset loaders.

Counterpart of ``ffvd_tpu/data/loaders.py`` (rebuild of ``create_dataset``,
FFVD_Main.py:134-171): six small time series, column u = control input,
column y = observation; control z-normalised by full-series stats,
observations z-normalised by the *train-half* stats, then a 50/50
chronological train/test split.  Arrays stay numpy float64; the model layer
moves them to a device.

Files are read from ``$FFVD_DATA_DIR``, else ``$FFVD_REFERENCE_DIR/data``,
and fall back to the six datasets vendored beside the JAX package
(``ffvd_tpu/data/vendored/``), read by path as data files.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

import numpy as np

DATASET_FILES = {
    "ballbeam": ("ballbeam.dat", "dat"),
    "dryer": ("dryer.dat", "dat"),
    "flutter": ("flutter.dat", "dat"),
    "actuator": ("actuator.mat", "mat_up"),
    "drive": ("drive.mat", "mat_u1z1"),
    "gas_furnace": ("gas_furnace.csv", "csv"),
}

# The vendored data files shipped with the JAX package (data, not code).
VENDORED_DIR = (Path(__file__).resolve().parents[2]
                / "ffvd_tpu" / "data" / "vendored")


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    y_train: np.ndarray          # (N, 1) normalized
    y_test: np.ndarray           # (N_test, 1) normalized
    control: np.ndarray          # (N_total, U) normalized; U may be 0
    y_train_std: float
    y_train_mean: float
    control_mean: float
    control_std: float

    @property
    def n_train(self) -> int:
        return self.y_train.shape[0]

    @property
    def n_test(self) -> int:
        return self.y_test.shape[0]


def data_dir() -> Optional[Path]:
    """The configured data directory, or None (vendored files only)."""
    env = os.environ.get("FFVD_DATA_DIR")
    if env:
        return Path(env)
    ref = os.environ.get("FFVD_REFERENCE_DIR")
    return Path(ref) / "data" if ref else None


def _read_raw(name: str, root: Optional[Path] = None):
    fname, kind = DATASET_FILES[name]
    explicit = root is not None
    root = root if explicit else data_dir()
    path = root / fname if root is not None else VENDORED_DIR / fname
    if not path.exists() and not explicit:
        # Offline fallback; an explicit ``root`` is never redirected.
        path = VENDORED_DIR / fname
    if not path.exists():
        raise FileNotFoundError(
            f"dataset file {path} not found and not in the vendored set. "
            "Point $FFVD_DATA_DIR at the data/ directory of an upstream "
            "FFVD checkout (github.com/xuhuifan/FFVD).")
    if kind == "dat":
        arr = np.loadtxt(path)
        u, y = arr[:, 0:1], arr[:, 1:2]
    elif kind == "csv":
        arr = np.genfromtxt(path, delimiter=",", skip_header=1)
        u, y = arr[:, 0:1], arr[:, 1:2]
    elif kind == "mat_up":
        import scipy.io
        mat = scipy.io.loadmat(path)
        u, y = mat["u"], mat["p"]
    elif kind == "mat_u1z1":
        import scipy.io
        mat = scipy.io.loadmat(path)
        u, y = mat["u1"], mat["z1"]
    else:  # pragma: no cover
        raise ValueError(kind)
    return np.asarray(u, dtype=np.float64), np.asarray(y, dtype=np.float64)


def create_dataset(name: str, root: Optional[Path] = None) -> Dataset:
    """Load + normalize + split, matching FFVD_Main.py:134-171 semantics."""
    if name not in DATASET_FILES:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(DATASET_FILES)}")
    u, y = _read_raw(name, root)
    c_mean, c_std = float(np.mean(u)), float(np.std(u))
    control = (u - c_mean) / c_std
    lens = y.shape[0]
    half = lens // 2
    y_std = float(np.std(y[:half]))
    y_mean = float(np.mean(y[:half]))
    obs = (y - y_mean) / y_std
    return Dataset(
        name=name,
        y_train=obs[:half],
        y_test=obs[half:],
        control=control,
        y_train_std=y_std,
        y_train_mean=y_mean,
        control_mean=c_mean,
        control_std=c_std,
    )
