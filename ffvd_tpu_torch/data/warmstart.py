"""Factnonlin warm-start checkpoint loader.

Counterpart of ``ffvd_tpu/data/warmstart.py``.  The reference mandates a warm
start from a pre-trained factorised-non-linear model stored as npz
(FFVD_Main.py:212-229); files are selected by sorted order.  The default
warm start (file_id=3) of all six datasets is vendored beside the JAX package
and listed in its ``MANIFEST.json``; other file_ids need
``$FFVD_WARMSTART_DIR`` or ``$FFVD_REFERENCE_DIR/Factnonlin_ini``.
"""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from ffvd_tpu_torch.data.loaders import VENDORED_DIR

REQUIRED_KEYS = (
    "qx1_mu_ini", "Umu_ini", "Q_sqrt_ini", "kernel_variance",
    "kernel_lengthscales", "C_val", "d_val", "Z_val", "R_chol_val",
    "x_samples_training",
)


def warmstart_dir() -> Optional[Path]:
    """The configured warm-start directory, or None (vendored files only)."""
    env = os.environ.get("FFVD_WARMSTART_DIR")
    if env:
        return Path(env)
    ref = os.environ.get("FFVD_REFERENCE_DIR")
    return Path(ref) / "Factnonlin_ini" if ref else None


def list_warmstarts(dataset: str, root: Optional[Path] = None) -> List[str]:
    root = root or warmstart_dir()
    if root is None:
        return []
    pattern = str(root / f"factnonlin_initialized_10000_{dataset}*.npz")
    return sorted(glob.glob(pattern))


def _vendored_warmstart(dataset: str, file_id: int) -> Optional[str]:
    """The vendored file for (dataset, file_id) per MANIFEST.json, if any."""
    manifest = VENDORED_DIR / "MANIFEST.json"
    if not manifest.exists():
        return None
    for fname, meta in json.loads(manifest.read_text()).items():
        if (meta.get("dataset") == dataset
                and meta.get("file_id") == file_id
                and (VENDORED_DIR / fname).exists()):
            return str(VENDORED_DIR / fname)
    return None


def load_warmstart(dataset: str, file_id: int = 3,
                   root: Optional[Path] = None) -> dict:
    """Load warm-start file #file_id (sorted order) for a dataset."""
    files = list_warmstarts(dataset, root)
    if not files and root is None:
        vendored = _vendored_warmstart(dataset, file_id)
        if vendored is not None:
            files = [vendored]
            file_id = 0
    if not files:
        raise FileNotFoundError(
            f"no warm-start npz for {dataset!r} under "
            f"{root or warmstart_dir()} and no vendored fallback (only "
            "file_id=3 is vendored): point $FFVD_WARMSTART_DIR at the "
            "Factnonlin_ini/ directory of an upstream FFVD checkout "
            "(github.com/xuhuifan/FFVD).")
    if not 0 <= file_id < len(files):
        raise IndexError(
            f"file_id {file_id} out of range: {len(files)} warm-start files "
            f"exist for {dataset!r}")
    path = files[file_id]
    with np.load(path, allow_pickle=True) as z:
        out = {k: np.asarray(z[k]) for k in z.files}
    missing = [k for k in REQUIRED_KEYS if k not in out]
    if missing:
        raise KeyError(f"warm-start {path} missing keys {missing}")
    out["__path__"] = path
    return out
