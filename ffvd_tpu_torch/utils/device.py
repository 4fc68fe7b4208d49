"""Device and precision selection for the port's entry points."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU.  Without a CUDA device the
    default raises instead of running on the CPU quietly.

    Also turns TF32 off: the JAX package computes every matmul at
    precision="highest", and the port's fp32 must be full fp32 too; on the
    card it names cuSOLVER for the factorisations."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (CLI: --platform "
            "cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        # cuSOLVER's Cholesky reads nothing back to the host (MAGMA's does):
        # eager and captured steps (utils/graphs.py) factorise alike.
        torch.backends.cuda.preferred_linalg_library("cusolver")
    return device


def default_dtype(device: torch.device,
                  precision: Optional[str] = None) -> torch.dtype:
    """fp64 on the CPU (parity), fp32 on the card; ``precision`` ('fp32' or
    'fp64') overrides."""
    if precision is None:
        precision = "fp64" if device.type == "cpu" else "fp32"
    if precision not in ("fp32", "fp64"):
        raise ValueError(f"invalid precision {precision!r}")
    return torch.float64 if precision == "fp64" else torch.float32
