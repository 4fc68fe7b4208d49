"""What a run refuses: a machine without the cards a cell asks for, and a
process that has loaded JAX or the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, List

# Top-level module names that a run may not hold once its window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "ffvd_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``ffvd_tpu_torch`` is not
    ``ffvd_tpu``."""
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))


def card_problem(chips: int):
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is false)"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, the machine has "
                f"{torch.cuda.device_count()}")
    return None
