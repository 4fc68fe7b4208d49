"""The comparison that decides ``correct``.

Training: set-up drives the system through its first iterations with the
window's own call: ``stepwise_steps`` calls of one iteration each (the
first ``utils.graphs.WARMUP`` run eagerly, the next captures the graph
and replays it, every later one replays it), then calls of several
iterations; the reference follows them from the same start, in float64.
Compared, each by its worst member, step and leaf:

- ``loss_gap``: each step's nll, |program − reference| / max(|reference|, 1),
  over every step of set-up (an evaluation cell's whole training);
- ``grad_gap``: the gradient of each of the ``stepwise_steps`` steps as
  Adam received it, read from its first moments after the step and before
  it, g_t = (m_t − β1·m_(t−1)) / (1 − β1): the gap between the norms of a
  leaf over the larger of the reference's norm of that leaf and of the
  median leaf;
- ``change_gap``: the norm of each leaf's change over the ``check_steps``,
  likewise, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves those by round-off alone).

Evaluation: the system's ``compare`` of each checked call's output with
the reference's, which trains itself from the start and evaluates from
its own leaves.  Each number has a limit in the configuration
(``limits``); a number over its limit, or not finite, makes the run not
correct.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

BETA1 = 0.9
NEGLIGIBLE = 1e-3       # of the median leaf's gradient norm


def _norms(tree: Dict[str, np.ndarray], n_real: int) -> Dict[str, float]:
    """Each leaf's norm, the trajectory's first ``n_real`` + 1 rows."""
    return {k: float(np.linalg.norm(v[:n_real + 1] if k == "x" else v))
            for k, v in tree.items()}


def _gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    median = float(np.median([ref[k] for k in keys]))
    return float(np.max([abs(prog[k] - ref[k]) / max(ref[k], median)
                         for k in keys]))


def grads_from_moments(moments: List[Dict[str, np.ndarray]]
                       ) -> List[Dict[str, np.ndarray]]:
    """The gradient of each step as Adam received it, from its first
    moments after each step (zeros before the first)."""
    prev = {k: np.zeros_like(v) for k, v in moments[0].items()}
    out = []
    for m in moments:
        out.append({k: (m[k] - BETA1 * prev[k]) / (1.0 - BETA1) for k in m})
        prev = m
    return out


def train_numbers(prog: dict, ref: dict, n_real: List[int]) -> dict:
    """``prog`` and ``ref``: ``nll`` (steps, C); ``grad`` a list over the
    stepwise steps of path → (C, ...); ``start`` and ``after`` the leaves
    before and after the checked steps, path → (C, ...).  ``n_real``: each
    member's transitions (the program's trajectory may carry padding rows
    after them)."""
    nll_p, nll_r = np.asarray(prog["nll"]), np.asarray(ref["nll"])
    loss = float(np.max(np.abs(nll_p - nll_r)
                        / np.maximum(np.abs(nll_r), 1.0)))
    grad = change = 0.0
    for c, n in enumerate(n_real):
        member = lambda tree: {k: v[c] for k, v in tree.items()}
        for g_p, g_r in zip(prog["grad"], ref["grad"], strict=True):
            gr = _norms(member(g_r), n)
            grad = max(grad, _gap(_norms(member(g_p), n), gr, gr))
        gr = _norms(member(ref["grad"][0]), n)
        median = float(np.median(list(gr.values())))
        moved = [k for k in gr if gr[k] >= NEGLIGIBLE * median]
        delta = lambda t: {k: t["after"][k][c] - t["start"][k][c]
                           for k in moved}
        change = max(change, _gap(_norms(delta(prog), n),
                                  _norms(delta(ref), n), moved))
    return {"loss_gap": loss, "grad_gap": float(grad),
            "change_gap": float(change)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} and whether every number is within."""
    rows = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in rows.values())
    return {"checks": rows, "correct": ok}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over several comparisons (NaN if any
    is)."""
    return {k: float(np.max([r[k] for r in readings])) for k in readings[0]}
