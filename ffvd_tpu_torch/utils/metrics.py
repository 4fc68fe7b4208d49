"""Training metrics and ELBO-term diagnostics.

Counterpart of ``ffvd_tpu/utils/metrics.py``: the per-term bound
decomposition of the reference's ``print_sample_performance``
(base_model.py:952-989) with the same term names, an iterations-per-second
counter, a JSONL sink, the split-R̂ convergence diagnostic of
``MultiChainTrainer`` and the reference's gated-off TensorBoard summaries
(models.py:94-131).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ffvd_tpu_torch.model.elbo import elbo_terms


def elbo_report(params, data, *, u_collapse: bool, iteration: int = 0,
                **elbo_kw) -> Dict[str, float]:
    """Every nll term negated into log-likelihood form, as
    print_sample_performance prints them (base_model.py:959-966)."""
    terms = elbo_terms(params, data, u_collapse=u_collapse, **elbo_kw)
    out = {"iter": iteration, "marginal_ll": -float(terms["nll"])}
    for k, v in terms.items():
        if k != "nll":
            out[f"ll_{k}"] = -float(v)
    return out


class MetricsLogger:
    """Collects per-chunk scalars; optional JSONL file sink."""

    def __init__(self, path: Optional[str] = None,
                 print_every: Optional[int] = 100):
        self.path = Path(path) if path else None
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
        self.print_every = print_every
        self._t0 = time.time()
        self._last_iter = 0
        self.history = []

    def log(self, record: Dict) -> None:
        now = time.time()
        it = record.get("iter", self._last_iter)
        if it > self._last_iter:
            record.setdefault(
                "iters_per_sec",
                (it - self._last_iter) / max(now - self._t0, 1e-9))
            # only records that advance the iteration move the rate clock,
            # so interleaved eval records do not inflate the rate
            self._t0, self._last_iter = now, it
        self.history.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.print_every and it % self.print_every == 0:
            parts = " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in record.items())
            print(f"METRIC {parts}", flush=True)

    def close(self):
        if self._fh:
            self._fh.close()


def split_rhat(trace) -> float:
    """Split-R̂ (Gelman et al. 2013) over a (T, C) multi-chain scalar trace,
    a numpy copy of ``ffvd_tpu/utils/metrics.py::split_rhat``: each chain
    is split in half (2C half-chains of length T//2) and
    R̂ = sqrt((T̂−1)/T̂ + B/(T̂·W)), B and W the between and within
    half-chain variances.  R̂ ≲ 1.01: the halves are indistinguishable.
    NaN for T < 4; a frozen chain (W = B = 0) is 1.0."""
    x = np.asarray(trace, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    t = (x.shape[0] // 2) * 2
    if t < 4:
        return float("nan")
    halves = np.concatenate([x[:t // 2], x[t // 2:t]], axis=1)  # (T/2, 2C)
    n = halves.shape[0]
    w = halves.var(axis=0, ddof=1).mean()
    b = n * halves.mean(axis=0).var(ddof=1)
    if w == 0.0:
        return 1.0 if b == 0.0 else float("inf")
    return float(np.sqrt((n - 1) / n + b / (n * w)))


class TensorBoardSink:
    """The reference's gated-off TensorBoard summaries (models.py:94-131),
    with the JAX package's tags: histograms of C, D, log-Rchols, log-Q, the
    per-dim X and U columns and kernel log-lengthscales; scalars of the
    per-dim kernel log-variance and the marginal LL.  Writes with
    tensorboardX when it is installed, else ``torch.utils.tensorboard``;
    constructing the sink raises ImportError when neither is."""

    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            from torch.utils.tensorboard import SummaryWriter
        self._w = SummaryWriter(log_dir=str(logdir))

    def write(self, params, nll: float, step: int) -> None:
        w = self._w
        a = lambda t: t.detach().cpu().numpy()
        w.add_scalar("marginal-ll", -float(nll), step)
        w.add_histogram("CC-histogram", a(params.c), step)
        w.add_histogram("DD-histogram", a(params.d), step)
        w.add_histogram("log-Rchols-histogram", a(params.log_rchol), step)
        w.add_histogram("log-Q-histogram", a(params.log_q), step)
        x, u = a(params.x), a(params.u)
        lv = a(params.kernel.log_variance)
        ll = a(params.kernel.log_lengthscales)
        for d in range(x.shape[1]):
            w.add_histogram(f"x{d}-histogram", x[:, d], step)
            w.add_histogram(f"U{d}-histogram", u[:, d], step)
            w.add_scalar(f"kernel-{d}-log-variance", float(lv[d]), step)
            w.add_histogram(f"kernel-{d}-log-lengthscales-histogram",
                            ll[d], step)

    def close(self):
        self._w.close()
