"""Profiling and tracing helpers.

Counterpart of ``ffvd_tpu/utils/profiling.py``.  The reference's only
tracing is commented-out ``time.time()`` probes (models.py:141-197) feeding
a ``running_time_seq`` saved into the results npz (base_model.py:516).
Here: a ``torch.profiler`` trace written as a Chrome trace, the port's
spans, and a summary of a profiled window (device busy share, kernels and
host syncs per iteration, device time by op and by kernel class).

The spans are ``torch.profiler`` ranges, so a trace puts them on the
profiler's clock beside the card's kernels and the CUDA runtime calls.
``span`` opens one only while a profiler records; otherwise it returns a
shared null context.  Each is opened once a call, chunk, build, stage or
launch, never once an iteration, a kernel or a chain:

- ``ffvd::train.run``: ``Trainer.run``, a call;
- ``ffvd::train.replay``: ``Trainer._replay``'s host loop of a chunk's
  replays;
- ``ffvd::train.read``: a chunk's trace gathered and read for the NaN
  check;
- ``ffvd::graph.warmup``, ``ffvd::graph.capture``: ``StepGraph``'s eager
  warm-ups and its capture;
- ``ffvd::eval``: one evaluation (``multichain_moments``,
  ``MultiDatasetTrainer.evaluate``, ``collect_posterior``);
- ``ffvd::eval.build``: ``MultiDatasetTrainer.evaluate``'s trainer and
  state of a dataset;
- ``ffvd::eval.thin``: ``thin_posterior``;
- ``ffvd::eval.prep``: what an evaluation does before its rollout (the
  members' rows, the Kmm factors, q(U), the kernel's inputs);
- ``ffvd::eval.rollout``: a rollout launch (``ops.rollout.rollout``,
  ``rollout_batched``) or ``recursion_rollout``;
- ``ffvd::eval.moments``: what follows the rollout (the emission moments,
  the scores and their host copies);
- ``ffvd::all_sum``: a collective (``parallel.distributed.all_sum``).
"""

from __future__ import annotations

import contextlib
import functools
import re
import time
from pathlib import Path
from typing import Callable, Dict

import torch

from ffvd_tpu_torch.utils.timing import hard_sync


@contextlib.contextmanager
def trace(logdir: str = "ffvd_trace"):
    """Profile the block with ``torch.profiler`` (host, and the card when
    there is one) and write ``<logdir>/trace.json``, viewable in Perfetto
    or chrome://tracing.  Yields the profiler, whose ``key_averages()``
    tabulates the kernels."""
    Path(logdir).mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        hard_sync()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else one shared null context: with no profiler a
    span costs a flag check, not a range entered and left."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str) -> Callable:
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _busy_us(events) -> float:
    """Length of the union of the events' time ranges, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


# Device kernels by what they compute, from their names (cuSOLVER,
# cuBLAS, CUTLASS and MAGMA kernels); the first class that matches wins.
KERNEL_CLASSES = (
    ("cholesky", re.compile(r"potrf|chol", re.I)),
    ("trsm", re.compile(r"trsm|trsv|trtri", re.I)),
    ("gemm", re.compile(r"gemm|xmma|cutlass|gemv|dot_kernel", re.I)),
)


def summarize(prof, wall_us: float, n: int) -> Dict:
    """A ``torch.profiler`` window of ``n`` repeats over ``wall_us``: the
    device's busy share (the union of the CUDA kernel intervals over the
    wall time) and, per repeat, CUDA kernels, host syncs or copies, device
    µs by kernel class (``KERNEL_CLASSES``, the rest as "other"), and the
    12 ops with the most device time."""
    events = prof.events()
    cuda_ev = [e for e in events if str(e.device_type).endswith("CUDA")]
    syncs = [e for e in events
             if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "cudaMemcpyAsync", "cudaMemcpy")]
    split = {name: 0.0 for name, _ in KERNEL_CLASSES}
    split["other"] = 0.0
    for e in cuda_ev:
        name = next((c for c, rx in KERNEL_CLASSES if rx.search(e.name)),
                    "other")
        split[name] += e.time_range.end - e.time_range.start
    dev_us = lambda a: getattr(a, "self_device_time_total",
                               getattr(a, "self_cuda_time_total", 0.0))
    top = sorted(prof.key_averages(), key=dev_us, reverse=True)[:12]
    return {"device_busy_share": _busy_us(cuda_ev) / wall_us,
            "cuda_kernels": len(cuda_ev) / n,
            "host_syncs_and_copies": len(syncs) / n,
            "device_us_by_class": {k: v / n for k, v in split.items()},
            "top_device_ops": [{"name": a.key, "calls": a.count / n,
                                "device_us": dev_us(a) / n} for a in top]}


def profile_window(fn):
    """Run ``fn`` under ``torch.profiler`` with the card's activity, the
    card synchronised before and after; returns (the profiler, wall µs)."""
    from torch.profiler import ProfilerActivity, profile
    hard_sync()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        hard_sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us
