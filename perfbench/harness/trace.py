"""The traced window: a ``torch.profiler`` trace of the card and the host,
reduced to what the per-layer metrics read.

``busy_us`` and ``KERNEL_CLASSES`` are copies of
``ffvd_tpu_torch/utils/profiling.py`` (``_busy_us``, ``KERNEL_CLASSES``,
the busy share and the split by class of its ``summarize``), kept here so
that the program cannot change the yardstick.  Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Tuple

# Device kernels by what they compute, from their names (cuSOLVER,
# cuBLAS, CUTLASS and MAGMA kernels); the first class that matches wins.
KERNEL_CLASSES = (
    ("cholesky", re.compile(r"potrf|chol", re.I)),
    ("trsm", re.compile(r"trsm|trsv|trtri", re.I)),
    ("gemm", re.compile(r"gemm|xmma|cutlass|gemv|dot_kernel", re.I)),
)
# Host calls that wait for the card.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
# The span that the runner opens around the traced window, and those it
# opens around each call in it: host ranges, which the profiler also lists
# on the card's timeline, where they are no kernels.
WINDOW_SPAN = "perfbench.window"
CALL_SPANS = ("train.chunk", "eval.call")


def busy_us(spans) -> float:
    """Length of the union of (start, end) ranges, in µs."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def kernel_class(name: str) -> str:
    return next((c for c, rx in KERNEL_CLASSES if rx.search(name)), "other")


@dataclasses.dataclass
class Window:
    """One traced window of ``units`` iterations (training) or calls
    (evaluation) over ``wall_us``.  ``kernels``: (name, start µs, end µs)
    of every card kernel; ``host``: (name, start, end) of every host op;
    ``work``: the shapes of the work (``systems``' ``work``).  The
    untraced window of the same run, which ``timed`` records: its
    ``timed_units`` over ``timed_wall_us`` and each call's seconds
    (``durations``), all on the host clock."""

    kind: str
    units: int
    wall_us: float
    start_us: float
    kernels: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    work: dict
    device_name: str
    timed_units: int = 0
    timed_wall_us: float = 0.0
    durations: List[float] = dataclasses.field(default_factory=list)

    def timed(self, units: int, wall_s: float, durations: List[float]):
        """Record the untraced window: ``units`` over ``wall_s``."""
        self.timed_units, self.timed_wall_us = units, wall_s * 1e6
        self.durations = list(durations)

    def timed_per_s(self) -> float:
        """Units a second of the untraced window."""
        return self.timed_units / (self.timed_wall_us * 1e-6)

    def busy_share(self) -> float:
        """The share of the untraced window in which the card was busy,
        were each unit as busy as in the traced one."""
        return self.busy_us / self.units * self.timed_units \
            / self.timed_wall_us

    @property
    def busy_us(self) -> float:
        return busy_us((s, e) for _, s, e in self.kernels)

    def device_us(self, match=lambda name: True) -> float:
        """Summed device time of the kernels whose name ``match``es."""
        return sum(e - s for n, s, e in self.kernels if match(n))

    def by_class(self) -> Dict[str, float]:
        out = defaultdict(float)
        for n, s, e in self.kernels:
            out[kernel_class(n)] += e - s
        return dict(out)

    def syncs(self) -> int:
        return sum(1 for n, _, _ in self.host if n in SYNCS)


def window_of(prof, kind: str, units: int, work: dict,
              device_name: str) -> Window:
    """The ``Window`` of a profiler run whose window the runner wrapped in
    the ``WINDOW_SPAN`` record: its events inside that span."""
    events = prof.events()
    on_card = lambda e: str(e.device_type).endswith("CUDA")
    span = next(e for e in events if e.name == WINDOW_SPAN and not on_card(e))
    t0, t1 = span.time_range.start, span.time_range.end
    kernels, host = [], []
    for e in events:
        s, f = e.time_range.start, e.time_range.end
        if s < t0 or s > t1 or e is span:
            continue
        if on_card(e):
            if (e.name == WINDOW_SPAN or e.name in CALL_SPANS
                    or getattr(e, "is_user_annotation", False)):
                continue
            kernels.append((e.name, s, f))
        else:
            host.append((e.name, s, f))
    return Window(kind=kind, units=units, wall_us=t1 - t0, start_us=t0,
                  kernels=kernels, host=host, work=work,
                  device_name=device_name)


def breakdown(w: Window, top: int = 10) -> dict:
    """The device ops that took the most time, and the card's idle time
    inside the window by what the host was doing then (the innermost host
    op over each gap's middle), each [name, seconds]."""
    ops = defaultdict(float)
    for n, s, e in w.kernels:
        ops[n[:160]] += (e - s) * 1e-6
    gaps = defaultdict(float)
    spans = sorted((s, e) for _, s, e in w.kernels)
    edge = w.start_us
    idle = []
    for s, e in spans:
        if s > edge:
            idle.append((edge, s))
        edge = max(edge, e)
    if w.start_us + w.wall_us > edge:
        idle.append((edge, w.start_us + w.wall_us))
    # A sweep over the host ops by start, a stack of the open ones: with
    # nested ops the top of the stack is the innermost at the gap's middle.
    host = sorted(w.host, key=lambda h: (h[1], -h[2]))
    stack, i = [], 0
    for g0, g1 in idle:
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "host: outside any traced op"
        gaps[name[:160]] += (g1 - g0) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
