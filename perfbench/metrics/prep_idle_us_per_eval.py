"""Card idle µs an evaluation while the port prepares its rollouts: the
card's idle time in the traced window (outside the union of its kernels'
spans) that falls inside an ``ffvd::eval.build``, ``ffvd::eval.thin`` or
``ffvd::eval.prep`` span, scaled to the untraced window.

The traced window's idle time is split among the evaluation's stages by
the spans open at each moment, the first in ``STAGES`` that is open taking
it: the rollout launch, then the moments, then the preparation; idle time
in none of them (the caller's Python, port code that no stage covers) is
``unspanned``.  The parts are then scaled so that they sum to the untraced
window's idle time an evaluation, its seconds an evaluation less the card's
busy time an evaluation in the trace (at least 0): the profiler's host
overhead sets the shares, not the total.  A program without the spans gives
no reading."""

EVAL = "ffvd::eval"
STAGES = (("rollout", ("ffvd::eval.rollout",)),
          ("moments", ("ffvd::eval.moments",)),
          ("prep", ("ffvd::eval.build", "ffvd::eval.thin",
                    "ffvd::eval.prep")))


def split(w):
    """The traced window's card idle µs by stage (``STAGES``' names and
    "unspanned"), or None where no ``ffvd::eval`` span was recorded."""
    stage_of = {n: k for k, names in STAGES for n in names}
    if not any(n == EVAL for n, _, _ in w.host):
        return None
    # A sweep over every edge: counts of open kernels and of open spans of
    # each stage; each stretch between two edges goes to its owner.
    edges = []
    for _, s, e in w.kernels:
        edges += [(s, 1, "busy"), (e, -1, "busy")]
    for n, s, e in w.host:
        if n in stage_of:
            edges += [(s, 1, stage_of[n]), (e, -1, stage_of[n])]
    t0, t1 = w.start_us, w.start_us + w.wall_us
    edges += [(t0, 0, "busy"), (t1, 0, "busy")]
    edges.sort(key=lambda x: x[0])
    open_ = dict.fromkeys(["busy"] + [k for k, _ in STAGES], 0)
    out = dict.fromkeys([k for k, _ in STAGES] + ["unspanned"], 0.0)
    prev = None
    for t, step, kind in edges:
        if prev is not None and t > prev and not open_["busy"]:
            a, b = max(prev, t0), min(t, t1)
            if b > a:
                owner = next((k for k, _ in STAGES if open_[k]), "unspanned")
                out[owner] += b - a
        open_[kind] += step
        prev = t
    return out


def idle_us_per_eval(w, stage: str):
    """``stage``'s part of the untraced window's card idle µs an
    evaluation."""
    if w.kind != "eval" or not w.units or not w.timed_units:
        return None
    parts = split(w)
    if parts is None:
        return None
    traced = sum(parts.values())
    untraced = max(0.0, w.timed_wall_us / w.timed_units - w.busy_us / w.units)
    return parts[stage] / traced * untraced if traced > 0 else 0.0


def read(w):
    return idle_us_per_eval(w, "prep")
