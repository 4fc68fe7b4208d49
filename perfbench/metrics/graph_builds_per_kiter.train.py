"""Builds of a captured step (``ffvd::graph.warmup`` and
``ffvd::graph.capture`` spans: each eager warm-up and each capture) a
thousand traced training iterations: 0 where every iteration replays the
graph that set-up built.  A program without the spans gives no
reading."""

RUN = "ffvd::train.run"
BUILDS = ("ffvd::graph.warmup", "ffvd::graph.capture")


def read(w):
    if w.kind != "train" or not w.units:
        return None
    if not any(n == RUN for n, _, _ in w.host):
        return None
    return 1000.0 * sum(n in BUILDS for n, _, _ in w.host) / w.units
