"""Host µs a training iteration in the port's replay loop: the time inside
``ffvd::train.replay`` spans (``Trainer._replay``: the draws moved to the
card, the state's fingerprint, the graph's inputs copied, one replay an
iteration) less the CUDA runtime calls inside them (``cuda*``) and the
profiler's own buffer ranges, over the traced iterations.  Read under the
profiler, it bounds the loop's Python from above.  A program without the
span gives no reading."""

from perfbench.harness.trace import busy_us

REPLAY = "ffvd::train.replay"
PROFILER = ("Command Buffer Full", "Activity Buffer Request", "Buffer Flush")


def read(w):
    if w.kind != "train" or not w.units:
        return None
    loop = [(s, e) for n, s, e in w.host if n == REPLAY]
    if not loop:
        return None
    calls = [(s, e) for n, s, e in w.host
             if n.startswith("cuda") or n in PROFILER]
    # |loop| − |loop ∩ calls|, each a union of ranges
    inside = busy_us(loop) + busy_us(calls) - busy_us(loop + calls)
    return (busy_us(loop) - inside) / w.units
