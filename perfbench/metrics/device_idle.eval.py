"""Share of the untraced evaluation window in which no kernel ran on the
card, in %: 100 × (1 − busy share), the card's busy µs an evaluation
(the union of the kernels' spans in the traced window) times the untraced
window's evaluations over its length."""


def read(w):
    if w.kind != "eval" or not w.kernels or not w.timed_units:
        return None
    return 100.0 * (1.0 - w.busy_share())
