"""Share of the untraced training window in which no kernel ran on the
card, in %: 100 × (1 − busy share), the card's busy µs an iteration (the
union of the kernels' spans in the traced window) times the untraced
window's iterations over its length."""


def read(w):
    if w.kind != "train" or not w.kernels or not w.timed_units:
        return None
    return 100.0 * (1.0 - w.busy_share())
