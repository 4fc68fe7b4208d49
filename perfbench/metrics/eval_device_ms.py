"""The card's busy time an evaluation, in ms: the union of the spans of
every kernel and copy on the card in the traced window, over the
evaluations that window completed.  Host time between them is not in it,
so the host's speed, which varies from process to process, moves it
little."""


def read(w):
    if w.kind != "eval" or not w.kernels or not w.units:
        return None
    return w.busy_us / w.units * 1e-3
