"""Evaluations completed a second of the untraced window on the host clock
(``evals_per_s``), where the host's speed sets the rate."""


def read(w):
    if w.kind != "eval" or not w.timed_units:
        return None
    return w.timed_per_s()
