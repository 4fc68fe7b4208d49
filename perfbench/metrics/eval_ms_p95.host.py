"""The 95th percentile of the untraced window's evaluation times on the
host clock, in ms, where the card idles most of an evaluation and the host
sets its tail."""

import numpy as np


def read(w):
    if w.kind != "eval" or len(w.durations) < 20:
        return None
    return float(np.percentile(np.asarray(w.durations) * 1e3, 95))
