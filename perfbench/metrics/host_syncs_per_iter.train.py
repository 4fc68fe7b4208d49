"""Host calls that wait for the card (stream, device and event
synchronisations, blocking copies) a training iteration, over the traced
training calls."""


def read(w):
    if w.kind != "train" or not w.kernels:
        return None
    return w.syncs() / w.units
