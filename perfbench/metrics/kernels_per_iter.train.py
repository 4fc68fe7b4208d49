"""Card kernels a training iteration: every kernel of the traced training
calls over their iterations.  A captured step launches its kernels from one
graph; fewer, fused kernels lower this count."""


def read(w):
    if w.kind != "train" or not w.kernels:
        return None
    return len(w.kernels) / w.units
