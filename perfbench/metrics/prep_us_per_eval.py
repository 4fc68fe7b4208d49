"""Device µs an evaluation in every kernel but the rollout kernel: the Kmm
factors, the collapsed q(U), the kernel's packed inputs and the emission
moments."""

NAME = "rollout_kernel"


def read(w):
    if w.kind != "eval" or not w.kernels:
        return None
    return w.device_us(lambda n: NAME not in n) / w.units
