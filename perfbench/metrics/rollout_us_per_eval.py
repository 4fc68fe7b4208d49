"""Device µs of the rollout kernel (``csrc/rollout.cu``'s
``rollout_kernel``) an evaluation."""

NAME = "rollout_kernel"


def read(w):
    if w.kind != "eval":
        return None
    us = w.device_us(lambda n: NAME in n)
    return us / w.units if us > 0 else None
