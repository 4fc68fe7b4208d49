"""The whole evaluation's share of the card's float32 peak, in %: the FLOPs
of each member's Kmm factors and collapsed q(U) and of the rollout
launches, counted from the shapes, times the evaluations a second of the
untraced window (host clock), over the peak."""

from perfbench.harness.manifest import BENCH, load_module
from perfbench.harness.peaks import peak

rollout = load_module(BENCH / "metrics" / "rollout_roofline.py")


def prep_flops(n: int, d: int, m: int, din: int) -> float:
    """FLOPs of one member's rollout inputs, per latent dim: K(Z, Z)'s
    scaled distances (3·Din·M²), Cholesky and triangular inverse of Kmm
    (2·M³/3), K(X̃, Z)'s distances (3·Din·M·N), A = Lm⁻¹K (2·M²·N), the
    H-gram (2·M²·N), the a-vector (2·M·N), Cholesky and inverse of H
    (2·M³/3), and H⁻¹a as two triangular products (4·M²); D times that."""
    per_dim = (3 * din * m * m + 4 * m ** 3 / 3 + 3 * din * m * n
               + 4 * m * m * n + 2 * m * n + 4 * m * m)
    return d * per_dim


def flops(k: dict) -> float:
    """FLOPs of one evaluation of the shapes ``k`` (``systems``' ``work``):
    every member's preparation and every rollout launch."""
    out = sum(prep_flops(n, k["d"], k["m"], k["din"]) for n in k["n"])
    out += sum(rollout.work(x["rows"], x["steps"], k["d"], k["m"],
                            k["din"], k["cu"], x["sets"], k["itemsize"])[0]
               for x in k["launches"])
    return out


def read(w):
    rate = peak(w.device_name, "fp32_flops")
    if w.kind != "eval" or not w.timed_units or rate is None:
        return None
    return 100.0 * flops(w.work) * w.timed_per_s() / rate
