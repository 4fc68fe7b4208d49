"""The whole training step's share of the card's float32 peak, in %: the
FLOPs of every member's collapsed iteration, counted from its shapes at its
own (unpadded) length, times the iterations a second of the untraced
window (host clock), over the peak (``harness.peaks``; TF32 is off)."""

from perfbench.harness.peaks import peak


def c4_flops_per_iter(n: int, d: int, m: int, din: int) -> float:
    """FLOPs of one collapsed (C4) training iteration: N transitions, D
    latent dims, M inducing points, Din GP inputs.  The forward pass, per
    latent dim:

        2·M²·N      A = Lm⁻¹·K(Z, X̃)
        2·M²·N      the H-gram A·Aᵀ
        2·M·N       the a-vector A·Δx
        2·M·N       the trace term Σ A²
        3·Din·M·N   the scaled distances of K(X̃, Z)
        3·Din·M²    the scaled distances of K(Z, Z)
        4·M³/3      Cholesky and triangular inverse of Kmm and of H
        2·M²        L_H⁻¹·a

    and the iteration is 3·D times that: the forward and a backward of
    twice its cost.  Elementwise work (exp, Adam) is left out.  (A copy of
    ``scripts/bench_torch.py::c4_flops_per_iter``.)"""
    f = (4 * m * m * n + 4 * m * n + 3 * din * m * n + 3 * din * m * m
         + 4 * m ** 3 / 3 + 2 * m * m)
    return 3.0 * d * f


def read(w):
    rate = peak(w.device_name, "fp32_flops")
    if w.kind != "train" or not w.timed_units or rate is None:
        return None
    k = w.work
    flops = sum(c4_flops_per_iter(n, k["d"], k["m"], k["din"])
                for n in k["n"])
    return 100.0 * flops * w.timed_per_s() / rate
