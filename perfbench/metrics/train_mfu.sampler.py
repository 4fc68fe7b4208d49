"""The whole training step's share of the card's float32 peak under a
sampler case, in %: ``work["grad_evals"]`` gradient evaluations an
iteration (21 SG-HMC sub-steps and one Adam step in C5), each counted as
one collapsed iteration's FLOPs (``train_mfu.c4_flops_per_iter``) at every
member's own length, times the untraced window's iterations a second (host
clock), over the peak (``harness.peaks``; TF32 is off).

A sub-step's backward runs with respect to the two kernel leaves alone,
yet it is counted as a whole one, so the share is an upper bound.  A
system whose ``work`` has no ``grad_evals`` gives no reading."""

from perfbench.harness.manifest import BENCH, load_module
from perfbench.harness.peaks import peak

train_mfu = load_module(BENCH / "metrics" / "train_mfu.py")


def read(w):
    rate = peak(w.device_name, "fp32_flops")
    k = w.work
    if w.kind != "train" or not w.timed_units or rate is None \
            or "grad_evals" not in k:
        return None
    flops = k["grad_evals"] * sum(
        train_mfu.c4_flops_per_iter(n, k["d"], k["m"], k["din"])
        for n in k["n"])
    return 100.0 * flops * w.timed_per_s() / rate
