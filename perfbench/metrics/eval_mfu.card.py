"""The whole evaluation's share of the card's float32 peak over the card's
busy time, in %: ``eval_mfu``'s FLOPs an evaluation, counted from the
shapes, over the busy µs an evaluation of the traced window
(``eval_device_ms``)."""

from perfbench.harness.manifest import BENCH, load_module
from perfbench.harness.peaks import peak

eval_mfu = load_module(BENCH / "metrics" / "eval_mfu.py")


def read(w):
    rate = peak(w.device_name, "fp32_flops")
    if w.kind != "eval" or not w.kernels or not w.units or rate is None:
        return None
    return 100.0 * eval_mfu.flops(w.work) * w.units / (w.busy_us * 1e-6) \
        / rate
