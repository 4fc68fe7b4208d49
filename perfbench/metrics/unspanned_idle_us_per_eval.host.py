"""``unspanned_idle_us_per_eval``, in a cell whose end-to-end metric is
the card's busy time an evaluation (``eval_device_ms``)."""

from perfbench.harness.manifest import BENCH, load_module

read = load_module(BENCH / "metrics" / "unspanned_idle_us_per_eval.py").read
