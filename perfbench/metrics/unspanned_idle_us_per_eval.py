"""Card idle µs an evaluation inside no stage span of the port: the
caller's Python between evaluations, and port code that no stage covers,
split and scaled as ``prep_idle_us_per_eval`` says."""

from perfbench.harness.manifest import BENCH, load_module

stages = load_module(BENCH / "metrics" / "prep_idle_us_per_eval.py")


def read(w):
    return stages.idle_us_per_eval(w, "unspanned")
