"""Card idle µs an evaluation inside ``ffvd::eval.moments``: the emission
moments, the scores and their copies to the host, split and scaled as
``prep_idle_us_per_eval`` says."""

from perfbench.harness.manifest import BENCH, load_module

stages = load_module(BENCH / "metrics" / "prep_idle_us_per_eval.py")


def read(w):
    return stages.idle_us_per_eval(w, "moments")
