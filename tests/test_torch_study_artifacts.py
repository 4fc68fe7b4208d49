"""Pins of the port's full-protocol study on the card, the counterparts of
``tests/test_study_artifacts.py``.

``tests/golden_torch/study_h100.json`` holds the runs of
``scripts/study_torch.py`` on one NVIDIA H100: every case at the protocol
users run (fp32, 4000 outer iterations or drive C4's 12,000, 10 rollouts,
RMSE/NLL over 30 steps).  The port's generators are not JAX's streams, so
each pin holds a population of the port's runs against the population of
the JAX package's or the TF reference's recorded runs (``tests/golden/
*.json``), never one seed against the same seed.  The bounds were fixed
before the study ran; each pin's docstring names the JAX pin or PARITY
claim it mirrors.  Pure JSON reads: nothing is executed.
"""

import json
import math
import re
import statistics
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
STUDY = ROOT / "tests" / "golden_torch" / "study_h100.json"
SIX = ("ballbeam", "drive", "gas_furnace", "dryer", "actuator", "flutter")
# P1's bounds as the artifacts give them, rounded (1.25 × the larger of
# the TF reference's and the JAX package's fp32 RMSE).
P1_BOUNDS = {"ballbeam": 0.0352, "drive": 1.181, "gas_furnace": 0.655,
             "dryer": 0.125, "actuator": 0.483, "flutter": 1.952}
P7_BOUNDS = {"flutter": 0.655, "drive": 0.785}


def _missed(entry, what):
    """A pin the card's population misses, with no fault of the port
    located (``tests/test_torch_study_checks.py`` against JAX on the CPU,
    ``scripts/study_checks_torch.py`` the card against the host); ROADMAP
    Queue 3 records the population under ``entry``."""
    return pytest.mark.xfail(strict=True, reason=(
        f"ROADMAP Queue 3, {entry}: {what}; no fault of the port located "
        "(tests/test_torch_study_checks.py, scripts/study_checks_torch.py)"))


def _load(name):
    return json.loads((GOLDEN / name).read_text())


def _seeds(prefix, n):
    """JAX's tag series: ``prefix`` for seed 0, then ``prefix_seed<s>``."""
    return [prefix] + [f"{prefix}_seed{s}" for s in range(1, n)]


TAGS = {
    "c4_six": list(SIX),
    "c2": _seeds("ballbeam_C2", 9),
    "c3": _seeds("ballbeam_C3", 6),
    "c5_ballbeam": [f"ballbeam_C5_s{s}" for s in range(5)],
    "c5_flutter": [f"flutter_C5_s{s}{x}" for x in ("", "_ds64")
                   for s in range(5)],
    "c6_ballbeam": [f"ballbeam_C6_ancestor_s{s}" for s in range(5)],
    "deep2": _seeds("flutter_C4_deep2", 3) + _seeds("drive_C4_deep2", 3),
    "drive12k": [f"drive_long12k_s{s}{x}" for s in range(1, 6)
                 for x in ("", "_ds64", "_fp64cpu")],
}


@pytest.fixture(scope="module")
def doc():
    return json.loads(STUDY.read_text())


@pytest.fixture(scope="module")
def runs(doc):
    return doc["runs"]


@pytest.fixture(scope="module")
def tf():
    return _load("tf_reference_e2e.json")


@pytest.fixture(scope="module")
def ours():
    return _load("ours_e2e_tpu_fp32.json")


def _rmse(runs, tags):
    return [runs[t]["rmse"] for t in tags]


def test_header_names_an_h100_and_its_power_limit(doc):
    h = doc["header"]
    assert not h["quick"] and h["device"] == "cuda"
    assert re.fullmatch(r"NVIDIA H100[^,]*, \d+(\.\d+)? W", h["card"]), h
    assert all(c["card"] == h["card"] for c in doc["calls"])


@pytest.mark.parametrize("arm", sorted(TAGS))
def test_every_run_present_at_full_length(runs, arm):
    """Every run of the arm, at the protocol's length, fp32 (fp64 for the
    12k control), one trainer a run, on the card."""
    for tag in TAGS[arm]:
        rec = runs[tag]
        assert rec["arm"] == arm and rec["mode"] == "trainer"
        assert rec["device"] == "cuda"
        assert rec["iterations"] == (12000 if arm == "drive12k" else 4000)
        assert rec["dtype"] == ("fp64" if tag.endswith("_fp64cpu")
                                else "fp32")
        assert math.isfinite(rec["rmse"]) and math.isfinite(rec["nll"])


@pytest.mark.parametrize("ds", [
    pytest.param(ds, marks=_missed(
        "S1", "actuator C4's fp32 training on the card lands worse than "
        "the host's: 4 of 11 starts roll out above RMSE 0.6, none of the "
        "host's fp32 or the card's fp64")) if ds == "actuator" else ds
    for ds in SIX])
def test_p1_c4_six_datasets(runs, tf, ours, ds):
    """P1 (PARITY §2): C4 at the protocol on each dataset, RMSE at most
    1.25 × the larger of the TF reference's and the JAX package's fp32
    RMSE, finite NLL; ballbeam also at most the TF reference's 0.0282."""
    bound = 1.25 * max(tf[f"{ds}_C4"]["rmse"], ours[ds]["rmse"])
    assert bound == pytest.approx(P1_BOUNDS[ds], rel=2e-3)
    rec = runs[ds]
    assert math.isfinite(rec["nll"])
    assert rec["rmse"] <= bound, (ds, rec["rmse"], bound)
    if ds == "ballbeam":
        assert rec["rmse"] <= tf["ballbeam_C4"]["rmse"]


@_missed("S2", "the card's 9 C2 seeds reach 0.0133 at best")
def test_p2_c2_best_seed_matches_reference(runs, tf):
    """P2 (``test_study_artifacts.py:423-441``): the best of 9 C2 seeds
    under 1.5 × the best TF C2 run (0.00606)."""
    ref = [v["rmse"] for k, v in tf.items() if k.startswith("ballbeam_C2")]
    bound = 1.5 * min(ref)
    assert bound == pytest.approx(0.00606, rel=2e-3)
    assert min(_rmse(runs, TAGS["c2"])) < bound


def test_p2_c2_median_within_jax_population(runs, ours):
    """P2: the 9-seed C2 median at most 1.25 × the JAX package's worst
    seed (0.0826)."""
    bound = 1.25 * max(_rmse(ours, TAGS["c2"]))
    assert bound == pytest.approx(0.0826, rel=2e-3)
    assert statistics.median(_rmse(runs, TAGS["c2"])) <= bound


def test_p3_c3_median_beats_reference(runs):
    """P3 (``test_study_artifacts.py:423-441``): the 6-seed C3 median under
    the TF reference's only C3 run / 5."""
    assert statistics.median(_rmse(runs, TAGS["c3"])) < 0.1897 / 5


def test_p4_c5_ballbeam_median(runs):
    """P4 (``escape_validation.json``): the 5-seed C5 median at most 1.25 ×
    the JAX package's worst seed (0.0263)."""
    esc = _load("escape_validation.json")
    bound = 1.25 * max(esc[t]["rmse"] for t in TAGS["c5_ballbeam"])
    assert bound == pytest.approx(0.0263, rel=2e-3)
    assert statistics.median(_rmse(runs, TAGS["c5_ballbeam"])) <= bound


def test_p4_c5_ballbeam_no_clip_saturation(runs):
    """P4: no sampled log hyper sits on the SG-HMC clip."""
    assert not [t for t in TAGS["c5_ballbeam"]
                if runs[t]["clip_saturated"]]


def _flutter_c5(runs):
    native = _rmse(runs, TAGS["c5_flutter"][:5])
    ds64 = _rmse(runs, TAGS["c5_flutter"][5:])
    return native, ds64


@_missed("S3", "flutter C5 under the port's IEEE float64 segment, "
         "fp64's dynamics rather than double-single's, median 0.930")
def test_p5_c5_flutter_ds64_in_fp64_bracket(runs):
    """P5 (``test_study_artifacts.py:224-247``): under ds64 the flutter C5
    median at most 0.80 (the fp64 anchors 0.672 / 0.768) and every seed
    under 1.0."""
    _, ds64 = _flutter_c5(runs)
    assert statistics.median(ds64) <= 0.80, ds64
    assert max(ds64) < 1.0, ds64


@_missed("S3", "the card's native fp32 flutter C5 (median 0.518) beats "
         "its ds64 (0.930)")
def test_p5_c5_flutter_ds64_beats_native(runs):
    """P5: median(ds64) < 0.75 × median(native)."""
    native, ds64 = _flutter_c5(runs)
    assert statistics.median(ds64) < 0.75 * statistics.median(native), (
        native, ds64)


def test_p5_c5_flutter_no_clip_saturation(runs):
    """P5: no run, native or ds64, saturated."""
    assert not [t for t in TAGS["c5_flutter"] if runs[t]["clip_saturated"]]


@_missed("S4", "the card's C6 median 0.0135 and max 0.0370")
def test_p6_c6_in_reference_regime(runs, tf):
    """P6 (``test_study_artifacts.py:331-345``): the 5-seed ancestor-trace
    C6 median within [min, max + 0.005] of the TF reference's C6 runs, and
    every seed under 0.015."""
    ref = [v["rmse"] for k, v in tf.items() if k.startswith("ballbeam_C6")]
    assert len(ref) >= 3
    ours = _rmse(runs, TAGS["c6_ballbeam"])
    med = statistics.median(ours)
    assert min(ref) <= med <= max(ref) + 0.005, (med, ref)
    assert max(ours) < 0.015, ours


def test_p6_c6_mixing_healthy(runs):
    """P6 (``test_study_artifacts.py:410-421``): the reference particle
    survives resampling but does not dominate, the pool keeps a third of
    its members distinct, every sampled sweep accepts."""
    for t in TAGS["c6_ballbeam"]:
        m = runs[t]["mixing_mean"]
        assert 0.5 < m["ref_survival"] < 0.95, (t, m)
        assert m["unique_frac"] > 0.3, (t, m)
        assert m["accepted"] == 1.0, (t, m)


@pytest.mark.parametrize("ds", ("flutter", "drive"))
def test_p7_deep2_median(runs, ours, ds):
    """P7 (PARITY §2b-deep): the 3-seed deep-2 median at most 1.25 × the
    JAX package's worst seed."""
    tags = _seeds(f"{ds}_C4_deep2", 3)
    bound = 1.25 * max(_rmse(ours, tags))
    assert bound == pytest.approx(P7_BOUNDS[ds], rel=2e-3)
    assert statistics.median(_rmse(runs, tags)) <= bound


def _arm12k(runs, suffix, field):
    return [runs[f"drive_long12k_s{s}{suffix}"][field] for s in range(1, 6)]


def test_p8_ds64_budget_in_fp64_bracket(runs):
    """P8 (``test_study_artifacts.py:168-186``, on medians): the ds64
    median budget Σσ²C² inside (mixed − 0.05, fp64 + 0.15) = (1.161,
    1.643) and under 0.55 × native fp32's median."""
    stall = _load("fp32_stall_study.json")
    lo = stall["drive_long12k_s1_mixed"]["budget_s2C2"] - 0.05
    hi = stall["drive_long12k_s1_fp64cpu"]["budget_s2C2"] + 0.15
    assert (lo, hi) == pytest.approx((1.161, 1.643), rel=1e-3)
    ds64 = statistics.median(_arm12k(runs, "_ds64", "budget_s2C2"))
    native = statistics.median(_arm12k(runs, "", "budget_s2C2"))
    assert lo < ds64 < hi, ds64
    assert ds64 < 0.55 * native, (ds64, native)


def test_p8_ds64_learned_q_small(runs):
    """P8: max Q under 5e-6 on every ds64 start (fp32 drifts to 2.7e-5)."""
    assert max(_arm12k(runs, "_ds64", "max_Q")) < 5e-6


@_missed("ds64's 12k calibration", "the port's ds64 lands at fp64's "
         "calibration, not at JAX's double-single's")
def test_p8a_ds64_nll_half_of_native(runs):
    """P8 (a), JAX's relation: median(ds64 NLL) < 0.5 × median(native fp32
    NLL)."""
    ds64 = statistics.median(_arm12k(runs, "_ds64", "nll"))
    native = statistics.median(_arm12k(runs, "", "nll"))
    assert ds64 < 0.5 * native, (ds64, native)


def test_p8b_ds64_nll_at_fp64_calibration(runs):
    """P8 (b), ROADMAP Queue 3's claim for the port: median(ds64 NLL)
    within a factor 3 of the fp64 arm's median."""
    ds64 = statistics.median(_arm12k(runs, "_ds64", "nll"))
    fp64 = statistics.median(_arm12k(runs, "_fp64cpu", "nll"))
    assert 1 / 3 < ds64 / fp64 < 3, (ds64, fp64)
