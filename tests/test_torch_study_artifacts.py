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
    # the rest of the JAX study layer
    "c6_ballbeam_fp64": [f"ballbeam_C6_ancestor_s{s}_fp64card"
                         for s in range(5)],
    "c2_fp64": [t + "_fp64card" for t in _seeds("ballbeam_C2", 5)],
    "actuator_prec": [f"actuator_{p}_j{j}" for p in ("ds64", "hybrid")
                      for j in range(11)],
    "c6_drive": [f"drive_C6_ancestor_s{s}" for s in range(8)],
    "c6_live": [f"ballbeam_C6_live_s{s}" for s in range(5)],
    "c6_p500": ([f"ballbeam_C6_liveP500_s{s}" for s in range(3)]
                + [f"drive_C6_ancestorP500_s{s}" for s in range(5)]
                + [f"ballbeam_C6_ancestorP500_s{s}" for s in range(3)]),
    "c6_matrix": [f"{ds}_C6_{k}_s{s}" for ds, k in (
        ("gas_furnace", "ancestor"), ("dryer", "ancestor"),
        ("flutter", "ancestor"), ("actuator", "ancestor"),
        ("flutter", "deep2")) for s in range(3)],
    # the 24 C4 entries and the three sampler ones
    "ensemble": [f"ensemble/{ds}{x}" for ds in SIX for x in (
        "", "_1chain_n40spread", "_jit4", "_deep2_ens4")] + [
        "ensemble/flutter_C5", "ensemble/ballbeam_C2_ens4",
        "ensemble/flutter_C6_ens4"],
    "nll_slip": [f"{ds}_slip_seed{s}" for ds in ("drive", "flutter")
                 for s in (1, 2, 3)] + [f"{ds}_slip_fp64cpu_s1"
                                        for ds in ("drive", "flutter")],
    "coldstart": [f"kink_cold_{a}_s{s}" for s in range(5)
                  for a in ("native", "ds64", "hybrid")],
    "stall": ["flutter_long12k_s1", "flutter_long12k_s1_ds64"] + [
        f"{ds}_{n}_s1" for ds in ("drive", "flutter")
        for n in ("polish", "polish2")],
    "escape": [f"flutter_C5_s{s}_hybrid" for s in range(4)] + [
        f"flutter_C5_sp10_s{s}" for s in range(3)],
    "c2_precision": [f"ballbeam_C2_{n}_s{s}" for s in range(20, 25)
                     for n in ("native", "dsprecal")],
    # flutter in fp64 (ROADMAP Queue 3, F2) and BASELINE configs 4 and 2
    "flutter_fp64": [f"flutter_C5_s{s}_fp64card" for s in range(5)] + [
        "flutter_long12k_s1_fp64cpu"],
    "config4": [f"{ds}_xd{xd}" for ds in ("drive", "flutter")
                for xd in (2, 4, 6)],
    "config2": [f"{ds}_C4_linear" for ds in ("gas_furnace", "dryer")],
}
CHAINS = ("c6_drive", "c6_live", "c6_p500", "c6_matrix")


def _protocol(arm, tag):
    """(iterations, mode, dtype) a run of ``arm`` must record."""
    iterations = 4000
    if arm == "drive12k" or "long12k" in tag:
        iterations = 12000
    elif "polish" in tag:
        iterations = 8000
    mode = ("chains" if arm in CHAINS
            else "ensemble" if arm == "ensemble" else "trainer")
    fp64 = tag.endswith(("_fp64cpu", "_fp64card", "_fp64cpu_s1"))
    return iterations, mode, "fp64" if fp64 else "fp32"


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
    """Every run of the arm, at the protocol's length (4000 iterations;
    12,000 for the long arms; 8000 for the polish schedules), fp32 (fp64
    for the fp64 controls), one trainer a run, or a chains group's member
    or an ensemble where the arm says so, on the card."""
    for tag in TAGS[arm]:
        rec = runs[tag]
        iterations, mode, dtype = _protocol(arm, tag)
        assert rec["arm"] == arm and rec["mode"] == mode, tag
        assert rec["device"] == "cuda"
        assert rec["iterations"] == iterations, tag
        assert rec["dtype"] == dtype, tag
        if arm == "coldstart":
            assert math.isfinite(rec["nll_final_ds64_bound"])
        else:
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


@_missed("S2", "the card's 9 C2 seeds reach 0.0133 at best, its 5 fp64 "
         "seeds 0.0113: not fp32 rounding; JAX's own fp64 C6 on the CPU "
         "lands with the port's (S4), not at its TPU record")
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
         "fp64's dynamics rather than double-single's, median 0.930 "
         "(F2: the card's fp64 budgets 1.62-5.91 sit with ds64's)")
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


@_missed("S4", "the card's C6 median 0.0135 and max 0.0370, in fp64 "
         "0.0170 and 0.0286: not fp32 rounding; the JAX package's own fp64 "
         "on the CPU: median 0.0154, max 0.0421 (jax_c6_fp64cpu.json)")
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


# ---- the rest of the JAX study layer ---------------------------------------

def _median(runs, tags, field="rmse"):
    return statistics.median(runs[t][field] for t in tags)


def _anc_median(runs):
    return _median(runs, TAGS["c6_ballbeam"])


def test_p9_c6_live_measurably_worse(runs):
    """P9 (``test_study_artifacts.py:347-356``): the 5-seed live-CSMC
    ballbeam median above 10 × the ancestor-trace median."""
    live = _median(runs, TAGS["c6_live"])
    assert live > 10 * _anc_median(runs), (live, _anc_median(runs))


def test_p10_c6_live_p500_does_not_rescue(runs):
    """P10 (``test_study_artifacts.py:359-368``): the middle of the 3 live
    P=500 runs above 20 × the ancestor-trace median."""
    p500 = sorted(runs[f"ballbeam_C6_liveP500_s{s}"]["rmse"]
                  for s in range(3))
    assert p500[1] > 20 * _anc_median(runs), (p500, _anc_median(runs))


def test_p11_c6_full_dataset_matrix(runs):
    """P11 (``test_study_artifacts.py:371-385``): flutter's middle C6 seed
    under 0.947 (JAX's C4 anchor), dryer's lowest above 0.15, every
    gas_furnace and actuator seed under 1.0."""
    fl = sorted(runs[f"flutter_C6_ancestor_s{s}"]["rmse"] for s in range(3))
    assert fl[1] < 0.947, fl
    dr = sorted(runs[f"dryer_C6_ancestor_s{s}"]["rmse"] for s in range(3))
    assert dr[0] > 0.15, dr
    for ds in ("gas_furnace", "actuator"):
        for s in range(3):
            assert runs[f"{ds}_C6_ancestor_s{s}"]["rmse"] < 1.0, (ds, s)


@_missed("S6", "drive P=500 seeds 0.4596-1.1544, two above 0.65; "
         "ballbeam P=500 0.0025-0.0287, one above 0.015")
def test_p12_c6_ancestor_p500(runs):
    """P12 (``test_study_artifacts.py:388-407``, its accuracy clauses):
    every drive P=500 seed under 0.65 and every ballbeam P=500 seed under
    0.015.  The train-time clause (t500 < 1.5 × t100) was a TPU
    throughput claim: the card's ratio is recorded in PERF.md."""
    drive = [runs[f"drive_C6_ancestorP500_s{s}"]["rmse"] for s in range(5)]
    assert max(drive) < 0.65, drive
    bb = [runs[f"ballbeam_C6_ancestorP500_s{s}"]["rmse"] for s in range(3)]
    assert max(bb) < 0.015, bb


def test_p13_c6_drive_mixing_healthy(runs):
    """P13 (``test_study_artifacts.py:410-420``, drive): ref_survival in
    (0.5, 0.95), unique_frac above 0.3, every sampled sweep accepted, on
    seeds 0-4."""
    for s in range(5):
        m = runs[f"drive_C6_ancestor_s{s}"]["mixing_mean"]
        assert 0.5 < m["ref_survival"] < 0.95, (s, m)
        assert m["unique_frac"] > 0.3, (s, m)
        assert m["accepted"] == 1.0, (s, m)


@_missed("S5", "no drive C6 seed of the 8 above 1.5, and seed 5 at 0.883 "
         "above 0.75")
def test_p14_c6_drive_outlier(runs):
    """P14 (``test_study_artifacts.py:494-507``): JAX's seed-3 outlier is
    its own stream's.  Where a card seed of the 8 exceeds 1.5, its redraw
    (10 evaluations and one at num=40) keeps every draw above 1.4 (a
    chain-level outlier, not a draw) and at most 1 of the 8 exceeds 1.5;
    where none does, every seed is under 0.75."""
    rmse = {s: runs[f"drive_C6_ancestor_s{s}"]["rmse"] for s in range(8)}
    out = [s for s, r in rmse.items() if r > 1.5]
    if not out:
        assert max(rmse.values()) < 0.75, rmse
        return
    assert len(out) <= 1, rmse
    rd = runs[f"drive_C6_ancestor_s{out[0]}_redraw"]
    assert abs(rd["rmse_draws_num10"][0] - rd["recorded_outlier"]) < 1e-3
    assert len(rd["rmse_draws_num10"]) == 10
    assert min(rd["rmse_draws_num10"]) > 1.4, rd
    assert rd["rmse_num40"] > 1.4, rd


def _ens(runs, name):
    return runs[f"ensemble/{name}"]


def test_p15_ensemble_nll_calibrated_everywhere(runs):
    """P15 (``test_study_artifacts.py:85-94``): every ensemble entry run
    (the 24 C4 ones of the 27) has its pooled 30-step NLL under 20, and
    the spread term is what calibrates it: no-spread NLL above
    2·NLL + 5."""
    for tag in TAGS["ensemble"]:
        rec = runs[tag]
        assert rec["nll"] < 20, (tag, rec["nll"])
        assert rec["nll_no_spread"] > 2 * rec["nll"] + 5, (
            tag, rec["nll"], rec["nll_no_spread"])


@_missed("S1", "actuator's 4-seed pool is the card's fp32 actuator C4 "
         "point, 1.0938 against TF's median 0.3533")
def test_p16_ensemble_rmse_vs_reference(runs, tf):
    """P16 (``test_study_artifacts.py:97-117``): the pooled 4-chain C4
    RMSE under the TF reference's median run on ballbeam, drive, dryer and
    actuator, and inside its range on flutter."""
    def pop(ds):
        return [v["rmse"] for k, v in tf.items()
                if k.startswith(ds + "_C4") and "rmse" in v]

    for ds in ("ballbeam", "drive", "dryer", "actuator"):
        assert _ens(runs, ds)["rmse"] < statistics.median(pop(ds)), ds
    fl = pop("flutter")
    assert min(fl) <= _ens(runs, "flutter")["rmse"] <= max(fl)


@_missed("S1", "actuator's 40-rollout draws 1.0938, 1.3355, 0.3896 "
         "against 0.3533: the card's fp32 actuator C4 point")
def test_p17_ensemble_actuator_averaging_gain(runs):
    """P17 (``test_study_artifacts.py:120-131``): actuator's three
    40-rollout draws (4-seed pool, one chain with spread, jittered pool)
    under the reference's 0.3533, their median under the per-chain
    median."""
    med10 = statistics.median(
        c["rmse"] for c in _ens(runs, "actuator")["per_chain"])
    draws = [_ens(runs, t)["rmse"] for t in (
        "actuator", "actuator_1chain_n40spread", "actuator_jit4")]
    assert all(d < 0.3533 for d in draws), draws
    assert statistics.median(draws) < med10, (draws, med10)


@_missed("S7", "drive's deep-2 pool 0.5502 above its best member 0.4982")
def test_p18_deep_ensemble_composition(runs):
    """P18 (``test_study_artifacts.py:134-149``): flutter's deep-2
    ensemble under 0.55 and under the shallow pool with negative pooled
    NLL; drive's deep-2 pool under its best member; actuator's deep-2
    pool above 2 × the jittered shallow pool."""
    fl = _ens(runs, "flutter_deep2_ens4")
    assert fl["rmse"] < 0.55 and fl["rmse"] < _ens(runs, "flutter")["rmse"]
    assert fl["nll"] < 0.0
    dr = _ens(runs, "drive_deep2_ens4")
    assert dr["rmse"] < min(c["rmse"] for c in dr["per_chain"])
    assert (_ens(runs, "actuator_deep2_ens4")["rmse"]
            > 2 * _ens(runs, "actuator_jit4")["rmse"])


def test_p19_one_chain_spread_matches_seed_pooling(runs):
    """P19 (``test_study_artifacts.py:152-167``): one chain evaluated with
    40 rollouts and the spread term: NLL under 13, no-spread NLL above
    2·NLL + 5, RMSE within 3× of the 4-seed pool's."""
    for ds in SIX:
        one = _ens(runs, f"{ds}_1chain_n40spread")
        assert one["nll"] < 13, (ds, one["nll"])
        assert one["nll_no_spread"] > 2 * one["nll"] + 5, ds
        ratio = one["rmse"] / _ens(runs, ds)["rmse"]
        assert 1 / 3 < ratio < 3, (ds, ratio)


def test_p20_actuator_ds64_removes_s1(runs):
    """P20 (ROADMAP Queue 3, S1): actuator C4 under the float64 segment,
    from the S1 check's 11 starts: the median RMSE at most P1's actuator
    bound, 0.483."""
    ds64 = [runs[f"actuator_ds64_j{j}"]["rmse"] for j in range(11)]
    assert statistics.median(ds64) <= P1_BOUNDS["actuator"], ds64


@pytest.mark.parametrize("ds", ("drive", "flutter"))
def test_p21_fp64_slip_matches_reference(runs, tf, ds):
    """P21 (``test_study_artifacts.py:44-76``): the fp64 slip run's NLL
    inside the TF reference's seed population; its first predictive
    variance v̂[0] within 0.5-2× of the reference's saved run, while the
    fp32 run's is above 5× it; its learned Q within 10% of the
    reference's on every dim."""
    import numpy as np
    rec = runs[f"{ds}_slip_fp64cpu_s1"]
    ref_nlls = [v["nll_metric"] for k, v in tf.items()
                if k.startswith(f"{ds}_C4") and "nll_metric" in v]
    assert len(ref_nlls) >= 5
    assert min(ref_nlls) <= rec["nll"] <= max(ref_nlls), (rec["nll"],
                                                          ref_nlls)
    ref = np.load(GOLDEN / f"tf_ref_{ds}_results.npz")
    v0_ref = float(np.ravel(ref["v_test_vfe_var"])[0])
    assert 0.5 < rec["v_first"] / v0_ref < 2.0, (rec["v_first"], v0_ref)
    assert runs[f"{ds}_slip_seed1"]["v_first"] / v0_ref > 5.0
    q_ref = np.exp(np.ravel(ref["log_QQ"]))
    assert np.all(np.abs(np.asarray(rec["Q"]) / q_ref - 1.0) < 0.10), (
        rec["Q"], q_ref)


@_missed("S8", "on the kink cold start the port's three arms learn Q "
         "within 1.5% of each other, seed by seed: hybrid's band overlaps "
         "native's")
def test_p22_hybrid_serves_cold_starts(runs):
    """P22 (``test_study_artifacts.py:470-491``): on the kink cold start
    hybrid's learned Q band lies below native's, disjoint, and within
    1.25 × ds64's largest; under the ds64 bound the medians order
    ds64 < hybrid < native."""
    def arm(name, field):
        return [runs[f"kink_cold_{name}_s{s}"][field] for s in range(5)]

    q_nat, q_ds, q_hyb = ([q[0] for q in arm(a, "Q")]
                          for a in ("native", "ds64", "hybrid"))
    assert max(q_hyb) < min(q_nat), (q_hyb, q_nat)
    assert max(q_hyb) < 1.25 * max(q_ds), (q_hyb, q_ds)
    n_nat, n_ds, n_hyb = (statistics.median(arm(a, "nll_final_ds64_bound"))
                          for a in ("native", "ds64", "hybrid"))
    assert n_ds < n_hyb < n_nat, (n_ds, n_hyb, n_nat)


@_missed("S9", "flutter C4 12k under the port's IEEE float64 segment: "
         "RMSE 0.4498 against fp32's 8.8259, but the budget 39.26 against "
         "fp32's 0.2311 (F2: the JAX package's own fp64 reaches 37.04)")
def test_p23_ds64_flutter_beats_fp32(runs):
    """P23 (``test_study_artifacts.py:188-194``): flutter C4 over 12,000
    iterations, the ds64 RMSE under 0.5 × fp32's and its budget Σσ²C²
    under 0.25 × fp32's."""
    ds64 = runs["flutter_long12k_s1_ds64"]
    fp32 = runs["flutter_long12k_s1"]
    assert ds64["rmse"] < 0.5 * fp32["rmse"], (ds64["rmse"], fp32["rmse"])
    assert ds64["budget_s2C2"] < 0.25 * fp32["budget_s2C2"]


@_missed("S10", "the card's 4 hybrid flutter C5 seeds 0.4794, 0.7039, "
         "0.4992, 1.1984 (median 0.6016): its native fp32 flutter C5 "
         "(median 0.518) has no TPU-level residual for the tail to leave")
def test_p24_hybrid_tail_does_not_close_flutter_c5(runs):
    """P24 (``test_study_artifacts.py:313-324``): a 500-iteration ds64
    tail after native fp32 burn-in leaves flutter C5 at the native level:
    the median of the 4 hybrid seeds above 1.0."""
    hyb = [runs[f"flutter_C5_s{s}_hybrid"]["rmse"] for s in range(4)]
    assert statistics.median(hyb) > 1.0, hyb


@_missed("S11", "the card's dsprecal C2 seeds 0.0037-0.0181 (range "
         "0.0144) against native's 0.0091-0.1142 (range 0.1051): on the "
         "card the float64 Kmm factorisation narrows the 5-seed spread")
def test_p25_c2_noise_not_factorization_error(runs):
    """P25 (``test_study_artifacts.py:442-453``): the Kmm factorisation in
    float64 in every C2 gradient evaluation does not tighten the seed
    spread: dsprecal's range above half of native's, its median above
    half of native's.  The time clause (``:454-461``, dsprecal at least 3×
    native's train time) measured double-single on the TPU; the card's
    ratio is recorded in PERF.md."""
    nat = [runs[f"ballbeam_C2_native_s{s}"]["rmse"] for s in range(20, 25)]
    dsp = [runs[f"ballbeam_C2_dsprecal_s{s}"]["rmse"]
           for s in range(20, 25)]
    assert max(dsp) - min(dsp) > 0.5 * (max(nat) - min(nat)), (dsp, nat)
    assert statistics.median(dsp) > 0.5 * statistics.median(nat), (dsp, nat)


@pytest.mark.parametrize("tag", TAGS["config4"] + TAGS["config2"])
def test_baseline_configs_train(runs, tag):
    """BASELINE.md configs 4 (drive and flutter at x_dim 2, 4, 6, 20
    rollouts 50 apart) and 2 (LinearK on gas_furnace and dryer): the run
    is there at the protocol's length, its RMSE and NLL finite, and its
    training nll falls.  The JAX package fixed no bound for them."""
    rec = runs[tag]
    assert rec["iterations"] == 4000
    assert math.isfinite(rec["rmse"]) and math.isfinite(rec["nll"])
    assert rec["nll_last"] < rec["nll_first"], rec
    want = ({"kernel_type": "LinearK"} if tag.endswith("_linear") else
            {"x_dim": int(tag[-1]), "num_posterior_samples": 20,
             "posterior_sample_spacing": 50})
    assert rec["cfg"] == want


@pytest.mark.parametrize("tag", TAGS["flutter_fp64"])
def test_flutter_fp64_reference_present(runs, tag):
    """ROADMAP Queue 3, F2: flutter's float64 runs on the card, the
    reference the ds64 runs are read against: in fp64, at the protocol's
    length, native collapse, finite RMSE, NLL and budget."""
    rec = runs[tag]
    assert rec["dtype"] == "fp64" and rec["device"] == "cuda"
    assert rec["collapse_precision"] == "native"
    assert rec["iterations"] == (12000 if "long12k" in tag else 4000)
    for k in ("rmse", "nll", "budget_s2C2"):
        assert math.isfinite(rec[k]), (k, rec[k])


def test_jax_c6_fp64_population_recorded():
    """ROADMAP Queue 3, S4/S2: ``tests/golden_torch/jax_c6_fp64cpu.py``'s
    record of the JAX package's own ballbeam C6 in float64 on the CPU:
    at least one seed, each recorded seed at the full 4000 iterations with
    a finite RMSE and NLL and its mixing side sweeps."""
    doc = json.loads((ROOT / "tests" / "golden_torch"
                      / "jax_c6_fp64cpu.json").read_text())
    runs_ = doc["runs"]
    assert runs_
    for tag, rec in runs_.items():
        assert re.fullmatch(r"ballbeam_C6_ancestor_s[0-4]_jaxfp64cpu", tag)
        assert rec["iterations"] == 4000 and rec["dtype"] == "fp64"
        assert math.isfinite(rec["rmse"]) and math.isfinite(rec["nll"])
        assert len(rec["mixing_seq"]) == 10
