"""The study runner (``scripts/study_torch.py``) on the CPU at ``--quick``.

C4 training draws no random numbers, so the runner's ballbeam C4 record
(50 iterations, fp64, from the vendored warm start) is held against the JAX
package's ``Trainer`` after the same 50 iterations at rtol 1e-10: the
record's last training nll and its learned Q.  The other tests run one
record of each other arm kind and check what the pins of
``tests/test_torch_study_artifacts.py`` read, that a second call appends
only new tags, and that the runner refuses to mix a quick file with a full
one or to run without a card unless asked for the CPU.
"""

import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.config import FFVDConfig as JConfig
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.inference.trainer import Trainer as JTrainer
from ffvd_tpu.model.params import SSMData as JSSMData
from ffvd_tpu.model.params import init_params_from_warmstart as j_init

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ANCHOR_NLL = -2.410755   # ballbeam C4 warm start (TF golden fixture)
# One record of each arm kind; drive12k gives its three precision arms.
TAGS = ("ballbeam", "ballbeam_C2", "flutter_C5_s0_ds64",
        "ballbeam_C6_ancestor_s0", "drive_C4_deep2", "drive_long12k_s1",
        "drive_long12k_s1_ds64", "drive_long12k_s1_fp64cpu")
ARMS = "c4_six,c2,c5_flutter,c6_ballbeam,deep2,drive12k"
NUMBERS = ("rmse", "nll", "nll_first", "nll_last", "budget_s2C2", "max_Q",
           "train_s", "it_per_s", "eval_ms")
FIELDS = NUMBERS + ("arm", "dataset", "case", "seed", "init_jitter",
                    "collapse_precision", "dtype", "iterations", "n_layers",
                    "mode", "device", "card", "Q")


def _script():
    spec = importlib.util.spec_from_file_location(
        "study_torch", ROOT / "scripts" / "study_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(out, match, arms=ARMS):
    return ["--device", "cpu", "--quick", "--dtype", "fp64", "--arms", arms,
            "--match", match, "--out", str(out)]


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    out = tmp_path_factory.mktemp("study") / "study.json"
    mod = _script()
    summary = mod.main(_argv(out, "^(" + "|".join(TAGS) + ")$"))
    return mod, out, summary, json.loads(out.read_text())


def test_c4_record_matches_jax_trainer(study):
    """The ballbeam C4 record after 50 fp64 iterations: last training nll
    and learned Q equal the JAX ``Trainer``'s at rtol 1e-10."""
    rec = study[3]["runs"]["ballbeam"]
    assert rec["iterations"] == 50 and rec["dtype"] == "fp64"
    np.testing.assert_allclose(rec["nll_first"], ANCHOR_NLL, rtol=1e-6)
    cfg = JConfig(dataset="ballbeam", case=4)
    ds = j_create_dataset("ballbeam")
    tr = JTrainer(cfg, JSSMData(y=jnp.asarray(ds.y_train),
                                control=jnp.asarray(ds.control)))
    state, nlls = tr.run(tr.init_state(j_init(j_load_warmstart("ballbeam"))),
                         50, jax.random.key(0), chunk_size=50)
    np.testing.assert_allclose(rec["nll_last"], float(nlls[-1]), rtol=1e-10)
    np.testing.assert_allclose(rec["Q"],
                               np.exp(np.asarray(state.params.log_q)),
                               rtol=1e-10)
    np.testing.assert_allclose(rec["max_Q"], max(rec["Q"]), rtol=0)


@pytest.mark.parametrize("tag", TAGS)
def test_record_schema(study, tag):
    """Every record has the fields the pins read, finite, at --quick's
    iterations; sampled-hyper cases record clip saturation, C6 its mixing
    diagnostics."""
    mod, _, summary, doc = study
    assert sorted(summary["ran"]) == sorted(TAGS)
    rec = doc["runs"][tag]
    assert not [k for k in FIELDS if k not in rec]
    assert all(math.isfinite(rec[k]) for k in NUMBERS)
    assert len(rec["Q"]) == 4 and max(rec["Q"]) == rec["max_Q"]
    assert rec["mode"] == "trainer" and rec["device"] == "cpu"
    kind = {"C2": "sampler", "C5": "sampler", "C6": "c6"}.get(rec["case"],
                                                              "c4")
    if "long12k" in tag:
        kind = "12k"
        assert rec["dtype"] == "fp64" and rec["init_jitter"] == 0.0
        assert rec["collapse_precision"] == (
            "ds64" if tag.endswith("_ds64") else "native")
    assert rec["iterations"] == mod.QUICK[kind]
    assert ("clip_saturated" in rec) == (kind == "sampler")
    if kind == "sampler":
        assert isinstance(rec["clip_saturated"], bool)
    if kind == "c6":
        m = rec["mixing_mean"]
        assert len(rec["mixing_seq"]) == 1
        assert 0.0 <= m["ref_survival"] <= 1.0
        assert 0.0 < m["unique_frac"] <= 1.0
        assert m["accepted"] in (0.0, 1.0)
    if tag == "drive_C4_deep2":
        assert rec["n_layers"] == 2


def test_header_names_the_device(study):
    doc = study[3]
    h = doc["header"]
    assert h["card"] == "cpu" and h["device"] == "cpu" and h["quick"]
    assert h["torch"] == torch.__version__ and h["date"]
    assert [c["ran"] for c in doc["calls"]] == [study[2]["ran"]]


def test_resume_appends_only_new_tags(study, tmp_path):
    """A second call skips every tag present; a call that adds a tag
    leaves the earlier records as they were."""
    mod, out, _, doc = study
    path = tmp_path / "study.json"
    path.write_text(out.read_text())
    again = mod.main(_argv(path, "^(" + "|".join(TAGS) + ")$"))
    assert again["ran"] == [] and sorted(again["skipped"]) == sorted(TAGS)
    assert json.loads(path.read_text()) == doc
    more = mod.main(_argv(path, "^(ballbeam|dryer)$", arms="c4_six"))
    assert more["ran"] == ["dryer"] and more["skipped"] == ["ballbeam"]
    new = json.loads(path.read_text())
    assert {k: v for k, v in new["runs"].items() if k != "dryer"} \
        == doc["runs"]
    assert new["calls"][-1]["ran"] == ["dryer"]
    assert len(new["calls"]) == len(doc["calls"]) + 1


def test_quick_and_full_files_never_mix(study, tmp_path):
    mod, out, _, _ = study
    path = tmp_path / "study.json"
    path.write_text(out.read_text())
    argv = _argv(path, "^dryer$", arms="c4_six")
    argv.remove("--quick")
    with pytest.raises(ValueError, match="quick"):
        mod.main(argv)


def test_arms_cover_the_jax_tags():
    """The full study's runs: the counts and tags of the JAX artifacts it
    mirrors, the 12k starts 2-5 jittered."""
    mod = _script()
    runs = {a: [r["tag"] for r in mod.arm_runs(a)] for a in mod.ARMS}
    assert {a: len(t) for a, t in runs.items()} == {
        "c4_six": 6, "c2": 9, "c3": 6, "c5_ballbeam": 5, "c5_flutter": 10,
        "c6_ballbeam": 5, "deep2": 6, "drive12k": 15, "c6_ballbeam_fp64": 5,
        "c2_fp64": 5, "actuator_prec": 22, "c6_drive": 8, "c6_live": 5,
        "c6_p500": 11, "c6_matrix": 15, "ensemble": 27, "nll_slip": 8,
        "coldstart": 15, "stall": 6, "escape": 7, "c2_precision": 10,
        "flutter_fp64": 6, "config4": 6, "config2": 2}
    tags = [t for a in runs.values() for t in a]
    assert len(tags) == len(set(tags))
    # each JAX artifact's tags, the ensemble's under "ensemble/"
    for name, arms in (("pg_c6_study.json", ("c6_ballbeam", "c6_drive",
                                             "c6_live", "c6_p500",
                                             "c6_matrix")),
                       ("ensemble_study.json", ("ensemble",)),
                       ("nll_study.json", ("nll_slip",)),
                       ("hybrid_coldstart_study.json", ("coldstart",)),
                       ("c2_precision_study.json", ("c2_precision",))):
        jax_tags = set(json.loads((ROOT / "tests" / "golden" / name)
                                  .read_text()))
        ours = {t.replace("ensemble/", "") for a in arms for t in runs[a]}
        assert ours == jax_tags - {"drive_C6_ancestor_s3_redraw"}, name
    stall = set(json.loads((ROOT / "tests" / "golden" /
                            "fp32_stall_study.json").read_text()))
    assert set(runs["stall"]) <= stall
    escape = set(json.loads((ROOT / "tests" / "golden" /
                             "escape_validation.json").read_text()))
    assert set(runs["escape"]) <= escape
    # BASELINE config 4 under the keys of JAX's x_dim record; flutter's
    # fp64 runs under the fp64 tag patterns of the JAX studies
    config4 = set(json.loads((ROOT / "tests" / "golden" /
                              "ours_config4_xdims.json").read_text()))
    assert set(runs["config4"]) == config4
    assert runs["flutter_fp64"] == [
        t + "_fp64card" for t in runs["c5_flutter"][:5]] + [
        runs["stall"][0] + "_fp64cpu"]
    assert "drive_long12k_s1_fp64cpu" in stall
    assert runs["config2"] == ["gas_furnace_C4_linear", "dryer_C4_linear"]
    assert runs["c2"][:2] == ["ballbeam_C2", "ballbeam_C2_seed1"]
    assert "flutter_C5_s4_ds64" in runs["c5_flutter"]
    assert "drive_C4_deep2_seed2" in runs["deep2"]
    jit = {r["tag"]: r["init_jitter"] for r in mod.arm_runs("drive12k")}
    assert jit["drive_long12k_s1_fp64cpu"] == 0.0
    assert jit["drive_long12k_s5_ds64"] == 1e-6
    with pytest.raises(ValueError, match="unknown arm"):
        mod.arm_runs("c7")


def test_jittered_start_is_the_ensembles():
    """``jitter_params`` is the perturbed start of ``fit_ensemble``'s
    chains: N(0, jitter²) a leaf from the generator seeded seed ^ 0x5EED."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.ensemble import fit_ensemble, jitter_params
    cfg = FFVDConfig(dataset="ballbeam", case=4, seed=3)
    base = FFVDModel(cfg, device="cpu").params
    j = jitter_params(base, 1e-6, 4)
    models = fit_ensemble(cfg, 2, device="cpu", init_jitter=1e-6,
                          num_iterations=1)
    g = torch.Generator().manual_seed(4 ^ 0x5EED)
    for k, v in base.leaves().items():
        want = v + 1e-6 * torch.randn(v.shape, generator=g, dtype=v.dtype)
        assert torch.equal(j.leaves()[k], want)
    # chain 1 started from the same jittered point: one step of C4 from it
    again = FFVDModel(FFVDConfig(dataset="ballbeam", case=4, seed=4),
                      device="cpu")
    again.state = again.trainer.init_state(j)
    again.fit(1)
    for k, v in models[1].params.leaves().items():
        assert torch.equal(v, again.params.leaves()[k])


def test_raises_without_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    out = tmp_path / "study.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script().main(["--quick", "--arms", "c4_six", "--out", str(out)])
    assert not out.exists()


def test_card_host_checks_run_on_the_cpu():
    """``scripts/study_checks_torch.py`` at a few iterations with every
    "card" run on the CPU: the pairs it reports then agree, the eager and
    the captured setups bit for bit."""
    import sys
    sys.path.insert(0, str(ROOT / "scripts"))
    import study_checks_torch
    out = study_checks_torch.main(device="cpu", iterations=3, draws=1,
                                  starts=())
    act, fl = out["actuator_c4"], out["flutter_c5_ds64"]
    assert out["card"] == "cpu"
    assert sorted(act["points"]) == sorted(
        ["card_fp32", "card_fp32_eager", "card_fp64", "cpu_fp32",
         "cpu_fp64"])
    assert all(math.isfinite(r) for p in act["points"].values()
               for r in p["rmse_plain_fp64"])
    assert act["pairs"]["card_fp32_eager|card_fp32"]["bit_equal"]
    assert all(p["max_rel_all"] < 1e-6 for p in act["pairs"].values())
    assert act["max_rel_kernel_vs_plain"] < 1e-3
    assert out["fp32_gradient"]["median_card_over_host"] == 1.0
    assert fl["pairs"]["card_eager|card"]["bit_equal"]
    assert fl["pairs"]["card|cpu"]["max_rel_all"] < 1e-6


# One record of each other arm kind (P=500 is left out: its sweep draws
# are 0.5 GB a member on the host).
NEW_TAGS = ("ballbeam_C6_ancestor_s0_fp64card", "ballbeam_C2_fp64card",
            "actuator_hybrid_j0", "ballbeam_C6_live_s0",
            "ballbeam_C6_live_s1", "ensemble/ballbeam",
            "ensemble/ballbeam_1chain_n40spread", "drive_slip_seed1",
            "kink_cold_hybrid_s0", "drive_polish2_s1",
            "ballbeam_C2_dsprecal_s20")
NEW_ARMS = ("c6_ballbeam_fp64,c2_fp64,actuator_prec,c6_live,ensemble,"
            "nll_slip,coldstart,stall,c2_precision")


@pytest.fixture(scope="module")
def new_study(tmp_path_factory):
    out = tmp_path_factory.mktemp("study_new") / "study.json"
    mod = _script()
    summary = mod.main(["--device", "cpu", "--dtype", "fp32", "--quick",
                        "--arms", NEW_ARMS, "--match",
                        "^(" + "|".join(NEW_TAGS) + ")$", "--out", str(out)])
    return mod, summary, json.loads(out.read_text())


def test_new_arms_records(new_study):
    """The other arms at --quick, fp32 on the CPU: every record finite with
    the fields its pin reads, the chains group as two members of one
    trainer, the fp64 arms in fp64."""
    mod, summary, doc = new_study
    runs = doc["runs"]
    assert sorted(summary["ran"]) == sorted(NEW_TAGS)
    for tag in ("ballbeam_C6_ancestor_s0_fp64card", "ballbeam_C2_fp64card"):
        assert runs[tag]["dtype"] == "fp64"
    assert runs["ballbeam_C6_ancestor_s0_fp64card"]["mixing_mean"]
    assert runs["actuator_hybrid_j0"]["collapse_precision"] == "hybrid"
    for s in (0, 1):
        rec = runs[f"ballbeam_C6_live_s{s}"]
        assert rec["mode"] == "chains" and rec["chains"] == 2
        assert rec["cfg"] == {"pg_ancestor_trace": False}
        assert rec["iterations"] == mod.QUICK["c6"]
        assert 0.0 < rec["mixing_mean"]["unique_frac"] <= 1.0
    ens = runs["ensemble/ballbeam"]
    assert ens["mode"] == "ensemble" and ens["chains"] == 4
    assert len(ens["per_chain"]) == 4
    assert all(math.isfinite(ens[k]) for k in ("rmse", "nll",
                                               "nll_no_spread"))
    one = runs["ensemble/ballbeam_1chain_n40spread"]
    assert one["chains"] == 1 and math.isfinite(one["nll_no_spread"])
    slip = runs["drive_slip_seed1"]
    assert slip["cfg"] == {"rollout_qsqrt_dim0": True}
    assert slip["v_first"] > 0 and len(slip["R"]) == 1
    cold = runs["kink_cold_hybrid_s0"]
    assert cold["iterations"] == mod.QUICK["cold"]
    assert all(math.isfinite(cold[k]) for k in (
        "nll_final_own_bound", "nll_final_ds64_bound", "rmse_h1",
        "rmse_h5"))
    pol = runs["drive_polish2_s1"]
    assert pol["iterations"] == mod.QUICK["polish"]
    assert math.isfinite(pol["v_first"])
    dsp = runs["ballbeam_C2_dsprecal_s20"]
    assert math.isfinite(dsp["final_elbo"]) and "clip_saturated" in dsp
    for rec in runs.values():
        assert rec["device"] == "cpu"
        assert all(math.isfinite(rec[k]) for k in ("train_s", "iterations"))


def test_polish_sets_the_phase_lr():
    """A polish run's Adam ends at lr/100 of the trainer's after
    ``polish2``; Adam's step count carries over the phases."""
    mod = _script()
    spec = [r for r in mod.arm_runs("stall")
            if r["tag"] == "drive_polish2_s1"][0]
    from ffvd_tpu_torch.api import FFVDModel
    seen = []
    orig = FFVDModel.fit

    def fit(self, n=None, **kw):
        seen.append((n, self.state.adam.param_groups[0]["lr"]))
        return orig(self, n, **kw)

    FFVDModel.fit = fit
    try:
        rec = mod.run_polish(spec, 8, torch.device("cpu"), torch.float64)
    finally:
        FFVDModel.fit = orig
    base = FFVDModel(mod._config(spec), device="cpu").trainer.adam_lr
    assert [n for n, _ in seen] == [4, 2, 2]
    np.testing.assert_allclose([lr for _, lr in seen],
                               [base, base / 10, base / 100], rtol=1e-12)
    assert rec["iterations"] == 8


def test_dsprecal_swaps_only_the_objectives_factorisation():
    """Under ``dsprecal`` the C2 objective factorises Kmm in float64
    (``ds_precal``) and returns to ``kernel_precal`` after; in fp64 the
    two objectives agree within the float32 rounding of the inputs."""
    mod = _script()
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.model import conditionals, elbo
    m = FFVDModel(FFVDConfig(dataset="ballbeam", case=2), device="cpu")
    with torch.no_grad():
        native = float(m.trainer.train_nll(m.params))
        with mod.dsprecal():
            assert elbo.cond is not conditionals
            assert elbo.cond.kernel_precal is not conditionals.kernel_precal
            dd = float(m.trainer.train_nll(m.params))
    assert elbo.cond is conditionals
    assert dd != native
    np.testing.assert_allclose(dd, native, rtol=1e-5)


def test_chains_member_record_matches_one_model_runner():
    """A chains-mode member's record (drive C6, two members of one
    ``MultiChainTrainer``, 2 iterations with the mixing side sweep)
    equals the one-model runner's on the same injected sweep draws at
    rtol 1e-10."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.inference.particle_gibbs import pg_draws
    mod = _script()
    specs = mod.arm_runs("c6_drive")[:2]
    cfg = mod._config(specs[0])
    params = FFVDModel(cfg, device="cpu").params
    g = torch.Generator().manual_seed(31)
    per = [[pg_draws(cfg, params, g) for _ in specs] for _ in range(2)]
    chains = mod.run_chains(specs, 2, torch.device("cpu"), torch.float64,
                            draws=[{"pg": d} for d in per])
    assert sorted(chains) == sorted(s["tag"] for s in specs)
    for i, spec in enumerate(specs):
        model, train_s, mixing = mod.train(
            spec, 2, "cpu", torch.float64,
            draws=[{"pg": d[i]} for d in per])
        one = mod.evaluated(model, spec, train_s, mixing)
        rec = chains[spec["tag"]]
        for k in ("rmse", "nll", "nll_first", "nll_last", "budget_s2C2",
                  "max_Q"):
            np.testing.assert_allclose(rec[k], one[k], rtol=1e-10, err_msg=k)
        np.testing.assert_allclose(rec["Q"], one["Q"], rtol=1e-10)
        for k, v in one["mixing_mean"].items():
            np.testing.assert_allclose(rec["mixing_mean"][k], v, rtol=1e-10,
                                       atol=1e-12, err_msg=k)
        assert rec["chains"] == 2 and rec["iterations"] == 2


def test_sampler_checks_run_on_the_cpu():
    """``study_checks_torch.py --sampler`` at a few iterations with every
    "card" run on the CPU: the shared-draw pairs of one dtype agree bit
    for bit, every endpoint rolls out finite, each stage is saved."""
    import sys
    sys.path.insert(0, str(ROOT / "scripts"))
    import study_checks_torch
    saved = []
    out = study_checks_torch.sampler_checks(
        torch.device("cpu"), 6, iterations=2, long_iterations=1, draws=1,
        starts=(2, 3), save=lambda partial: saved.append(sorted(partial)))
    assert len(saved) == 3 and "pairs" in saved[0]
    assert out["pairs"]["card_fp32|cpu_fp32"]["bit_equal"]
    assert out["pairs"]["card_fp64|cpu_fp64"]["bit_equal"]
    assert sorted(out["jittered"]) == sorted(
        f"card_{p}_s{s}" for p in ("fp32", "fp64") for s in (2, 3))
    assert all(math.isfinite(r) for v in {**out["shared"],
                                          **out["jittered"]}.values()
               for r in v["rmse_fp64"])


# The last arms: flutter's 12k run in fp64, BASELINE config 4 at x_dim 2
# and 6, config 2 (LinearK) on both datasets.
LAST_TAGS = ("flutter_long12k_s1_fp64cpu", "drive_xd2", "drive_xd6",
             "gas_furnace_C4_linear", "dryer_C4_linear")


def test_last_arms_records(tmp_path):
    """``flutter_fp64``, ``config4`` and ``config2`` at --quick, fp32 on
    the CPU: the fp64 run in fp64 at the 12k arm's quick length, the
    config 4 runs at their x_dim with 20 rollouts 50 apart and a latent
    state of that width, LinearK on its two datasets; every record finite
    with the fields the pins read; ``--quick`` keeps drive's three x_dims
    and both config 2 runs."""
    mod = _script()
    quick = [r["tag"] for a in ("flutter_fp64", "config4", "config2")
             for r in mod.arm_runs(a) if r["first"]]
    assert quick == ["flutter_C5_s0_fp64card", "flutter_long12k_s1_fp64cpu",
                     "drive_xd2", "drive_xd4", "drive_xd6",
                     "gas_furnace_C4_linear", "dryer_C4_linear"]
    out = tmp_path / "study.json"
    summary = mod.main(["--device", "cpu", "--dtype", "fp32", "--quick",
                        "--arms", "flutter_fp64,config4,config2", "--match",
                        "^(" + "|".join(LAST_TAGS) + ")$", "--out",
                        str(out)])
    runs = json.loads(out.read_text())["runs"]
    assert sorted(summary["ran"]) == sorted(LAST_TAGS)
    fp64 = runs["flutter_long12k_s1_fp64cpu"]
    assert fp64["dtype"] == "fp64" and fp64["arm"] == "flutter_fp64"
    assert fp64["iterations"] == mod.QUICK["12k"]
    for xd in (2, 6):
        rec = runs[f"drive_xd{xd}"]
        assert rec["cfg"] == {"x_dim": xd, "num_posterior_samples": 20,
                              "posterior_sample_spacing": 50}
        assert len(rec["Q"]) == xd and rec["dtype"] == "fp32"
    for ds in ("gas_furnace", "dryer"):
        assert runs[f"{ds}_C4_linear"]["cfg"] == {"kernel_type": "LinearK"}
    for tag, rec in runs.items():
        assert rec["iterations"] == (mod.QUICK["12k"] if "12k" in tag
                                     else mod.QUICK["c4"]), tag
        assert all(math.isfinite(rec[k]) for k in NUMBERS), tag
        assert rec["nll_last"] < rec["nll_first"], tag
