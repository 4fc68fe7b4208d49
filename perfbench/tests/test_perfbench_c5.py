"""The C5 cell ``c5x4-train``: a whole run on the CPU at a small size in
float64 reads under 1e-9 on every number of the check; each fault that the
cell can have, and a sampler fault planted here (the SG-HMC normals
zeroed, their draws still made), fails it at 1e-6; on the card a traced
run prints every per-layer metric the cell names."""

import contextlib

import pytest

from perfbench import faults
from perfbench.harness import manifest, runner

CELL = "c5x4-train"
MIX = {"chunk_size": 2, "check_steps": 5, "stepwise_steps": 3}
SMALL = {"chains": 2, "dtype": "float64", "mix": MIX}
FLOAT64_LIMIT = 1e-6


@contextlib.contextmanager
def sampler_noise_zeroed():
    """Every SG-HMC sub-step's normals multiplied by 0 where the trainer
    draws them: the generator advances as before, the chain moves by its
    gradient alone."""
    from ffvd_tpu_torch.inference.trainer import Trainer

    orig = Trainer._sampler_normals

    def zeroed(self, sub, generator, steps=0):
        return {k: v * 0.0 for k, v in orig(self, sub, generator,
                                            steps).items()}

    Trainer._sampler_normals = zeroed
    try:
        yield
    finally:
        Trainer._sampler_normals = orig


FAULTS = {**{n: faults.FAULTS[n]
             for n in faults.for_mix(manifest.cell(CELL).mix)},
          "sampler_noise_zeroed": sampler_noise_zeroed}


def test_whole_run_in_float64():
    r = runner.run_cell(CELL, 2 ** 31 + 4321, 0.2, False, device="cpu",
                        overrides=SMALL)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    for name, row in r["checks"].items():
        assert row["value"] < 1e-9, (name, row)
    assert set(r["metrics"]) == {"train_iters_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_the_check(fault):
    over = dict(SMALL)
    over["limits"] = {k: FLOAT64_LIMIT
                      for k in manifest.cell(CELL).config["limits"]}
    with FAULTS[fault]():
        r = runner.run_cell(CELL, 2 ** 32 + 99, 0.2, False, device="cpu",
                            overrides=over)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.cuda
def test_traced_run_prints_every_metric():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the traced metrics read the card's trace")
    r = runner.run_cell(CELL, 3_141_592_999, 2.0, True)
    want = {m["name"] for m in manifest.cell(CELL).per_layer}
    assert set(r["metrics"]) == want, r["metrics"]
    assert all(v["value"] is not None for v in r["metrics"].values())
    assert r["metrics"]["graph_builds_per_kiter.train"]["value"] == 0.0
    assert r["correct"], r["checks"]
