"""Each example of the port (``examples_torch/``) runs on the CPU at a few
iterations (``--cpu --quick``) and exits 0.  Their JAX twins in
``examples/`` are not run here; ``03_warmstart_sweep.py`` has no port yet
(it needs the warm starts that are not in the repository)."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["01_quickstart", "02_all_datasets_one_jit",
            "04_synthetic_cold_start", "05_multidim_emission",
            "06_minibatch_long_sequence", "07_deep_transition",
            "08_ensemble_calibration", "09_particle_gibbs_c6"]


def test_the_examples_are_the_jax_ones_but_03():
    port = sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py"))
    jax = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert port == EXAMPLES
    assert jax == sorted(EXAMPLES + ["03_warmstart_sweep"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
         "--cpu", "--quick"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip()
