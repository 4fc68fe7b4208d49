"""A run refuses JAX and the JAX package by whole top-level name, and a
machine without the cell's cards."""

import subprocess
import sys
import types

from perfbench.harness import guards, manifest


def test_forbidden_names_compared_whole():
    assert guards.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert guards.forbidden_modules(["ffvd_tpu.model.elbo"]) == ["ffvd_tpu"]
    assert guards.forbidden_modules(["ffvd_tpu_torch", "jaxtyping",
                                     "flaxen"]) == []
    assert guards.forbidden_modules(["jaxlib.xla", "flax.linen"]) == [
        "flax", "jaxlib"]


def test_planted_jax_is_found(monkeypatch):
    assert guards.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert guards.forbidden_modules() == ["jax"]


def test_port_loads_no_jax():
    import ffvd_tpu_torch.parallel  # noqa: F401
    assert guards.forbidden_modules() == []


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return
    run = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "c4x8-train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout.strip() == ""
    assert "CUDA" in run.stderr


def test_reference_imports_nothing_of_the_program():
    src = (manifest.BENCH / "reference" / "gpssm.py").read_text()
    assert "ffvd_tpu" not in src.replace("ffvd_tpu/data", "")
    assert "jax" not in src
