"""The port stands alone: it imports nothing of JAX or of ``ffvd_tpu``, its
entry points refuse to fall back to the CPU, and its kernel module imports
on a machine without ``nvcc``.  The same holds for its benchmark script
(``scripts/bench_torch.py``) and its examples (``examples_torch/``)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_no_jax_package():
    code = """
import importlib, pkgutil, sys
import ffvd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ffvd_tpu_torch.__path__,
                                               "ffvd_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "optax") or m.startswith("jax.")
             or m == "ffvd_tpu" or m.startswith("ffvd_tpu."))
print(len(names), bad)
assert not bad, bad
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]"


def test_chip_smoke_imports_no_jax():
    out = _run("import sys, chip_smoke; "
               "assert 'jax' not in sys.modules and "
               "'ffvd_tpu' not in sys.modules")
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_cuda():
    code = """
import torch
from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.config import FFVDConfig
assert not torch.cuda.is_available()
try:
    FFVDModel(FFVDConfig())
except RuntimeError as exc:
    print("raised:", exc)
else:
    raise SystemExit("FFVDModel ran without CUDA")
"""
    if torch.cuda.is_available():
        return          # the card's machine: nothing to refuse there
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "no CUDA device" in out.stdout


def test_rollout_module_imports_and_runs_without_nvcc():
    """With no nvcc on PATH and no CUDA_HOME, the kernel module imports and
    its CPU path runs; nothing is built."""
    env = dict(os.environ)
    env["PATH"] = str(Path(sys.executable).parent)
    env.pop("CUDA_HOME", None)
    env.pop("CUDA_PATH", None)
    code = """
import shutil, torch
assert shutil.which("nvcc") is None
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.ops.kernels import KernelParams
from ffvd_tpu_torch.utils import cuda_build
d, m = 2, 5
kp = KernelParams(torch.zeros(d, dtype=torch.float64),
                  torch.zeros(d, d + 1, dtype=torch.float64))
z = torch.randn(m, d + 1, dtype=torch.float64)
xs, vs = ro.rollout(kp, z, torch.eye(m, dtype=torch.float64).expand(d, m, m),
                    torch.zeros(m, d, dtype=torch.float64), None,
                    torch.ones(d, dtype=torch.float64),
                    torch.zeros(d, dtype=torch.float64),
                    torch.zeros(3, 1, dtype=torch.float64), 2)
assert xs.shape == (2, 3, d) and ro.rollout.launches == 0
assert ro._lib is None and not cuda_build._loaded
print("ok")
"""
    out = _run(code, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


SCRIPTS = ["scripts/bench_torch.py", "scripts/study_torch.py",
           "scripts/study_checks_torch.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "examples_torch").glob("*.py"))
JAX_NAMES = ("jax", "jaxlib", "optax", "ffvd_tpu")


def _is_jax(name):
    return any(name == n or name.startswith(n + ".") for n in JAX_NAMES)


@pytest.mark.parametrize("path", SCRIPTS)
def test_bench_and_examples_import_no_jax(path):
    """No import statement of the file names JAX, optax or the JAX
    package."""
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert any(n.startswith("ffvd_tpu_torch") for n in names)
    assert not [n for n in names if _is_jax(n)]


@pytest.mark.parametrize("path", SCRIPTS)
def test_bench_and_examples_raise_without_cuda(path):
    """Run as a user would, without ``--platform cpu`` / ``--cpu``: the
    card is the default, so where there is none the file raises, and it
    has imported nothing of JAX by then."""
    if torch.cuda.is_available():
        return          # the card's machine: nothing to refuse there
    code = f"""
import runpy, sys
sys.argv = [{path!r}]
try:
    runpy.run_path({path!r}, run_name="__main__")
except RuntimeError as exc:
    print("raised:", exc)
else:
    raise SystemExit("ran without CUDA")
bad = sorted(m for m in sys.modules
             if any(m == n or m.startswith(n + ".") for n in {JAX_NAMES!r}))
assert not bad, bad
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "no CUDA device" in out.stdout
