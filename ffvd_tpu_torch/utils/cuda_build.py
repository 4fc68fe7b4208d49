"""Build the port's CUDA sources into plain-C shared libraries.

Each ``ffvd_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a
into ``ffvd_tpu_torch/_build/lib<name>-<hash>.so`` at first use and loaded
with ``ctypes``.  The hash covers the source and the flags, so an edited
source is rebuilt; the build directory is listed in ``.gitignore``.  Nothing
happens at import: a machine without ``nvcc`` can import every module.

This is all the port compiles at run time, so the JAX package's
``utils/compile_cache.py`` (a persistent XLA compilation cache for its
jitted programs) has no counterpart: eager PyTorch compiles nothing, and
the hashed ``_build/`` library already persists across processes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           "CUDA_HOME): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together.  Returns each name's compiler output ("" when it
    was already built).  Raises with the output of every failed build."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)    # atomic: concurrent builders never clash
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
