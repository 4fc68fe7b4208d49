"""The JAX package's own ballbeam C6 population in float64 on the CPU.

``tests/golden/pg_c6_study.py`` recorded ballbeam C6 (ancestor trace) in
float32 on a TPU: RMSE median 0.0064 over seeds 0-4.  The port's fp64 runs
of the same protocol on an H100 (``ballbeam_C6_ancestor_s*_fp64card`` in
``study_h100.json``) land at a median of 0.0170.  This script runs the JAX
package itself in float64, from the same vendored warm start, with
``pg_c6_study.py:70-110``'s settings: ``FFVDConfig(case=6,
iterations=2000, seed=s, pg_ancestor_trace=True)`` (4000 steps), the
model's own keys (``jax.random.key(seed)``), and a mixing side-sweep on
``jax.random.key(1000 + seed)`` after every 400 iterations.

It runs one seed a process, each limited to one CPU thread, and writes
``jax_c6_fp64cpu.json`` beside itself after every seed; a seed already in
the file is skipped, so a cut run resumes.  About 30 min a seed on one
core.  Usage::

    python tests/golden_torch/jax_c6_fp64cpu.py            # seeds 0-4
    python tests/golden_torch/jax_c6_fp64cpu.py --seeds 0 1 --procs 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
OUT = HERE / "jax_c6_fp64cpu.json"
ITER_CHUNK = 400
ONE_THREAD = {"XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false",
              "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
              "OPENBLAS_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def run_seed(seed: int) -> dict:
    """One seed of the protocol; the record has the keys of the port's."""
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from ffvd_tpu.api import FFVDModel
    from ffvd_tpu.config import FFVDConfig
    from ffvd_tpu.inference.particle_gibbs import make_pg_fn

    cfg = FFVDConfig(dataset="ballbeam", case=6, iterations=2000, seed=seed,
                     pg_ancestor_trace=True)
    model = FFVDModel(cfg, dtype=jnp.float64)
    stats_fn = jax.jit(make_pg_fn(cfg, with_stats=True))
    key = jax.random.key(1000 + seed)
    sweep_log = []
    t0 = time.time()
    done, total = 0, cfg.total_iterations
    while done < total:
        n = min(ITER_CHUNK, total - done)
        model.fit(n, chunk_size=n)
        done += n
        key, sub = jax.random.split(key)
        _, st = stats_fn(model.params, sub, model.data)
        sweep_log.append({k: float(v) for k, v in st.items()})
        print(f"seed {seed}: {done}/{total} {time.time() - t0:.0f} s",
              file=sys.stderr, flush=True)
    train_s = time.time() - t0
    ev = model.evaluate()
    p = model.params
    lv = np.asarray(p.kernel.log_variance, np.float64)
    c = np.asarray(p.c, np.float64)
    q = np.exp(np.asarray(p.log_q, np.float64))
    trace = np.asarray(model.nll_trace, np.float64)
    return {
        "rmse": ev["rmse"], "nll": ev["nll"], "iterations": done,
        "nll_first": float(trace[0]), "nll_last": float(trace[-1]),
        "budget_s2C2": float((np.exp(lv)[:, None] * c * c).sum()),
        "Q": q.tolist(), "max_Q": float(q.max()),
        "train_s": train_s, "dtype": "fp64", "device": "cpu",
        "package": "ffvd_tpu (JAX)",
        "mixing_mean": {k: float(np.mean([s[k] for s in sweep_log]))
                        for k in sweep_log[0]},
        "mixing_seq": sweep_log,
    }


def tag(seed: int) -> str:
    return f"ballbeam_C6_ancestor_s{seed}_jaxfp64cpu"


def _load() -> dict:
    return json.loads(OUT.read_text()) if OUT.exists() else {"runs": {}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=list(range(5)))
    ap.add_argument("--procs", type=int, default=5,
                    help="seeds run at once, one process and thread each")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        rec = run_seed(args.one)
        print("RECORD " + json.dumps(rec), flush=True)
        return 0
    todo = [s for s in args.seeds if tag(s) not in _load()["runs"]]
    env = {**os.environ, **ONE_THREAD}
    pending = list(todo)
    running = {}
    while pending or running:
        while pending and len(running) < args.procs:
            s = pending.pop(0)
            running[s] = subprocess.Popen(
                [sys.executable, __file__, "--one", str(s)], env=env,
                stdout=subprocess.PIPE, text=True)
        for s, proc in list(running.items()):
            if proc.poll() is None:
                continue
            out = proc.stdout.read()
            del running[s]
            line = [ln for ln in out.splitlines() if ln.startswith("RECORD ")]
            if proc.returncode or not line:
                print(f"seed {s} failed (rc {proc.returncode})", flush=True)
                continue
            data = _load()
            data["runs"][tag(s)] = json.loads(line[-1][len("RECORD "):])
            OUT.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
            print(f"{tag(s)}: rmse {data['runs'][tag(s)]['rmse']:.6g}",
                  flush=True)
        time.sleep(5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
