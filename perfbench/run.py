"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the system built from the seed, the steps the reference follows,
the shapes warmed up), the measured window, the check against the plain
reference, then one JSON line on stdout: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, last, ``checks``, each
number compared beside its limit (also the last lines on stderr).

It exits with another code than 0 and prints no result where the port
cannot be imported, where the machine lacks the cards the cell asks for,
and where the process holds JAX or the JAX package after the window.
Build and kernel caches go under ``_bench_cache/`` of the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "_bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    log = lambda msg: print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    try:
        import ffvd_tpu_torch  # noqa: F401  the system under test
        log(f"port imported at {time.perf_counter() - T_START:.3f} s")
    except ImportError as e:
        print(f"perfbench: the port cannot be imported here: {e}",
              file=sys.stderr)
        return 2
    from perfbench.harness import guards, manifest, runner

    work = next((w for w in manifest.manifest()["workloads"]
                 if w["name"] == args.workload), None)
    if work is None:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    problem = guards.card_problem(work["chips"])
    if problem:
        print(f"perfbench: {problem}", file=sys.stderr)
        return 3
    log(f"card found at {time.perf_counter() - T_START:.3f} s")
    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START, log=log)
    found = guards.forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found}", file=sys.stderr)
        return 4
    for k, r in result["checks"].items():
        print(f"check {k}: {r['value']!r} (limit {r['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
