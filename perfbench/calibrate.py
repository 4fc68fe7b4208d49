"""Readings that the limits of the check are set from, at a cell's own size.

    python3 perfbench/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 --fault-seeds 3 --out <file.json>

For each seed: the cell's set-up and as many evaluations as a run checks,
then every number of the check (the sound readings).  On the first
``--control-seeds`` seeds also the control: the reference itself in
float32 with TF32 matmuls, put in the program's place (it trains and
evaluates as the program does) and held against the float64 reference.  On the first ``--fault-seeds`` seeds each fault of
``perfbench/faults.py`` that the cell can have, planted in the port.  Needs
the card; writes one JSON object.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not readable"


def sound(cell, seed: int, device: str, fault=None):
    """(the numbers of one program run at ``seed``, the run's members and
    outputs), with ``fault`` (a context manager) planted while the program
    runs."""
    import contextlib

    from perfbench.harness import runner
    with fault() if fault else contextlib.nullcontext():
        run = runner.Run(cell, seed, device)
        for _ in range(cell.mix.get("checked_calls", 0)):
            cs = next(run.call_seeds)
            run.sample.offer((cs, run.sut.evaluate(cs)))
        outputs = run.program_outputs()
        run.release()
    members = run.members()
    return runner.compare(cell, members, outputs, device), members, outputs


def control(cell, members, outputs, device):
    """The numbers of the reference in float32 with TF32 on, in the
    program's place, from the same start and with the same evaluation
    seeds."""
    import torch

    from perfbench.harness import runner
    seeds = [cs for cs, _ in outputs["calls"]]
    truth = runner.reference_outputs(cell, members, seeds, torch.float64,
                                     device)
    runner.set_tf32(True)
    try:
        low = runner.reference_outputs(cell, members, seeds, torch.float32,
                                       device)
    finally:
        runner.set_tf32(cell.config["tf32"])
    return runner.judge(cell, low, truth, members)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import faults
    from perfbench.harness import manifest
    cell = manifest.cell(args.workload)
    out = {"workload": args.workload, "card": card_line(),
           "torch": torch.__version__, "sound": [], "control": [],
           "faults": {}}
    t0 = time.time()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        numbers, members, outputs = sound(cell, seed, args.device)
        out["sound"].append({"seed": seed, **numbers})
        if i < args.control_seeds:
            out["control"].append({"seed": seed, **control(
                cell, members, outputs, args.device)})
        print(f"seed {seed}: {numbers} ({time.time() - t0:.1f} s)",
              file=sys.stderr, flush=True)
    for name in faults.for_mix(cell.mix):
        out["faults"][name] = [
            {"seed": seed, **sound(cell, seed, args.device,
                                   faults.FAULTS[name])[0]}
            for seed in seeds[:args.fault_seeds]]
    out["seconds"] = time.time() - t0
    keys = [k for k in out["sound"][0] if k != "seed"]
    out["lower"] = {k: max(r[k] for r in out["sound"]) for k in keys}
    if out["control"]:
        out["upper_control"] = {k: min(r[k] for r in out["control"])
                                for k in keys}
    out["upper_faults"] = {n: {k: min(r[k] for r in rs) for k in keys}
                           for n, rs in out["faults"].items()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("lower", "upper_control",
                                          "upper_faults") if k in out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
