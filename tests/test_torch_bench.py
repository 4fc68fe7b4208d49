"""``scripts/bench_torch.py``, the port's counterpart of ``bench.py``: on
the CPU at ``--quick`` it prints one JSON line with ``bench.py``'s keys
(its TPU peak's ``mfu``/``peak_ref`` are left out for a card the table
lacks), plus ``c4_evaluate_ms`` and ``card``, every number finite; and its
FLOP count of a C4 iteration is the formula of its docstring."""

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "bench_torch.py"
# bench.py's line (BENCH_r05.json's "parsed"), without the TPU peak's keys.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
EXTRA_KEYS = {"time_2000_cli_iters_sec", "final_nll", "platform", "dtype",
              "c2_iters_per_sec_steady", "c5_iters_per_sec_steady",
              "m512_ms_per_iter_steady", "m512_gflops_per_iter",
              "m512_achieved_tflops", "six_ds_m512_ms_per_6model_iter_steady",
              "six_ds_m512_aggregate_iters_per_sec",
              "ds64_drive_c4_iters_per_sec_steady"}


def _bench():
    spec = importlib.util.spec_from_file_location("bench_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quick_cpu_run_prints_bench_py_line(tmp_path):
    # Two threads, as the other tests use: a script that takes every core
    # slows many times over when the suite's workers share them.
    out = subprocess.run([sys.executable, str(SCRIPT), "--platform", "cpu",
                          "--quick"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "ffvd_train_iters_per_sec_ballbeam_c4_cpu"
    assert line["unit"] == "iters/sec"
    extra = line["extra"]
    assert set(extra) == EXTRA_KEYS | {"c4_evaluate_ms", "card"}
    assert extra["platform"] == "cpu" and extra["dtype"] == "float32"
    assert extra["card"] is None
    numbers = [line["value"], line["vs_baseline"]] + [
        v for k, v in extra.items() if k not in ("platform", "dtype", "card")]
    assert all(isinstance(v, float) and math.isfinite(v) for v in numbers)
    assert line["value"] > 0 and extra["m512_gflops_per_iter"] > 0


# By hand, F_d = 4·M²·N + 4·M·N + 3·Din·M·N + 3·Din·M² + 4·M³/3 + 2·M²:
# (N, D, M, Din) = (10, 2, 3, 3): 360 + 120 + 270 + 81 + 36 + 18 = 885,
# 3·2·885 = 5310; (4, 1, 2, 1): 64 + 32 + 24 + 12 + 32/3 + 8, 3·(452/3).
@pytest.mark.parametrize("shape,flops", [((10, 2, 3, 3), 5310.0),
                                         ((4, 1, 2, 1), 452.0)])
def test_flop_count_by_hand(shape, flops):
    assert _bench().c4_flops_per_iter(*shape) == pytest.approx(flops,
                                                               rel=1e-12)
