"""A run with the timed path broken underneath comes out not correct: each
fault of ``perfbench/faults.py`` that a cell can have, planted in the port,
on the CPU at a small size in float64 (the card's look skipped).

In float64 a sound run reads under 1e-9 on every number
(``test_perfbench_reference.py::test_whole_run_in_float64``), so the check
here holds each number to 1e-6: the configurations' limits are set for
float32 at the cells' own sizes, where ``perfbench/calibrate.py`` reads
each fault against them on the card."""

import pytest

from perfbench import faults
from perfbench.harness import manifest, runner
from perfbench.tests.test_perfbench_reference import SMALL, small

CASES = [(cell, fault) for cell in sorted(SMALL)
         for fault in faults.for_mix(manifest.cell(cell).mix)]
FLOAT64_LIMIT = 1e-6


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(cell, fault):
    over = small(cell)
    over["limits"] = {k: FLOAT64_LIMIT
                      for k in manifest.cell(cell).config["limits"]}
    with faults.FAULTS[fault]():
        r = runner.run_cell(cell, 2 ** 32 + 99, 0.2, False, device="cpu",
                            overrides=over)
    assert not r["correct"], (fault, r["checks"])
    assert max(row["value"] for row in r["checks"].values()) > 1e3 * \
        FLOAT64_LIMIT, (fault, r["checks"])
