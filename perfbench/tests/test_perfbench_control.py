"""The control: the reference itself in float32 with TF32 matmuls, put in
the program's place, fails the check of every cell at the cell's own size.
Needs the card: TF32 exists only there."""

import pytest

from perfbench import calibrate
from perfbench.harness import check, manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control computes in TF32, which only the card has")
    c = manifest.cell(cell)
    _, members, outputs = calibrate.sound(c, 3_100_000_000, "cuda")
    numbers = calibrate.control(c, members, outputs, "cuda")
    assert not check.verdict(numbers, c.config["limits"])["correct"], numbers
