"""The rollout kernel's launch plan and packed factors, on the CPU.

``rollout_plan`` fixes how ``csrc/rollout.cu`` is launched (one cluster of
min(D, 8) CTAs per sample, the owned dims' packed factors in shared memory
when they fit the H100's 232,448-byte opt-in) and is the only place that
choice is made, so it is held here at the shapes the port meets: D of
ballbeam (4), ``--x_dims 2|6``, D past the cluster limit (9); M of the
tests (37, 320), the main path (100) and ``--num_inducing 200``.  The
packing is held exactly against ``torch.tril`` / ``torch.triu(...).mT``.
"""

import numpy as np
import pytest
import torch

from ffvd_tpu_torch.model.conditionals import kernel_precal
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.ops.kernels import KernelParams

H100_OPTIN = 232_448


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("m", [37, 100, 200, 320])
@pytest.mark.parametrize("d", [1, 2, 4, 6, 9])
def test_plan_shape(d, m, itemsize):
    din = d + 1
    plan = ro.rollout_plan(d, m, din, itemsize, H100_OPTIN)
    assert plan.cluster == min(d, 8)
    assert plan.dims_per_cta == -(-d // plan.cluster)
    assert plan.dims_per_cta == (2 if d == 9 else 1)
    assert plan.threads % 32 == 0
    assert plan.threads == min(1024, -(-plan.dims_per_cta * m * 4 // 32) * 32)
    # the packed pair of every owned dim fits beside the working arrays
    factors = plan.dims_per_cta * m * (m + 1) * itemsize
    global_plan = ro.rollout_plan(d, m, din, itemsize, 0)
    assert not global_plan.resident
    assert plan.resident == (global_plan.smem_bytes + factors <= H100_OPTIN)
    assert plan.smem_bytes == (global_plan.smem_bytes
                               + (factors if plan.resident else 0))
    if plan.resident:
        assert plan.smem_bytes <= H100_OPTIN


@pytest.mark.parametrize("d,m,itemsize,resident", [
    (4, 100, 4, True), (4, 100, 8, True),      # the main path
    (4, 200, 4, True), (6, 200, 4, True),      # --num_inducing 200, fp32
    (4, 200, 8, False), (4, 320, 8, False),    # fp64 past M≈165
    (4, 320, 4, False), (9, 100, 8, True), (9, 200, 4, False),
])
def test_plan_resident_where_the_factors_fit(d, m, itemsize, resident):
    assert ro.rollout_plan(d, m, d + 1, itemsize,
                           H100_OPTIN).resident is resident


def test_plan_keeps_the_kernel_thread_limit():
    plan = ro.rollout_plan(4, 320, 5, 8, H100_OPTIN, max_threads=800)
    assert plan.threads == 800
    assert ro.rollout_plan(4, 100, 5, 8, H100_OPTIN,
                           max_threads=800).threads == 416


def _packed_row(packed, m):
    return packed[..., m * (m + 1) // 2:(m + 1) * (m + 2) // 2]


@pytest.mark.parametrize("m", [1, 7, 37])
def test_packed_factors_unpack_to_the_triangles(m):
    rng = np.random.RandomState(m)
    d, din = 3, 4
    kp = KernelParams(torch.tensor(np.log(rng.rand(d) + 0.2)),
                      torch.tensor(np.log(rng.rand(d, din) + 0.5)))
    z = torch.tensor(rng.randn(m, din))
    lm_inv = kernel_precal("SquaredExponential", kp, z, jitter=1e-2).lm_inv
    q_sqrt = torch.tensor(rng.randn(d, m, m))   # full: the wrapper cuts it
    args = ro.kernel_inputs(kp, z, lm_inv, torch.tensor(rng.randn(m, d)),
                            q_sqrt, torch.ones(d, dtype=torch.float64),
                            torch.zeros(d, dtype=torch.float64),
                            torch.zeros(5, 1, dtype=torch.float64), 2)
    p = m * (m + 1) // 2
    assert args["lp"].shape == (d, p) and args["qp"].shape == (d, p)
    lower = torch.tril(lm_inv) * torch.exp(kp.log_variance)[:, None, None]
    upper_t = torch.triu(q_sqrt).mT
    for name, full in (("lp", lower), ("qp", upper_t)):
        unpacked = torch.zeros_like(full)
        for row in range(m):
            unpacked[:, row, :row + 1] = _packed_row(args[name], row)
        assert torch.equal(unpacked, full), name
    # the kernel's row products: a = σ²Lm⁻¹e, w = q_sqrtᵀa, row by row
    e = torch.tensor(rng.rand(d, m))
    a = torch.stack([(_packed_row(args["lp"], row) * e[:, :row + 1]).sum(-1)
                     for row in range(m)], dim=1)
    w = torch.stack([(_packed_row(args["qp"], row) * a[:, :row + 1]).sum(-1)
                     for row in range(m)], dim=1)
    torch.testing.assert_close(a, (lower @ e[..., None])[..., 0], rtol=1e-12,
                               atol=1e-14)
    torch.testing.assert_close(
        w, (torch.triu(q_sqrt).mT @ a[..., None])[..., 0], rtol=1e-12,
        atol=1e-14)


def test_kernel_inputs_drop_empty_controls_and_missing_qsqrt():
    d, m = 2, 5
    kp = KernelParams(torch.zeros(d, dtype=torch.float64),
                      torch.zeros(d, d, dtype=torch.float64))
    z = torch.randn(m, d, dtype=torch.float64)
    args = ro.kernel_inputs(kp, z, torch.eye(m, dtype=torch.float64)
                            .expand(d, m, m), torch.zeros(m, d,
                                                          dtype=torch.float64),
                            None, torch.ones(d, dtype=torch.float64),
                            torch.arange(d, dtype=torch.float64),
                            torch.zeros(4, 0, dtype=torch.float64), 3)
    assert args["controls"] is None and args["qp"] is None
    assert args["x0"].shape == (3, d) and args["x0"].is_contiguous()
    assert torch.equal(args["x0"][2], torch.arange(d, dtype=torch.float64))
