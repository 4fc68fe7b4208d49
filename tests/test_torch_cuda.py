"""The rollout kernel on the card against its plain version.

These tests need a CUDA device and ``nvcc``; elsewhere they skip.  They
import nothing of JAX, so on the card's machine (which has no JAX) they run
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Tolerances: fp64 rtol 1e-9 over all steps (summation order only); fp32
rtol 1e-4, atol 1e-5 over the first 10 steps.
"""

import pytest
import torch

from ffvd_tpu_torch.model.conditionals import kernel_precal
from ffvd_tpu_torch.ops import rollout as ro
from ffvd_tpu_torch.ops.kernels import KernelParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, dtype, d=3, m=37, u_dim=1, t_len=25, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    din = d + u_dim
    kp = KernelParams(torch.log(torch.rand(d, generator=g,
                                           dtype=torch.float64) + 0.2),
                      torch.log(torch.rand(d, din, generator=g,
                                           dtype=torch.float64) + 0.5))
    z = rnd(m, din)
    # a large jitter keeps Lm⁻¹ well conditioned, so fp32 rounding is not
    # amplified and the fp32 comparison measures the kernel, not the input
    pre = kernel_precal("SquaredExponential", kp, z, jitter=1e-2)
    q_sqrt = torch.triu(0.1 * rnd(d, m, m))
    args = [kp, z, pre.lm_inv, 0.3 * rnd(m, d), q_sqrt,
            0.05 + 0.1 * torch.rand(d, generator=g, dtype=torch.float64),
            0.5 * rnd(d), rnd(t_len, u_dim)]
    move = lambda t: t.to(device, dtype).contiguous()
    args = [KernelParams(move(kp.log_variance), move(kp.log_lengthscales))] \
        + [move(a) for a in args[1:]]
    return args


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_q", [True, False])
@pytest.mark.parametrize("u_dim", [1, 0])
def test_kernel_matches_plain_version(cuda, dtype, with_q, u_dim):
    args = _inputs(cuda, dtype, u_dim=u_dim)
    if not with_q:
        args[4] = None
    noise = 0.1 * torch.randn(5, 25, 3, dtype=dtype, device=cuda)
    before = ro.rollout.launches
    xk, vk = ro.rollout(*args, 5, noise=noise)
    torch.cuda.synchronize()
    assert ro.rollout.launches == before + 1
    xr, vr = ro.rollout_reference(*args, 5, noise=noise)
    if dtype == torch.float64:
        tol, h = dict(rtol=1e-9, atol=1e-12), 25
    else:   # a free-running fp32 recursion drifts: hold the first 10 steps
        tol, h = dict(rtol=1e-4, atol=1e-5), 10
    torch.testing.assert_close(xk[:, :h], xr[:, :h], **tol)
    torch.testing.assert_close(vk[:, :h], vr[:, :h], **tol)


def test_kernel_large_inducing_set(cuda):
    """D·M = 1280 > 1024 threads (each thread loops over several (d, m)) and
    more than 48 KB of dynamic shared memory in fp64."""
    args = _inputs(cuda, torch.float64, d=4, m=320, t_len=12)
    noise = 0.1 * torch.randn(3, 12, 4, dtype=torch.float64, device=cuda)
    xk, vk = ro.rollout(*args, 3, noise=noise)
    xr, vr = ro.rollout_reference(*args, 3, noise=noise)
    torch.testing.assert_close(xk, xr, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(vk, vr, rtol=1e-9, atol=1e-12)


def test_in_kernel_noise_is_the_plain_philox_stream(cuda):
    args = _inputs(cuda, torch.float64)
    xk, vk = ro.rollout(*args, 7, generator=torch.Generator().manual_seed(3))
    xr, vr = ro.rollout_reference(*args, 7,
                                  generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(xk, xr, rtol=1e-9, atol=1e-12)
    z = ro.ffvd_normals(42, 4096)
    torch.testing.assert_close(
        z, ro.philox_normals(42, (4096, 1, 1), torch.float32,
                             cuda).reshape(-1), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    args = _inputs(cuda, torch.float32)
    with pytest.raises(ValueError, match="float32/float64"):
        ro.rollout(*[a.half() if torch.is_tensor(a) else
                     KernelParams(a.log_variance.half(),
                                  a.log_lengthscales.half())
                     for a in args], 2)
    noise = torch.zeros(2, 50, 3, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ro.rollout(*args, 2, noise=noise)
