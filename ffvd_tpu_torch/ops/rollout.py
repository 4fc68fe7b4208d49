"""Fused free-running posterior rollout: the CUDA kernel and its plain version.

``rollout`` computes S free-running trajectories of the GP-SSM, the
recursion of ``ffvd_tpu/eval/rollout.py::_rollout_one`` (x_{t+1} = x_t +
mean + √max(var+Q, 0)·ε), for every sample at once.  On CUDA tensors it
launches ``csrc/rollout.cu`` (the hand-written Hopper kernel that replaces
``ffvd_tpu/ops/pallas_rollout.py::_rollout_kernel``) or raises; on CPU
tensors it runs ``rollout_reference``, the plain PyTorch version with the
same signature and the same arithmetic.

The noise ε is either given (``noise`` of shape (S, T, D), so tests can feed
both packages the same draws) or drawn from Philox4x32-10 keyed by a 64-bit
seed that the wrapper draws from the caller's ``torch.Generator``.  The
plain version carries its own Philox (``philox4x32``) and Box-Muller
(``bits_to_normal``), so the kernel and the plain version give the same
trajectories for the same generator state.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ffvd_tpu_torch.ops.kernels import KernelParams

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


# ---------------------------------------------------------------------------
# Philox4x32-10 and Box-Muller in plain PyTorch
# ---------------------------------------------------------------------------

def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a·b for a constant a < 2³² and int64 b
    holding uint32 values, without 64-bit overflow (16-bit split)."""
    p1 = a * (b & 0xFFFF)                       # < 2⁴⁸
    p2 = a * (b >> 16)                          # < 2⁴⁸
    lo = (p1 + ((p2 & 0xFFFF) << 16)) & _MASK32
    hi = (p2 + (p1 >> 16)) >> 16
    return hi, lo


def philox4x32(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    counter words; key = (low, high) 32 bits of ``seed``."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_normal(b1: torch.Tensor, b2: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Box-Muller on uint32 bits (``pallas_rollout.py::bits_to_normal``):
    u1 = ((b1>>8)+1)·2⁻²⁴ ∈ (0, 1], u2 = (b2>>8)·2⁻²⁴,
    z = √(−2 ln u1)·cos(2π u2)."""
    b1 = b1.to(torch.int64) & _MASK32
    b2 = b2.to(torch.int64) & _MASK32
    u1 = ((b1 >> 8) + 1).to(dtype) * (2.0 ** -24)
    u2 = (b2 >> 8).to(dtype) * (2.0 ** -24)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * torch.pi) * u2)


def philox_normals(seed: int, shape: Tuple[int, int, int], dtype=torch.float32,
                   device="cpu") -> torch.Tensor:
    """(S, T, D) normals of the kernel's stream: counter (s, t, d, 0)."""
    s, t, d = (torch.arange(n, dtype=torch.int64, device=device)
               for n in shape)
    c0 = s[:, None, None].expand(shape)
    c1 = t[None, :, None].expand(shape)
    c2 = d[None, None, :].expand(shape)
    b = philox4x32(c0, c1, c2, torch.zeros_like(c0), seed)
    return bits_to_normal(b[0], b[1], dtype)


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """A 63-bit Philox key from the caller's generator (or torch's default)."""
    device = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator,
                             device=device, dtype=torch.int64))


# ---------------------------------------------------------------------------
# Shared preparation and the plain version
# ---------------------------------------------------------------------------

def _prepare(kparams: KernelParams, z, lm_inv, q_sqrt):
    """The kernel's inputs: Z/ℓ (D, M, Din), 1/ℓ (D, Din), σ² (D,), the
    σ²-folded lower triangle of Lm⁻¹ (as pallas_rollout.py:157 folds it)
    and the upper triangle of q_sqrt (q_sqrt = chol(H)⁻ᵀ is upper)."""
    ils = torch.exp(-kparams.log_lengthscales)
    zs = z[None, :, :] * ils[:, None, :]
    kvar = torch.exp(kparams.log_variance)
    lminv = torch.tril(lm_inv) * kvar[:, None, None]
    qsq = None if q_sqrt is None else torch.triu(q_sqrt)
    return zs, ils, kvar, lminv, qsq


def _check_inputs(z, lm_inv, u_val, q_sqrt, q, x0, controls, num_samples,
                  noise):
    m, din = z.shape
    d = x0.shape[-1]
    cu = controls.shape[1]
    t_len = controls.shape[0]
    if din != d + cu:
        raise ValueError(f"z has {din} input columns, expected D + U = "
                         f"{d} + {cu}")
    want = {"lm_inv": (lm_inv, (d, m, m)), "u_val": (u_val, (m, d)),
            "q": (q, (d,)), "x0": (x0, (d,))}
    if q_sqrt is not None:
        want["q_sqrt"] = (q_sqrt, (d, m, m))
    if noise is not None:
        want["noise"] = (noise, (num_samples, t_len, d))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in [("lm_inv", lm_inv), ("u_val", u_val), ("q", q),
                    ("x0", x0), ("controls", controls), ("q_sqrt", q_sqrt),
                    ("noise", noise)]:
        if t is not None and (t.device != z.device or t.dtype != z.dtype):
            raise ValueError(f"{name} is {t.dtype} on {t.device}; z is "
                             f"{z.dtype} on {z.device}")


def rollout_reference(kparams: KernelParams, z: torch.Tensor,
                      lm_inv: torch.Tensor, u_val: torch.Tensor,
                      q_sqrt: Optional[torch.Tensor], q: torch.Tensor,
                      x0: torch.Tensor, controls: torch.Tensor,
                      num_samples: int, *, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """Plain PyTorch rollout: a loop over T, batched over S and D.  Same
    signature and arithmetic as ``rollout``.  Returns (xs, var_tot), each
    (S, T, D)."""
    _check_inputs(z, lm_inv, u_val, q_sqrt, q, x0, controls, num_samples,
                  noise)
    zs, ils, kvar, lminv, qsq = _prepare(kparams, z, lm_inv, q_sqrt)
    s, d = num_samples, x0.shape[0]
    t_len = controls.shape[0]
    if noise is None:
        noise = philox_normals(draw_seed(generator), (s, t_len, d), z.dtype,
                               z.device)
    x = x0[None, :].expand(s, d)
    xs, vs = [], []
    for t in range(t_len):
        xc = torch.cat([x, controls[t][None, :].expand(s, -1)], dim=1)
        diff = zs[:, :, None, :] - (xc[None, :, :] * ils[:, None, :])[:, None]
        e = torch.exp(-0.5 * torch.sum(diff * diff, dim=-1))  # (D, M, S)
        a = lminv @ e                                          # (D, M, S)
        mean = torch.einsum("dms,md->sd", a, u_val)
        var = kvar[None, :] - torch.sum(a * a, dim=1).T
        if qsq is not None:
            w = qsq.mT @ a
            var = var + torch.sum(w * w, dim=1).T
        var_tot = torch.clamp(var + q[None, :], min=0.0)
        x = (x + mean) + noise[:, t] * torch.sqrt(var_tot)
        xs.append(x)
        vs.append(var_tot)
    return torch.stack(xs, dim=1), torch.stack(vs, dim=1)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_ptr = ctypes.c_void_p
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ffvd_tpu_torch.utils.cuda_build import load
        lib = load("rollout")
        for fn in (lib.ffvd_rollout_f32, lib.ffvd_rollout_f64):
            fn.argtypes = [_ptr] * 12 + [ctypes.c_int] * 5 + [ctypes.c_uint64,
                                                              _ptr]
            fn.restype = ctypes.c_int
        lib.ffvd_normals.argtypes = [ctypes.c_uint64, _ptr, ctypes.c_longlong,
                                     _ptr]
        lib.ffvd_normals.restype = ctypes.c_int
        _lib = lib
    return _lib


def _kernel_arg(name: str, t: Optional[torch.Tensor]):
    """The pointer the kernel reads (device and dtype are checked by
    ``_check_inputs``)."""
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def rollout(kparams: KernelParams, z: torch.Tensor, lm_inv: torch.Tensor,
            u_val: torch.Tensor, q_sqrt: Optional[torch.Tensor],
            q: torch.Tensor, x0: torch.Tensor, controls: torch.Tensor,
            num_samples: int, *, noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None):
    """S = ``num_samples`` rollouts of T = controls.shape[0] steps from x0.

    kparams: SE-ARD hypers (D,), (D, Din); z (M, Din); lm_inv (D, M, M)
    lower triangular; u_val (M, D); q_sqrt (D, M, M) upper triangular or
    None; q (D,); x0 (D,); controls (T, U), U may be 0; noise (S, T, D) or
    None.  Returns (xs, var_tot), each (S, T, D), var_tot clamped at 0.
    CUDA tensors launch the kernel (float32 or float64); CPU tensors run
    ``rollout_reference``."""
    if z.device.type == "cpu":
        return rollout_reference(kparams, z, lm_inv, u_val, q_sqrt, q, x0,
                                 controls, num_samples, noise=noise,
                                 generator=generator)
    if z.device.type != "cuda":
        raise ValueError(f"rollout runs on cuda or cpu, not {z.device}")
    if z.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rollout kernel takes float32/float64, not {z.dtype}")
    _check_inputs(z, lm_inv, u_val, q_sqrt, q, x0, controls, num_samples,
                  noise)
    dtype, device = z.dtype, z.device
    zs, ils, kvar, lminv, qsq = _prepare(kparams, z, lm_inv, q_sqrt)
    s, d, m = num_samples, x0.shape[0], z.shape[0]
    t_len, cu = controls.shape
    seed = draw_seed(generator) if noise is None else 0
    args = {
        "x0": x0[None, :].expand(s, d).contiguous(),
        "zs": zs.contiguous(), "ils": ils.contiguous(),
        "kvar": kvar.contiguous(),
        "w": lminv.mT.contiguous(),      # w[d,k,m] = σ²Lm⁻¹[d,m,k]
        "u_val": u_val.contiguous(), "q": q.contiguous(),
        "controls": controls if cu > 0 else None,
        "q_sqrt": None if qsq is None else qsq.contiguous(),
        "noise": noise,
    }
    xs = torch.empty((s, t_len, d), dtype=dtype, device=device)
    vs = torch.empty_like(xs)
    ptrs = [_kernel_arg(k, v) for k, v in args.items()]
    lib = _library()
    fn = lib.ffvd_rollout_f32 if dtype == torch.float32 else lib.ffvd_rollout_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, xs.data_ptr(), vs.data_ptr(), s, t_len, d, m, cu,
                 seed, stream)
    if err != 0:
        raise RuntimeError(f"rollout kernel launch failed: CUDA error {err}")
    rollout.launches += 1
    return xs, vs


rollout.launches = 0


def ffvd_normals(seed: int, n: int, device="cuda") -> torch.Tensor:
    """n float32 normals from the kernel's own generator (counter (i,0,0,0),
    i.e. ``philox_normals(seed, (n, 1, 1))``), for checking its moments."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("ffvd_normals is a CUDA kernel")
    out = torch.empty(n, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _library().ffvd_normals(seed, out.data_ptr(), n,
                                      torch.cuda.current_stream(device)
                                      .cuda_stream)
    if err != 0:
        raise RuntimeError(f"ffvd_normals launch failed: CUDA error {err}")
    return out
