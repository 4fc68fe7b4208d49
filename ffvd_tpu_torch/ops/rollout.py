"""Fused free-running posterior rollout: the CUDA kernel and its plain version.

``rollout`` computes S free-running trajectories of the GP-SSM, the
recursion of ``ffvd_tpu/eval/rollout.py::_rollout_one`` (x_{t+1} = x_t +
mean + √max(var+Q, 0)·ε), for every sample at once.  On CUDA tensors it
launches ``csrc/rollout.cu`` (the hand-written Hopper kernel that replaces
``ffvd_tpu/ops/pallas_rollout.py::_rollout_kernel``) or raises; on CPU
tensors it runs ``rollout_reference``, the plain PyTorch version with the
same signature and the same arithmetic.  ``rollout_batched`` (plain
version ``rollout_reference_batched``) takes its own parameters for each
sample, as a thinned SG-HMC posterior has them, and is still one launch:
the kernel reads each parameter array at a per-sample stride, 0 when the
samples share it.

The noise ε is either given (``noise`` of shape (S, T, D), so tests can feed
both packages the same draws) or drawn from Philox4x32-10 keyed by a 64-bit
seed that the wrapper draws from the caller's ``torch.Generator``.  The
plain version carries its own Philox (``philox4x32``) and Box-Muller
(``bits_to_normal``), so the kernel and the plain version give the same
trajectories for the same generator state.  ``row_offset`` shifts the
counter's row word: a launch of rows [r0, r1) of a larger batch with
``row_offset=r0`` draws what one launch of the whole batch draws for those
rows (one launch a process of a sharded run, ``eval/ensemble.py``).

The kernel runs one thread-block cluster per sample and keeps each latent
dim's triangular factors, packed by lower rows (``pack_lower_rows``), in
its CTA's shared memory when they fit.  ``rollout_plan`` makes that choice
and fixes the launch's shape; the launcher checks the plan on the card and
the wrapper raises when it cannot be scheduled.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

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
                   device="cpu", row_offset: int = 0) -> torch.Tensor:
    """(S, T, D) normals of the kernel's stream: counter (row_offset + s,
    t, d, 0)."""
    _check_offset(row_offset, shape[0])
    s, t, d = (torch.arange(n, dtype=torch.int64, device=device)
               for n in shape)
    s = s + row_offset
    c0 = s[:, None, None].expand(shape)
    c1 = t[None, :, None].expand(shape)
    c2 = d[None, None, :].expand(shape)
    b = philox4x32(c0, c1, c2, torch.zeros_like(c0), seed)
    return bits_to_normal(b[0], b[1], dtype)


def _check_offset(row_offset: int, rows: int):
    """The counter's row word is 32 bits."""
    if row_offset < 0 or row_offset + rows > 2 ** 32:
        raise ValueError(f"rows {row_offset}..{row_offset + rows} leave the "
                         "32-bit row counter")


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """A 63-bit Philox key from the caller's generator (or torch's default)."""
    device = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator,
                             device=device, dtype=torch.int64))


# ---------------------------------------------------------------------------
# Shared preparation and the plain version
# ---------------------------------------------------------------------------

def _exp(t: torch.Tensor, batched: bool) -> torch.Tensor:
    """exp, per sample when ``batched``: a vectorised CPU loop may round a
    sample's entries otherwise than the same entries of a shared (unbatched)
    tensor, and per-sample parameters equal to shared ones must give the
    shared result bit for bit."""
    return torch.stack([torch.exp(v) for v in t]) if batched else torch.exp(t)


def _prepare(kparams: KernelParams, z, lm_inv, q_sqrt, batched=False):
    """The kernel's inputs: Z/ℓ (D, M, Din), 1/ℓ (D, Din), σ² (D,), the
    σ²-folded lower triangle of Lm⁻¹ (as pallas_rollout.py:157 folds it)
    and the upper triangle of q_sqrt (q_sqrt = chol(H)⁻ᵀ is upper).
    ``batched``: every input has a leading sample axis."""
    ils = _exp(-kparams.log_lengthscales, batched)
    zs = z[..., None, :, :] * ils[..., :, None, :]
    kvar = _exp(kparams.log_variance, batched)
    lminv = torch.tril(lm_inv) * kvar[..., :, None, None]
    qsq = None if q_sqrt is None else torch.triu(q_sqrt)
    return zs, ils, kvar, lminv, qsq


def _check_inputs(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls,
                  num_samples, noise, batched=False):
    """Shapes, devices and dtypes of a call.  ``batched``: every parameter
    has a leading sample axis of ``num_samples``."""
    lead = (num_samples,) if batched else ()
    m, din = z.shape[-2:]
    d = x0.shape[-1]
    cu = controls.shape[1]
    t_len = controls.shape[0]
    if din != d + cu:
        raise ValueError(f"z has {din} input columns, expected D + U = "
                         f"{d} + {cu}")
    want = {"z": (z, (m, din)), "lm_inv": (lm_inv, (d, m, m)),
            "u_val": (u_val, (m, d)), "q": (q, (d,)), "x0": (x0, (d,))}
    if batched:
        want["log_variance"] = (kparams.log_variance, (d,))
        want["log_lengthscales"] = (kparams.log_lengthscales, (d, din))
    if q_sqrt is not None:
        want["q_sqrt"] = (q_sqrt, (d, m, m))
    want = {k: (t, lead + shape) for k, (t, shape) in want.items()}
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


def _reference_steps(zs, ils, kvar, lminv, qsq, u_val, q, x0, controls,
                     noise):
    """The recursion of the plain version over T, with every parameter
    per sample: zs (S, D, M, Din), ils (S, D, Din), kvar (S, D), lminv and
    qsq (S, D, M, M) or None, u_val (S, M, D), q (S, D), x0 (S, D).  The
    triangular products are elementwise products summed over the last axis,
    so a sample's result does not depend on whether its parameters are
    shared with the others (an expanded view) or its own."""
    s = x0.shape[0]
    x = x0
    xs, vs = [], []
    for t in range(controls.shape[0]):
        xc = torch.cat([x, controls[t][None, :].expand(s, -1)], dim=1)
        diff = zs - (xc[:, None, :] * ils)[:, :, None, :]     # (S, D, M, Din)
        e = torch.exp(-0.5 * torch.sum(diff * diff, dim=-1))  # (S, D, M)
        a = torch.sum(lminv * e[:, :, None, :], dim=-1)       # (S, D, M)
        mean = torch.sum(a * u_val.mT, dim=-1)                # (S, D)
        var = kvar - torch.sum(a * a, dim=-1)
        if qsq is not None:
            w = torch.sum(qsq.mT * a[:, :, None, :], dim=-1)  # q_sqrtᵀ a
            var = var + torch.sum(w * w, dim=-1)
        var_tot = torch.clamp(var + q, min=0.0)
        x = (x + mean) + noise[:, t] * torch.sqrt(var_tot)
        xs.append(x)
        vs.append(var_tot)
    return torch.stack(xs, dim=1), torch.stack(vs, dim=1)


def rollout_reference(kparams: KernelParams, z: torch.Tensor,
                      lm_inv: torch.Tensor, u_val: torch.Tensor,
                      q_sqrt: Optional[torch.Tensor], q: torch.Tensor,
                      x0: torch.Tensor, controls: torch.Tensor,
                      num_samples: int, *, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      row_offset: int = 0):
    """Plain PyTorch rollout: a loop over T, batched over S and D.  Same
    signature and arithmetic as ``rollout``.  Returns (xs, var_tot), each
    (S, T, D)."""
    _check_inputs(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls,
                  num_samples, noise)
    s, d = num_samples, x0.shape[0]
    if noise is None:
        noise = philox_normals(draw_seed(generator), (s, controls.shape[0], d),
                               z.dtype, z.device, row_offset)
    shared = _prepare(kparams, z, lm_inv, q_sqrt) + (u_val, q, x0)
    per_sample = [None if t is None else t.expand((s,) + t.shape)
                  for t in shared]
    return _reference_steps(*per_sample, controls, noise)


def rollout_reference_batched(kparams: KernelParams, z: torch.Tensor,
                              lm_inv: torch.Tensor, u_val: torch.Tensor,
                              q_sqrt: Optional[torch.Tensor], q: torch.Tensor,
                              x0: torch.Tensor, controls: torch.Tensor, *,
                              noise: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None,
                              row_offset: int = 0):
    """Plain version of ``rollout_batched``: every parameter has a leading
    sample axis S.  With the same parameters for every sample it equals
    ``rollout_reference`` bit for bit (same arithmetic, same Philox counter
    (s, t, d))."""
    s = x0.shape[0]
    _check_inputs(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls, s,
                  noise, batched=True)
    if noise is None:
        noise = philox_normals(draw_seed(generator),
                               (s, controls.shape[0], x0.shape[1]), z.dtype,
                               z.device, row_offset)
    return _reference_steps(*_prepare(kparams, z, lm_inv, q_sqrt, True),
                            u_val, q, x0, controls, noise)


# ---------------------------------------------------------------------------
# The CUDA kernel: launch plan, packed factors, wrapper
# ---------------------------------------------------------------------------

CLUSTER_MAX = 8      # the portable thread-block cluster size
ROW_THREADS = 4      # threads per factor row (kRowThreads in csrc/rollout.cu)


class RolloutPlan(NamedTuple):
    cluster: int         # C = min(D, 8) CTAs per sample; CTA r owns r, r+C, ...
    dims_per_cta: int    # the most dims one CTA owns, ⌈D / C⌉
    threads: int         # per CTA
    smem_bytes: int      # dynamic shared memory per CTA
    resident: bool       # the owned dims' packed factors in shared memory


def rollout_plan(D: int, M: int, Din: int, itemsize: int, smem_optin: int,
                 max_threads: int = 1024) -> RolloutPlan:
    """How the kernel is launched at these shapes: one cluster of
    C = min(D, 8) CTAs per sample, ROW_THREADS threads per owned inducing
    row (up to ``max_threads``; the kernel loops over the rest), and the
    owned dims' packed σ²Lm⁻¹ and q_sqrtᵀ in shared memory when they fit in
    ``smem_optin`` bytes beside the working arrays, else read from global
    memory.  The sizes mirror ``Layout`` in csrc/rollout.cu."""
    cluster = min(D, CLUSTER_MAX)
    g = -(-D // cluster)
    work = g * M * (Din + 6) + g * (Din + 3) + 2 * D
    factors = 2 * g * (M * (M + 1) // 2)
    resident = (work + factors) * itemsize <= smem_optin
    threads = min(-(-g * M * ROW_THREADS // 32) * 32, max_threads // 32 * 32)
    smem = (work + (factors if resident else 0)) * itemsize
    return RolloutPlan(cluster, g, threads, smem, resident)


def pack_lower_rows(a: torch.Tensor) -> torch.Tensor:
    """(..., M, M) → (..., M(M+1)/2): row m of the lower triangle, entries
    0..m, starting at m(m+1)/2."""
    m = a.shape[-1]
    rows, cols = torch.tril_indices(m, m, device=a.device)
    return a[..., rows, cols].contiguous()


def kernel_inputs(kparams: KernelParams, z, lm_inv, u_val, q_sqrt, q, x0,
                  controls, num_samples: int, batched: bool = False):
    """The kernel's input arrays before the noise, in its argument order:
    x0 per sample, Z/ℓ, 1/ℓ, σ², σ²Lm⁻¹ packed by lower rows, U, Q, the
    controls (None when U = 0) and q_sqrtᵀ packed by lower rows (row k is
    column k of the upper q_sqrt) or None.  ``batched``: every input has a
    leading sample axis and the arrays keep it (``sample_strides``)."""
    zs, ils, kvar, lminv, qsq = _prepare(kparams, z, lm_inv, q_sqrt, batched)
    if not batched:
        x0 = x0[None, :].expand(num_samples, x0.shape[0])
    return {
        "x0": x0.contiguous(),
        "zs": zs.contiguous(), "ils": ils.contiguous(),
        "kvar": kvar.contiguous(), "lp": pack_lower_rows(lminv),
        "u_val": u_val.contiguous(), "q": q.contiguous(),
        "controls": controls if controls.shape[1] > 0 else None,
        "qp": None if qsq is None else pack_lower_rows(qsq.mT),
    }


# The kernel's parameter arrays that may be per sample, in the order of its
# stride arguments.
STRIDED = ("zs", "ils", "kvar", "lp", "u_val", "q", "qp")


def sample_strides(args: dict, batched: bool) -> Tuple[int, ...]:
    """Elements between two samples' slices of each ``STRIDED`` array: the
    size of one slice when ``batched``, else 0 (one set for all samples).
    The kernel takes them as 32-bit unsigned integers."""
    strides = tuple(args[k][0].numel() if batched and args[k] is not None
                    else 0 for k in STRIDED)
    if max(strides) >= 2 ** 32:
        raise ValueError(f"a per-sample slice of {max(strides)} elements "
                         "exceeds the kernel's 32-bit stride")
    return strides


_ptr = ctypes.c_void_p
_lib = None
_limits = {}
_LAUNCH_ERRORS = {
    -1: "the plan's block size is not a warp multiple or exceeds the "
        "kernel's limit",
    -2: "the plan's shared memory is below the kernel's layout or above the "
        "opt-in",
    -3: "the plan's cluster shape is invalid for D or cannot be scheduled",
}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ffvd_tpu_torch.utils.cuda_build import load
        lib = load("rollout")
        for fn in (lib.ffvd_rollout_f32, lib.ffvd_rollout_f64):
            fn.argtypes = ([_ptr] * 12 + [ctypes.c_int] * 10
                           + [ctypes.c_uint] * len(STRIDED)
                           + [ctypes.c_uint64, ctypes.c_uint, _ptr])
            fn.restype = ctypes.c_int
        lib.ffvd_rollout_limits.argtypes = [ctypes.c_int, _ptr, _ptr]
        lib.ffvd_rollout_limits.restype = ctypes.c_int
        lib.ffvd_normals.argtypes = [ctypes.c_uint64, _ptr, ctypes.c_longlong,
                                     _ptr]
        lib.ffvd_normals.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_limits(device, itemsize: int) -> Tuple[int, int]:
    """(max_threads, smem_optin) of the kernel on ``device`` for float32
    (itemsize 4) or float64 (8), looked up once per device."""
    device = torch.device(device)
    with torch.cuda.device(device):
        key = (torch.cuda.current_device(), itemsize)
        if key not in _limits:
            threads, optin = ctypes.c_int(), ctypes.c_int()
            err = _library().ffvd_rollout_limits(
                itemsize, ctypes.addressof(threads), ctypes.addressof(optin))
            if err != 0:
                raise RuntimeError(f"rollout kernel limits: CUDA error {err}")
            _limits[key] = (threads.value, optin.value)
    return _limits[key]


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
            generator: Optional[torch.Generator] = None, row_offset: int = 0):
    """S = ``num_samples`` rollouts of T = controls.shape[0] steps from x0.

    kparams: SE-ARD hypers (D,), (D, Din); z (M, Din); lm_inv (D, M, M)
    lower triangular; u_val (M, D); q_sqrt (D, M, M) upper triangular or
    None; q (D,); x0 (D,); controls (T, U), U may be 0; noise (S, T, D) or
    None; ``row_offset``: the rows' place in a larger batch (the drawn
    noise's counter).  Returns (xs, var_tot), each (S, T, D), var_tot
    clamped at 0.
    CUDA tensors launch the kernel (float32 or float64) as ``rollout_plan``
    says, and record the plan in ``rollout.last_plan`` and (rows, plan) in
    ``rollout.log``; CPU tensors run
    ``rollout_reference``."""
    if z.device.type == "cpu":
        return rollout_reference(kparams, z, lm_inv, u_val, q_sqrt, q, x0,
                                 controls, num_samples, noise=noise,
                                 generator=generator, row_offset=row_offset)
    _check_device(z)
    _check_inputs(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls,
                  num_samples, noise)
    return _launch(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls,
                   num_samples, noise, generator, row_offset, batched=False)


def rollout_batched(kparams: KernelParams, z: torch.Tensor,
                    lm_inv: torch.Tensor, u_val: torch.Tensor,
                    q_sqrt: Optional[torch.Tensor], q: torch.Tensor,
                    x0: torch.Tensor, controls: torch.Tensor, *,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    row_offset: int = 0):
    """``rollout`` with its own parameters for each of S samples (a thinned
    SG-HMC posterior): kparams (S, D), (S, D, Din); z (S, M, Din); lm_inv
    and q_sqrt (S, D, M, M); u_val (S, M, D); q (S, D); x0 (S, D); controls
    (T, U) shared.  One kernel launch for all S on CUDA tensors (counted in
    ``rollout.launches``); ``rollout_reference_batched`` on CPU tensors."""
    if z.device.type == "cpu":
        return rollout_reference_batched(kparams, z, lm_inv, u_val, q_sqrt, q,
                                         x0, controls, noise=noise,
                                         generator=generator,
                                         row_offset=row_offset)
    _check_device(z)
    s = x0.shape[0]
    _check_inputs(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls, s,
                  noise, batched=True)
    return _launch(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls, s,
                   noise, generator, row_offset, batched=True)


def _check_device(z: torch.Tensor):
    if z.device.type != "cuda":
        raise ValueError(f"rollout runs on cuda or cpu, not {z.device}")
    if z.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rollout kernel takes float32/float64, not {z.dtype}")


def _launch(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls, s, noise,
            generator, row_offset, batched):
    """One launch of the kernel for S samples, shared or per-sample inputs
    (checked by the caller).  Raises when the launch fails."""
    dtype, device = z.dtype, z.device
    d, m = x0.shape[-1], z.shape[-2]
    t_len, cu = controls.shape
    itemsize = z.element_size()
    max_threads, smem_optin = kernel_limits(device, itemsize)
    plan = rollout_plan(d, m, d + cu, itemsize, smem_optin, max_threads)
    _check_offset(row_offset, s)
    seed = draw_seed(generator) if noise is None else 0
    args = kernel_inputs(kparams, z, lm_inv, u_val, q_sqrt, q, x0, controls,
                         s, batched)
    strides = sample_strides(args, batched)
    args["noise"] = noise
    xs = torch.empty((s, t_len, d), dtype=dtype, device=device)
    vs = torch.empty_like(xs)
    ptrs = [_kernel_arg(k, v) for k, v in args.items()]
    lib = _library()
    fn = lib.ffvd_rollout_f32 if dtype == torch.float32 else lib.ffvd_rollout_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, xs.data_ptr(), vs.data_ptr(), s, t_len, d, m, cu,
                 plan.cluster, plan.dims_per_cta, plan.threads,
                 plan.smem_bytes, int(plan.resident), *strides, seed,
                 row_offset, stream)
    if err != 0:
        raise RuntimeError(f"rollout kernel launch failed ({plan}): "
                           + _LAUNCH_ERRORS.get(err, f"CUDA error {err}"))
    rollout.launches += 1
    rollout.last_plan = plan
    rollout.log.append((s, plan))
    return xs, vs


rollout.launches = 0
rollout.last_plan = None
# (rows, plan) of the latest launches; a caller clears it to watch a path.
rollout.log = collections.deque(maxlen=64)


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
