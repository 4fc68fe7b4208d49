#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ffvd_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ffvd_tpu_torch/csrc`` and then, in phases
that each print one JSON line:

1. device and build: the card, its power limit, the build's seconds;
2. the rollout kernel against its plain PyTorch version at the main shapes
   (ballbeam warm start and its collapsed q(U): S=10, T=500, D=4, M=100,
   Din=5), with and without q_sqrt, fp64 and fp32, shared noise and zero
   noise;
3. the in-kernel generator: moments of 2²⁰ draws, and the standardised
   step-1 residuals of a 65,536-sample rollout;
4. the main path in fp32: ``FFVDModel(FFVDConfig("ballbeam", case=4))`` on
   cuda, ``fit()`` for the protocol's 4000 iterations, ``evaluate()``;
5. 200 fp64 training iterations on cuda against the same on the CPU;
6. kernel timing with CUDA events, and one ``{"kernels": [...]}`` line.

The last lines are the card's name and power limit, the kernels line, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.  Without
a CUDA device, or without the package beside it, it exits non-zero and
prints no result.  A report of every phase goes to
``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPORT = {}

# Main-path shapes and protocol (ffvd_tpu_torch/config.py defaults).
S, T, HORIZON = 10, 500, 30
ANCHOR_NLL = -2.410755          # ballbeam C4 warm-start nll (fp64, golden)
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; FLOP/s for
# fp32 outside the tensor cores (TF32 would lose precision), and for fp64
# on the tensor cores (DMMA runs in full fp64).  ≈88% of the rollout's work
# is its triangular products, an (M×M)·(M×S) product per step, which DMMA
# can compute, so 67 TFLOP/s is the least-time rate for fp64 too.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "fp64": 67e12}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    REPORT[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line(torch):
    """`name, power.limit` as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def main_shape_inputs(torch, dtype):
    """Rollout inputs of the main path at the ballbeam warm start: the
    collapsed q(U) mean and factor, Lm⁻¹, and the 500 test controls."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.eval.rollout import u_and_qsqrt
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.conditionals import kernel_precal
    from ffvd_tpu_torch.model.params import (SSMData,
                                             init_params_from_warmstart)
    dev = torch.device("cuda")
    ds = create_dataset("ballbeam")
    params = init_params_from_warmstart(load_warmstart("ballbeam"),
                                        device=dev, dtype=torch.float64)
    data = SSMData(y=torch.as_tensor(ds.y_train, device=dev),
                   control=torch.as_tensor(ds.control, device=dev))
    trainer = Trainer(FFVDConfig(), data)
    with torch.no_grad():
        pre = kernel_precal("SquaredExponential", params.kernel, params.z)
        u_val, q_sqrt = u_and_qsqrt(trainer, params, data, pre)
    n = ds.n_train
    inp = dict(kparams=params.kernel, z=params.z, lm_inv=pre.lm_inv,
               u_val=u_val, q_sqrt=q_sqrt, q=params.q, x0=params.x[-1],
               controls=data.control[n:n + T])
    from ffvd_tpu_torch.ops.kernels import KernelParams
    cast = lambda t: t.detach().to(dtype).contiguous()
    out = {k: cast(v) for k, v in inp.items() if k != "kparams"}
    out["kparams"] = KernelParams(cast(params.kernel.log_variance),
                                  cast(params.kernel.log_lengthscales))
    return out


def call(fn, inp, q_sqrt=True, **kw):
    return fn(inp["kparams"], inp["z"], inp["lm_inv"], inp["u_val"],
              inp["q_sqrt"] if q_sqrt else None, inp["q"], inp["x0"],
              inp["controls"], kw.pop("num_samples", S), **kw)


def phase_kernel_vs_plain(torch, ro):
    """Phase 2: kernel == plain version on the same inputs and noise."""
    gen = torch.Generator().manual_seed(1234)
    base_noise = torch.randn((S, T, 4), generator=gen, dtype=torch.float64)
    cases = []
    worst = {"fp32": 0.0, "fp32_all_t": 0.0, "fp64": 0.0}
    for name, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        inp = main_shape_inputs(torch, dtype)
        for with_q in (True, False):
            for noise_kind in ("shared", "zero"):
                noise = (base_noise if noise_kind == "shared"
                         else torch.zeros_like(base_noise))
                noise = noise.to("cuda", dtype)
                xk, vk = call(ro.rollout, inp, with_q, noise=noise)
                xr, vr = call(ro.rollout_reference, inp, with_q, noise=noise)
                torch.cuda.synchronize()
                err_all = max(float((xk - xr).abs().max()),
                              float((vk - vr).abs().max()))
                if name == "fp64":
                    # fp64: the two differ only in summation order.
                    ok = (torch.allclose(xk, xr, rtol=1e-9, atol=1e-12)
                          and torch.allclose(vk, vr, rtol=1e-9, atol=1e-12))
                    worst["fp64"] = max(worst["fp64"], err_all)
                    err = err_all
                else:
                    # fp32 over the metric horizon; a free-running fp32
                    # recursion may drift further out, so all-T is printed.
                    h = slice(0, HORIZON)
                    ok = (torch.allclose(xk[:, h], xr[:, h], rtol=1e-4,
                                         atol=1e-5)
                          and torch.allclose(vk[:, h], vr[:, h], rtol=1e-4,
                                             atol=1e-5))
                    err = max(float((xk[:, h] - xr[:, h]).abs().max()),
                              float((vk[:, h] - vr[:, h]).abs().max()))
                    worst["fp32"] = max(worst["fp32"], err)
                    worst["fp32_all_t"] = max(worst["fp32_all_t"], err_all)
                finite = bool(torch.isfinite(xk).all()
                              and torch.isfinite(vk).all())
                cases.append({"dtype": name, "q_sqrt": with_q,
                              "noise": noise_kind, "max_abs_err": err,
                              "max_abs_err_all_t": err_all, "ok": ok,
                              "finite": finite})
                check(ok and finite, f"kernel vs plain: {cases[-1]}")
    emit("kernel_vs_plain", shapes={"S": S, "T": T, "D": 4, "M": 100,
                                    "Din": 5},
         tolerance={"fp64": "rtol 1e-9, atol 1e-12, all T",
                    "fp32": "rtol 1e-4, atol 1e-5, first 30 steps"},
         note="fp32 all-T error is printed: a free-running fp32 recursion "
              "may drift over 500 steps",
         cases=cases, worst=worst)
    return worst


def _moments(z):
    z = z.double()
    return {"mean": float(z.mean()), "std": float(z.std()),
            "p_abs_gt_2": float((z.abs() > 2).double().mean())}


def _check_moments(m, what):
    check(abs(m["mean"]) < 0.01, f"{what}: |mean| {m['mean']}")
    check(abs(m["std"] - 1.0) < 0.01, f"{what}: std {m['std']}")
    check(abs(m["p_abs_gt_2"] / 0.0455 - 1.0) < 0.1,
          f"{what}: P(|z|>2) {m['p_abs_gt_2']}")


def phase_generator(torch, ro):
    """Phase 3: the in-kernel Philox + Box-Muller."""
    seed = 0x5EED_F00D_1234
    n = 1 << 20
    z = ro.ffvd_normals(seed, n)
    ref = ro.philox_normals(seed, (n, 1, 1), torch.float32, "cuda").reshape(-1)
    torch.cuda.synchronize()
    m_direct = _moments(z)
    _check_moments(m_direct, "ffvd_normals")
    stream_err = float((z - ref).abs().max())
    check(stream_err < 1e-4, f"ffvd_normals vs plain Philox: {stream_err}")

    inp = main_shape_inputs(torch, torch.float32)
    inp["controls"] = inp["controls"][:1].contiguous()
    big = 65536
    gen = torch.Generator().manual_seed(99)
    xn, vn = call(ro.rollout, inp, num_samples=big, generator=gen)
    x0, _ = call(ro.rollout, inp, num_samples=big,
                 noise=torch.zeros((big, 1, 4), device="cuda"))
    # The same generator state gives the same Philox key to the plain
    # version: its trajectories must match the kernel's.
    gen = torch.Generator().manual_seed(99)
    xr, _ = call(ro.rollout_reference, inp, num_samples=big, generator=gen)
    torch.cuda.synchronize()
    resid = ((xn - x0) / torch.sqrt(vn)).reshape(-1)
    m_roll = _moments(resid)
    _check_moments(m_roll, "rollout residuals")
    roll_err = float((xn - xr).abs().max())
    check(roll_err < 1e-4, f"in-kernel noise vs plain Philox: {roll_err}")
    emit("generator", draws=n, moments=m_direct,
         max_abs_err_vs_plain_philox=stream_err,
         rollout={"samples": big, "moments": m_roll,
                  "max_abs_err_vs_plain_philox": roll_err},
         checks="|mean|<0.01, std within 1%, P(|z|>2) within 10% of 4.55%")


def phase_main_path(torch, ro, card):
    """Phase 4: train ballbeam C4 and evaluate, fp32, on the card."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    cfg = FFVDConfig(dataset="ballbeam", case=4)
    budget_s = 420.0                 # leaves room in the run's time limit
    ro.rollout.launches = 0          # the main path starts here
    model = FFVDModel(cfg, device="cuda")
    check(model.dtype == torch.float32, f"main path dtype {model.dtype}")
    torch.cuda.synchronize()
    t0 = time.time()
    done = 0
    while done < cfg.total_iterations and time.time() - t0 < budget_s:
        model.fit(500)
        done += 500
    nll = model.nll_trace.cpu()      # synchronises
    train_s = time.time() - t0
    launches_after_fit = ro.rollout.launches
    t1 = time.time()
    res = model.evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.time() - t1) * 1e3
    launches = ro.rollout.launches
    nll0, nll_last = float(nll[0]), float(nll[-1])
    emit("main_path", card=card, dataset="ballbeam", case="C4",
         precision="fp32", iterations=int(nll.numel()),
         protocol_iterations=cfg.total_iterations,
         train_seconds=train_s, train_it_per_s=nll.numel() / train_s,
         eval_ms=eval_ms, rmse=res["rmse"], nll=res["nll"],
         nll_first=nll0, nll_last=nll_last,
         rollout_launches_fit=launches_after_fit,
         rollout_launches_evaluate=launches - launches_after_fit)
    check(abs(nll0 / ANCHOR_NLL - 1.0) < 2e-4,
          f"nll[0]={nll0} vs anchor {ANCHOR_NLL}")
    check(bool(torch.isfinite(nll).all()), "non-finite nll in the trace")
    check(nll_last < nll0, f"nll did not decrease: {nll0} -> {nll_last}")
    check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
          f"non-finite RMSE/NLL {res['rmse']}/{res['nll']}")
    check(launches_after_fit == 0 and launches == 1,
          f"rollout launches: {launches_after_fit} in fit, {launches} total")
    return launches


def phase_fp64_train(torch):
    """Phase 5: 200 fp64 iterations, cuda against cpu, within rtol 1e-8."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    cfg = FFVDConfig(dataset="ballbeam", case=4)
    traces = {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        m = FFVDModel(cfg, device=dev, dtype=torch.float64).fit(200)
        traces[dev] = m.nll_trace.cpu()
        traces[dev + "_s"] = time.time() - t0
    rel = float(((traces["cuda"] - traces["cpu"]).abs()
                 / traces["cpu"].abs()).max())
    emit("fp64_train", iterations=200, max_rel_diff=rel,
         seconds_cuda=traces["cuda_s"], seconds_cpu=traces["cpu_s"],
         nll_first=float(traces["cuda"][0]), nll_last=float(traces["cuda"][-1]))
    check(torch.allclose(traces["cuda"], traces["cpu"], rtol=1e-8, atol=0),
          f"fp64 cuda vs cpu traces differ: max rel {rel}")


def _bound(dtype_name, s, t, d, m, din, cu, itemsize, with_noise_input):
    """Least time for the rollout's work at these shapes: the larger of its
    compulsory bytes over HBM bandwidth and its operations over the peak
    rate.  Lm⁻¹ and q_sqrt are triangular, so only their triangles count."""
    tri = d * m * (m + 1) // 2
    per_step = (d * m * (4 * din + 2)      # e: scaled diffs, squares, exp
                + 2 * 2 * tri              # a = σ²Lm⁻¹e, q_sqrtᵀa (FMAs)
                + d * m * 3                # a·U, a², (q_sqrtᵀa)²
                + 3 * d * m                # three reductions over M
                + 8 * d)                   # var, clamp, sqrt, x update
    flops = s * t * per_step
    elems_in = (s * d + d * m * din + d * din + d + 2 * tri + m * d + d
                + t * cu + (s * t * d if with_noise_input else 0))
    elems_out = 2 * s * t * d
    nbytes = (elems_in + elems_out) * itemsize
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_timing(torch, ro):
    """Phase 6: kernel and plain-version times at the main shapes."""
    out = {}
    gen = torch.Generator().manual_seed(7)
    for name, dtype in (("fp32", torch.float32), ("fp64", torch.float64)):
        inp = main_shape_inputs(torch, dtype)
        launches = ro.rollout.launches
        k_ms = _time_ms(torch, lambda: call(ro.rollout, inp, generator=gen),
                        200)
        p_ms = _time_ms(torch, lambda: call(ro.rollout_reference, inp,
                                            generator=gen), 5)
        ro.rollout.launches = launches   # timing launches are not the path's
        itemsize = 4 if dtype == torch.float32 else 8
        bound_ms, bound_by, flops, nbytes = _bound(
            name, S, T, 4, 100, 5, 1, itemsize, with_noise_input=False)
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                     "bound_us": bound_ms * 1e3, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                     "kernel_launches_timed": 200}
    emit("timing", shapes={"S": S, "T": T, "D": 4, "M": 100, "Din": 5},
         noise="in-kernel Philox", library="no single PyTorch call computes "
         "this rollout; library_ms is null", **out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    try:
        from ffvd_tpu_torch.ops import rollout as ro
        from ffvd_tpu_torch.utils import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the ffvd_tpu_torch package is missing beside "
              f"this script ({exc})", file=sys.stderr)
        return 2
    from ffvd_tpu_torch.utils.device import resolve_device
    resolve_device("cuda")           # TF32 off, as every entry point sets it

    card = card_line(torch)
    t0 = time.time()
    logs = cuda_build.build(["rollout"])
    build_s = time.time() - t0
    print(logs["rollout"], file=sys.stderr)
    emit("device_build", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kernels=["rollout"], build_seconds=build_s,
         ptxas=[ln.strip() for ln in logs["rollout"].splitlines()
                if "registers" in ln or "spill" in ln])

    worst = phase_kernel_vs_plain(torch, ro)
    phase_generator(torch, ro)
    launches = phase_main_path(torch, ro, card)
    phase_fp64_train(torch)
    timing = phase_timing(torch, ro)

    f32, f64 = timing["fp32"], timing["fp64"]
    kernels = {"kernels": [{
        "name": "rollout", "route": "cuda",
        "source": "ffvd_tpu_torch/csrc/rollout.cu",
        "replaces": "ffvd_tpu/ops/pallas_rollout.py:82",
        "launches": launches, "max_abs_err": worst["fp32"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None,
        "fp64": {"ms": f64["ms"], "plain_ms": f64["plain_ms"],
                 "bound_ms": f64["bound_ms"], "bound_by": f64["bound_by"],
                 "max_abs_err": worst["fp64"]},
    }]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps({**REPORT, **kernels}, indent=1))
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
