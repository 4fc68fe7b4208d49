#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ffvd_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ffvd_tpu_torch/csrc`` and then, in phases
that each print one JSON line:

1. device and build: the card, its power limit, the build's seconds;
2. the rollout kernel against its plain PyTorch version at the main shapes
   (ballbeam warm start and its collapsed q(U): S=10, T=500, D=4, M=100,
   Din=5), with and without q_sqrt, fp64 and fp32, shared noise and zero
   noise; then, on random inputs with shared noise, the launch plan's other
   branches: factors read from global memory (fp64, M=320; fp32, M=512)
   and a cluster of six CTAs (D=6);
2b. the kernel with per-sample inputs (``rollout_batched``, S=10 parameter
   sets perturbed from the warm start) against its plain version, with and
   without q_sqrt, fp64 and fp32, resident and global (fp64, M=320; fp32,
   M=512), and fp32 at the 80 and 40 rows that phase 4i launches; and the
   Philox ``row_offset``: an offset launch (shared S=10 as 4 + 6,
   per-sample S=80 as 40 + 40) is bit for bit the rows of the whole launch
   and equals the plain version with the same offset, fp64 and fp32;
3. the in-kernel generator: moments of 2²⁰ draws, and the standardised
   step-1 residuals of a 65,536-sample rollout (with the phase's seconds);
4. the main path in fp32: ``FFVDModel(FFVDConfig("ballbeam", case=4))`` on
   cuda, ``fit()`` for the protocol's 4000 iterations, ``evaluate()``;
4b. the SG-HMC paths in fp32: ballbeam C5 for 100 iterations and C2 for
   20, each then ``evaluate()`` (thinning, per-sample q(U), one launch),
   with the evaluation split into its stages;
4c. the particle-Gibbs path in fp32: ballbeam C6 (P=100) for 20
   iterations and ``evaluate()``, the sweep timed and split, one sweep's
   mixing statistics, and one sweep's recursion and backtrack run under
   ``torch.cuda.set_sync_debug_mode("error")``;
4d. the LinearK path in fp32: ballbeam C4 with ``kernel_type="LinearK"``
   for 20 iterations and ``evaluate()`` (the torch recursion, no kernel);
4e. the deep path in fp32: flutter C4 with ``n_layers=2`` (one hidden
   layer of the head's shapes) for 500 iterations and ``evaluate()`` (the
   deep torch recursion, no kernel);
4f. the window path in fp32: the kink benchmark at N=5000 from a cold
   start, C4 with ``minibatch_size=256`` for 200 iterations, the full
   objective before and after, 20 full-batch iterations for comparison,
   ``evaluate()`` (the kernel at T=5000 without controls, one launch), and
   the kernel against its plain version at those shapes;
4g. the hybrid precision path in fp32: ballbeam C4 with
   ``collapse_precision="hybrid"``, ``fit(1000)`` (500 native iterations,
   then 500 on the float64 collapsed segment), each half timed, and
   ``evaluate()`` (one launch, its Lm⁻¹ held against ``ds_precal``'s);
4h. ensemble pooling in fp32: ``fit_ensemble`` of two ballbeam C4 chains
   (``init_jitter=1e-3``, 200 iterations each), ``ensemble_evaluate``;
5. 200 fp64 training iterations on cuda against the same on the CPU;
5b. 5 fp64 C5 iterations with injected sampler draws, cuda against CPU;
5c. 3 fp64 C6 iterations with injected sweep draws, cuda against CPU, and
   one sweep's resampling indices on both;
5d. 3 fp64 deep C4 iterations with injected inter-layer normals, and the
   deep rollout with injected noise, cuda against CPU;
4i. the chain axis in fp32: ballbeam C4 as 8 chains of one
   ``MultiChainTrainer`` for 500 iterations (aggregate chain-iterations/s
   beside phase 4's single-chain rate, split-R̂ over the tail), its 8×10
   ``multichain_moments`` rollouts in one launch, kernels and host syncs
   of 8 chains against one; C5 as 4 chains for 20 iterations, thinned on
   the batched gradient, 4×10 rows in one per-sample launch;
4j. BASELINE config 5 in fp32: all six datasets at M=512 in one
   ``MultiDatasetTrainer`` step, 200 warm-up and 200 timed iterations,
   kernels, host syncs and device time by kernel class an iteration, then
   ``evaluate()``: six launches on the global-memory plan;
5e. the float64 collapsed segment, cuda against CPU: ``ds_collapsed_terms``
   at the ballbeam warm start in fp32 (values and gradients), and 3 ds64
   C4 iterations with fp64 leaves;
5f. chains in fp64, cuda against CPU: 3 chains of C4 for 20 iterations, 2
   of C5 for 3 with injected draws; a checkpoint resume on the card (C5
   fp32, the CUDA generator restored) bit-equal to the uninterrupted run;
7. the mesh half of ``parallel/`` across processes (``phase_mesh``): 7a
   NCCL at world size 1, mesh (1, 1), 8 C4 chains fp32, bit-equal to one
   process; 7b gloo, 4 ranks sharing the card, dp=2 × ep=2: C4 and C5
   chains in fp64 against one process, the chains' moments in 2 launches
   of 40 rows against one of 80, 200 fp32 iterations timed, six datasets ×
   M=512 and their ``evaluate()``; 7c gloo, 4 ranks, sp=4: kink N=5000 C4
   in fp64 against one process, fp32 timed; 7d the same on NCCL over 4
   cards, or ``{"phase": "7d", "ran": false, "cards": n}``;
6. kernel timing with CUDA events at S=10 and S=64, shared and per-sample
   inputs, with the launch plan; fp32 at 80 per-sample rows and at M=512
   (global plan); and one ``{"kernels": [...]}`` line.

The last lines are the card's name and power limit, the kernels line, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.  Without
a CUDA device, or without the package beside it, it exits non-zero and
prints no result.  A report of every phase goes to
``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPORT = {}

# Main-path shapes and protocol (ffvd_tpu_torch/config.py defaults).
S, T, HORIZON = 10, 500, 30
ANCHOR_NLL = -2.410755          # ballbeam C4 warm-start nll (fp64, golden)
# Phase 4i's depth, short enough to leave the script's time to later phases.
CHAIN_ITERATIONS = 500
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


def random_inputs(torch, dtype, d, m, t_len, seed=0):
    """Rollout inputs at other shapes than the main path's, from a seed:
    SE-ARD hypers, Z, Lm⁻¹ (jitter 1e-2 keeps it well conditioned), U, an
    upper q_sqrt, Q, x0 and one control column."""
    from ffvd_tpu_torch.model.conditionals import kernel_precal
    from ffvd_tpu_torch.ops.kernels import KernelParams
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *sh: torch.randn(*sh, generator=g, dtype=torch.float64)
    uni = lambda *sh: torch.rand(*sh, generator=g, dtype=torch.float64)
    kp = KernelParams(torch.log(uni(d) + 0.2), torch.log(uni(d, d + 1) + 0.5))
    z = rnd(m, d + 1)
    pre = kernel_precal("SquaredExponential", kp, z, jitter=1e-2)
    inp = dict(z=z, lm_inv=pre.lm_inv, u_val=0.3 * rnd(m, d),
               q_sqrt=torch.triu(0.1 * rnd(d, m, m)),
               q=0.05 + 0.1 * uni(d), x0=0.5 * rnd(d),
               controls=rnd(t_len, 1))
    cast = lambda t: t.to("cuda", dtype).contiguous()
    out = {k: cast(v) for k, v in inp.items()}
    out["kparams"] = KernelParams(cast(kp.log_variance),
                                  cast(kp.log_lengthscales))
    return out


def per_sample_inputs(torch, inp, s, seed=0):
    """S distinct parameter sets from one: the kernel hypers, U and x0
    perturbed from a seed per sample, each sample's Lm⁻¹ recomputed from
    its hypers (jitter 1e-5 at the main shapes, as the model uses; 1e-2 on
    random inputs, as ``random_inputs`` does); Z, q_sqrt and Q copied."""
    from ffvd_tpu_torch.model.conditionals import kernel_precal
    from ffvd_tpu_torch.ops.kernels import KernelParams
    g = torch.Generator().manual_seed(seed)
    dtype = inp["z"].dtype
    f64 = lambda t: t.detach().cpu().double()
    jig = lambda t, sd: t + sd * torch.randn(t.shape, generator=g,
                                             dtype=torch.float64)
    jitter = 1e-5 if inp["z"].shape[0] == 100 else 1e-2
    rows = []
    for _ in range(s):
        kp = KernelParams(jig(f64(inp["kparams"].log_variance), 0.05),
                          jig(f64(inp["kparams"].log_lengthscales), 0.02))
        z = f64(inp["z"])
        lm_inv = kernel_precal("SquaredExponential", kp, z, jitter).lm_inv
        rows.append((kp.log_variance, kp.log_lengthscales, z, lm_inv,
                     jig(f64(inp["u_val"]), 0.02), f64(inp["q_sqrt"]),
                     f64(inp["q"]), jig(f64(inp["x0"]), 0.05)))
    cols = [torch.stack(c).to("cuda", dtype).contiguous() for c in zip(*rows)]
    lv, ls, z, lm_inv, u, q_sqrt, q, x0 = cols
    return dict(kparams=KernelParams(lv, ls), z=z, lm_inv=lm_inv, u_val=u,
                q_sqrt=q_sqrt, q=q, x0=x0, controls=inp["controls"])


def call_batched(fn, inp, q_sqrt=True, **kw):
    return fn(inp["kparams"], inp["z"], inp["lm_inv"], inp["u_val"],
              inp["q_sqrt"] if q_sqrt else None, inp["q"], inp["x0"],
              inp["controls"], **kw)


def phase_per_sample_vs_plain(torch, ro):
    """Phase 2b: the kernel with per-sample inputs (one launch of S
    parameter sets) against ``rollout_reference_batched`` on the same
    inputs and noise: at the main shapes (resident, S=10), with and without
    q_sqrt, fp64 over all T and fp32 over the first 30 steps; on the global
    path (fp64, M=320; fp32, M=512); and fp32 at the main shapes with the
    rows of phase 4i's launches (S=80: 8 chains × 10, more clusters than
    one wave of SMs; S=40: 4 chains × 10)."""
    gen = torch.Generator().manual_seed(4321)
    cases, worst = [], {"fp32": 0.0, "fp32_all_t": 0.0, "fp64": 0.0}
    shapes = [("fp64", torch.float64, None, S),
              ("fp32", torch.float32, None, S),
              ("fp64", torch.float64, 320, S),
              ("fp32", torch.float32, 512, S),
              ("fp32", torch.float32, None, 80),
              ("fp32", torch.float32, None, 40)]
    for name, dtype, m, rows in shapes:
        base = (main_shape_inputs(torch, dtype) if m is None
                else random_inputs(torch, dtype, 4, m, 20))
        inp = per_sample_inputs(torch, base, rows)
        t_len = inp["controls"].shape[0]
        noise = torch.randn((rows, t_len, 4), generator=gen,
                            dtype=torch.float64).to("cuda", dtype)
        for with_q in (True, False):
            before = ro.rollout.launches
            xk, vk = call_batched(ro.rollout_batched, inp, with_q,
                                  noise=noise)
            plan = ro.rollout.last_plan
            launched = ro.rollout.launches - before
            xr, vr = call_batched(ro.rollout_reference_batched, inp, with_q,
                                  noise=noise)
            torch.cuda.synchronize()
            h = t_len if name == "fp64" else HORIZON
            tol = (dict(rtol=1e-9, atol=1e-12) if name == "fp64"
                   else dict(rtol=1e-4, atol=1e-5))
            ok = (torch.allclose(xk[:, :h], xr[:, :h], **tol)
                  and torch.allclose(vk[:, :h], vr[:, :h], **tol)
                  and launched == 1 and plan.resident is (m is None))
            err = max(float((xk[:, :h] - xr[:, :h]).abs().max()),
                      float((vk[:, :h] - vr[:, :h]).abs().max()))
            err_all = max(float((xk - xr).abs().max()),
                          float((vk - vr).abs().max()))
            worst[name] = max(worst[name], err)
            if name == "fp32":
                worst["fp32_all_t"] = max(worst["fp32_all_t"], err_all)
            distinct = not torch.allclose(vk[0], vk[1])
            cases.append({"dtype": name, "M": m or 100, "T": t_len,
                          "S": rows, "q_sqrt": with_q, "steps_held": h,
                          "max_abs_err": err, "max_abs_err_all_t": err_all,
                          "launches": launched, "samples_differ": distinct,
                          "ok": ok, "plan": plan._asdict()})
            check(ok and distinct and bool(torch.isfinite(xk).all()),
                  f"per-sample kernel vs plain: {cases[-1]}")
    offsets = _offset_cases(torch, ro, worst)
    emit("per_sample_vs_plain",
         tolerance={"fp64": "rtol 1e-9, atol 1e-12, all T",
                    "fp32": "rtol 1e-4, atol 1e-5, first 30 steps",
                    "row_offset": "bit-equal to the whole launch's rows"},
         cases=cases, row_offset=offsets, worst=worst)
    return worst


def _offset_cases(torch, ro, worst):
    """The Philox ``row_offset``: rows [r0, r1) launched with
    ``row_offset=r0`` are rows r0..r1 of one launch of all rows, bit for
    bit, and equal the plain version with the same offset; fp64 and fp32,
    shared inputs (S=10 as 4 + 6) and per-sample (S=80 as 40 + 40, the
    launches of ``multichain_moments`` on dp=2)."""
    cases = []
    seeded = lambda: torch.Generator().manual_seed(99)
    for name, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        base = main_shape_inputs(torch, dtype)
        per = per_sample_inputs(torch, base, 80)
        cut = lambda r0, r1: {
            k: (type(v)(v.log_variance[r0:r1], v.log_lengthscales[r0:r1])
                if k == "kparams" else v if k == "controls" else v[r0:r1])
            for k, v in per.items()}
        runs = {
            "shared": (lambda fn, r0, r1: call(
                fn, base, num_samples=r1 - r0, generator=seeded(),
                row_offset=r0), S, [(0, 4), (4, S)]),
            "per_sample": (lambda fn, r0, r1: call_batched(
                fn, cut(r0, r1), generator=seeded(), row_offset=r0), 80,
                [(0, 40), (40, 80)])}
        for kind, (launch, rows, splits) in runs.items():
            xw, vw = launch(ro.rollout_batched if kind == "per_sample"
                            else ro.rollout, 0, rows)
            for r0, r1 in splits:
                before = ro.rollout.launches
                xk, vk = launch(ro.rollout_batched if kind == "per_sample"
                                else ro.rollout, r0, r1)
                launched = ro.rollout.launches - before
                xr, vr = launch(ro.rollout_reference_batched
                                if kind == "per_sample"
                                else ro.rollout_reference, r0, r1)
                torch.cuda.synchronize()
                equal = (torch.equal(xk, xw[r0:r1])
                         and torch.equal(vk, vw[r0:r1]))
                h = xk.shape[1] if name == "fp64" else HORIZON
                tol = (dict(rtol=1e-9, atol=1e-12) if name == "fp64"
                       else dict(rtol=1e-4, atol=1e-5))
                err = max(float((xk[:, :h] - xr[:, :h]).abs().max()),
                          float((vk[:, :h] - vr[:, :h]).abs().max()))
                worst[name] = max(worst[name], err)
                cases.append({"dtype": name, "inputs": kind, "rows": rows,
                              "launched_rows": [r0, r1],
                              "bit_equal_to_whole_launch": equal,
                              "max_abs_err_vs_plain": err,
                              "launches": launched})
                check(equal and launched == 1
                      and torch.allclose(xk[:, :h], xr[:, :h], **tol)
                      and torch.allclose(vk[:, :h], vr[:, :h], **tol),
                      f"row_offset launch: {cases[-1]}")
    return cases


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
                              "finite": finite,
                              "plan": ro.rollout.last_plan._asdict()})
                check(ok and finite, f"kernel vs plain: {cases[-1]}")
    # The plan's other branches, on random inputs with shared noise:
    # global-memory factors (fp64 M=320; fp32 M=512, the six-dataset
    # path's shape) and six CTAs a cluster (D=6).
    other = []
    for name, dtype, d, m, t_len, want in (
            ("fp64", torch.float64, 4, 320, 20, dict(resident=False)),
            ("fp32", torch.float32, 4, 512, 20, dict(resident=False)),
            ("fp64", torch.float64, 6, 100, 60, dict(cluster=6)),
            ("fp32", torch.float32, 6, 100, 60, dict(cluster=6))):
        inp = random_inputs(torch, dtype, d, m, t_len)
        noise = 0.1 * torch.randn((S, t_len, d), generator=gen,
                                  dtype=torch.float64).to("cuda", dtype)
        xk, vk = call(ro.rollout, inp, noise=noise)
        plan = ro.rollout.last_plan
        xr, vr = call(ro.rollout_reference, inp, noise=noise)
        torch.cuda.synchronize()
        h = t_len if name == "fp64" else HORIZON
        tol = (dict(rtol=1e-9, atol=1e-12) if name == "fp64"
               else dict(rtol=1e-4, atol=1e-5))
        ok = (torch.allclose(xk[:, :h], xr[:, :h], **tol)
              and torch.allclose(vk[:, :h], vr[:, :h], **tol)
              and all(getattr(plan, k) == v for k, v in want.items()))
        err = max(float((xk[:, :h] - xr[:, :h]).abs().max()),
                  float((vk[:, :h] - vr[:, :h]).abs().max()))
        worst[name] = max(worst[name], err)
        other.append({"dtype": name, "S": S, "T": t_len, "D": d, "M": m,
                      "Din": d + 1, "steps_held": h, "max_abs_err": err,
                      "ok": ok, "plan": plan._asdict()})
        check(ok and bool(torch.isfinite(xk).all()),
              f"kernel vs plain: {other[-1]}")
    emit("kernel_vs_plain", shapes={"S": S, "T": T, "D": 4, "M": 100,
                                    "Din": 5},
         tolerance={"fp64": "rtol 1e-9, atol 1e-12, all T",
                    "fp32": "rtol 1e-4, atol 1e-5, first 30 steps"},
         note="fp32 all-T error is printed: a free-running fp32 recursion "
              "may drift over 500 steps",
         cases=cases, other_plans=other, worst=worst)
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
    t_phase = time.time()
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
    torch.cuda.synchronize()
    t_big = time.time()
    xn, vn = call(ro.rollout, inp, num_samples=big, generator=gen)
    x0, _ = call(ro.rollout, inp, num_samples=big,
                 noise=torch.zeros((big, 1, 4), device="cuda"))
    torch.cuda.synchronize()
    big_s = time.time() - t_big
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
                  "max_abs_err_vs_plain_philox": roll_err,
                  "plan": ro.rollout.last_plan._asdict(),
                  "two_kernel_rollouts_seconds": big_s},
         seconds=time.time() - t_phase,
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


def _sampler_path(torch, ro, card, case, iterations):
    """Train one SG-HMC case in fp32 on the card and evaluate it, with the
    launch count set to 0 just before and read just after; then split a
    second collection, on the chain evaluate() left, into its stages."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.rollout import (posterior_inputs,
                                             rollout_controls, thin_posterior)
    cfg = FFVDConfig(dataset="ballbeam", case=case)
    ro.rollout.launches = 0          # this path starts here
    model = FFVDModel(cfg, device="cuda")
    check(model.dtype == torch.float32, f"C{case} dtype {model.dtype}")
    sampled = {k: v.detach().clone()
               for k, v in model.trainer.subset.split(model.params).items()}
    torch.cuda.synchronize()
    t0 = time.time()
    model.fit(iterations)
    nll = model.nll_trace.cpu()
    train_s = time.time() - t0
    launches_fit = ro.rollout.launches
    t1 = time.time()
    res = model.evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.time() - t1) * 1e3
    launches_eval = ro.rollout.launches - launches_fit
    moved = {k: float((v - sampled[k]).abs().max())
             for k, v in model.trainer.subset.split(model.params).items()}

    # The same stages as evaluate()'s collection, timed one by one.
    tr = model.trainer
    t2 = time.time()
    samples, _ = thin_posterior(tr, model.state, S,
                                cfg.posterior_sample_spacing,
                                model.train_generator)
    torch.cuda.synchronize()
    t3 = time.time()
    with torch.no_grad():
        inp = posterior_inputs(tr, samples)
    torch.cuda.synchronize()
    t4 = time.time()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    ro.rollout_batched(controls=rollout_controls(tr.data, model.dataset.n_test),
                       generator=model.generator, **inp)
    stop.record()
    torch.cuda.synchronize()
    out = {"card": card, "dataset": "ballbeam",
           "case": cfg.case_config.name,
           "precision": str(model.dtype).replace("torch.float", "fp"),
           "iterations": int(nll.numel()),
           "protocol_iterations": cfg.total_iterations,
           "sampled_leaves": list(moved), "S": S, "T": model.dataset.n_test,
           "spacing": cfg.posterior_sample_spacing,
           "train_seconds": train_s, "train_it_per_s": nll.numel() / train_s,
           "eval_ms": eval_ms,
           "eval_split_ms": {"thinning": (t3 - t2) * 1e3,
                             "q_u_and_factors": (t4 - t3) * 1e3,
                             "kernel_events": start.elapsed_time(stop),
                             "kernel_call_wall": (time.time() - t4) * 1e3},
           "rmse": res["rmse"], "nll": res["nll"],
           "nll_first": float(nll[0]), "nll_last": float(nll[-1]),
           "window_count": model.state.window_count,
           "max_move_from_warm_start": moved,
           "rollout_launches_fit": launches_fit,
           "rollout_launches_evaluate": launches_eval}
    check(bool(torch.isfinite(nll).all()), f"{case}: non-finite nll")
    check(model.state.window_count == min(iterations, cfg.window_size),
          f"C{case}: window_count {model.state.window_count}")
    check(all(v > 0 for v in moved.values()),
          f"C{case}: sampled leaves did not move: {moved}")
    check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
          f"C{case}: non-finite RMSE/NLL {res['rmse']}/{res['nll']}")
    check(launches_fit == 0 and launches_eval == 1,
          f"C{case}: rollout launches {launches_fit} in fit, "
          f"{launches_eval} in evaluate")
    return out


def phase_sampler_paths(torch, ro, card):
    """Phase 4b: the SG-HMC path in fp32 at full width: ballbeam C5 (the
    kernel hypers sampled, collapsed q(U) per thinned sample) for 100
    iterations, the window full after 64; then C2 (hypers and U sampled,
    no q_sqrt) for 20.  Depth is cut from the protocol's 4000 iterations
    to stay inside the run's time limit."""
    t0 = time.time()
    c5 = _sampler_path(torch, ro, card, 5, 100)
    c2 = _sampler_path(torch, ro, card, 2, 20)
    emit("sampler_paths", C5=c5, C2=c2, seconds=time.time() - t0)
    return {"C5": c5, "C2": c2}


def _events_ms(torch, fn):
    """ms of one call of ``fn`` between two CUDA events (the sweep is
    host-bound, so this is its wall time on the stream)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _kernels_in(torch, fn):
    """(device kernels, their summed device ms) of one call of ``fn``, by
    the profiler's CUDA activity; (None, None) when it shows no device
    events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    n = sum(e.count for e in dev)
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) for e in dev)
    return (n, us / 1e3) if n else (None, None)


def phase_pg_path(torch, ro, card):
    """Phase 4c: ballbeam C6 in fp32 on the card at full width (D=4, M=100,
    N=500, P=100): ``fit(20)`` (the protocol runs 4000) and ``evaluate()``,
    with the launch count set to 0 just before and read just after; then
    the sweep timed (median of 7 after a warm-up, CUDA events) and split
    into draws, Kmm factorisation and recursion with backtrack; one
    sweep's statistics; and the recursion and backtrack under
    ``set_sync_debug_mode("error")``, ``kernel_precal`` outside it."""
    import dataclasses
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference import particle_gibbs as pg
    from ffvd_tpu_torch.model.conditionals import kernel_precal
    cfg = FFVDConfig(dataset="ballbeam", case=6)
    iterations = 20
    ro.rollout.launches = 0          # this path starts here
    model = FFVDModel(cfg, device="cuda")
    check(model.dtype == torch.float32, f"C6 dtype {model.dtype}")
    x0 = model.params.x.detach().clone()
    torch.cuda.synchronize()
    t0 = time.time()
    model.fit(iterations)
    nll = model.nll_trace.cpu()
    train_s = time.time() - t0
    launches_fit = ro.rollout.launches
    t1 = time.time()
    res = model.evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.time() - t1) * 1e3
    launches_eval = ro.rollout.launches - launches_fit
    x_moved = float((model.params.x - x0).abs().max())

    params, data, gen = model.params, model.data, model.train_generator
    sweep = model.trainer.pg_fn
    sweep(params, gen, data)                             # warm-up
    sweep_ms = [_events_ms(torch, lambda: sweep(params, gen, data))
                for _ in range(7)]
    t_wall = time.time()
    for _ in range(3):
        sweep(params, gen, data)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t_wall) * 1e3 / 3
    draws = pg.pg_draws(cfg, params, gen)
    precal = lambda: kernel_precal(cfg.kernel_type, params.kernel, params.z,
                                   cfg.jitter)
    pre = precal()
    median5 = lambda fn: statistics.median(_events_ms(torch, fn)
                                           for _ in range(5))
    split = {
        "draws": median5(lambda: pg.pg_draws(cfg, params, gen)),
        "kernel_precal": median5(precal),
        "recursion_and_backtrack": median5(lambda: pg.pg_ancestor_style(
            cfg, params, pre, data, draws)),
    }
    try:
        kernels, device_ms = _kernels_in(torch, lambda: pg.pg_ancestor_style(
            cfg, params, pre, data, draws))
    except Exception as exc:   # the profiler is untried on that machine
        kernels, device_ms = f"profiler failed: {exc!r}", None
    _, stats = pg.make_pg_fn(cfg, data, with_stats=True)(params, gen)
    stats = {k: float(v) for k, v in stats.items()}

    # The recursion and backtrack must not read back to the host (capture
    # in a CUDA graph needs that); kernel_precal's retry check and the
    # draws are outside.
    ref_cfg = dataclasses.replace(cfg, pg_ancestor_trace=False)
    ref_draws = pg.pg_draws(ref_cfg, params, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_x, _, _ = pg.pg_ancestor_style(cfg, params, pre, data, draws)
        ref_x, _, _ = pg.pg_reference_style(ref_cfg, params, pre, data,
                                            ref_draws)
        sync_error = None
    except RuntimeError as exc:
        sync_error = repr(exc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    n = params.n_transitions
    out = {"card": card, "dataset": "ballbeam", "case": "C6",
           "precision": "fp32", "P": cfg.pg_particles, "n": n,
           "iterations": int(nll.numel()),
           "protocol_iterations": cfg.total_iterations,
           "train_seconds": train_s, "train_it_per_s": nll.numel() / train_s,
           "eval_ms": eval_ms, "rmse": res["rmse"], "nll": res["nll"],
           "nll_first": float(nll[0]), "nll_last": float(nll[-1]),
           "x_max_move_from_warm_start": x_moved,
           "sweep_ms_median": statistics.median(sweep_ms),
           "sweep_ms": sweep_ms,
           "sweep_wall_ms": wall_ms, "sweep_split_ms": split,
           "sweep_kernels": kernels,
           "sweep_kernels_per_step": (kernels / n if isinstance(kernels, int)
                                      else None),
           "sweep_device_ms": device_ms,
           "sweep_device_busy": (device_ms / split["recursion_and_backtrack"]
                                 if device_ms else None),
           "stats": stats, "sync_debug_error": sync_error,
           "rollout_launches_fit": launches_fit,
           "rollout_launches_evaluate": launches_eval}
    emit("pg_path", **out)
    check(sync_error is None, f"C6 sweep synchronised: {sync_error}")
    check(bool(torch.isfinite(new_x).all() and torch.isfinite(ref_x).all()),
          "C6 sweep: non-finite x")
    check(bool(torch.isfinite(nll).all()), "C6: non-finite nll")
    check(x_moved > 0, "C6: x did not move from the warm start")
    check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
          f"C6: non-finite RMSE/NLL {res['rmse']}/{res['nll']}")
    check(launches_fit == 0 and launches_eval == 1,
          f"C6: rollout launches {launches_fit} in fit, {launches_eval} in "
          "evaluate")
    return out


def phase_linear_path(torch, ro, card):
    """Phase 4d: ballbeam C4 with the linear kernel, fp32: 20 iterations
    and ``evaluate()``, which rolls out by the torch recursion and launches
    no kernel."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    cfg = FFVDConfig(dataset="ballbeam", case=4, kernel_type="LinearK")
    ro.rollout.launches = 0
    model = FFVDModel(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    model.fit(20)
    nll = model.nll_trace.cpu()
    train_s = time.time() - t0
    t1 = time.time()
    res = model.evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.time() - t1) * 1e3
    launches = ro.rollout.launches
    out = {"card": card, "dataset": "ballbeam", "case": "C4",
           "kernel_type": "LinearK", "precision": "fp32",
           "iterations": int(nll.numel()), "train_seconds": train_s,
           "train_it_per_s": nll.numel() / train_s, "eval_ms": eval_ms,
           "rmse": res["rmse"], "nll": res["nll"],
           "nll_first": float(nll[0]), "nll_last": float(nll[-1]),
           "rollout_launches": launches}
    emit("linear_path", **out)
    check(bool(torch.isfinite(nll).all()), "LinearK: non-finite nll")
    check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
          f"LinearK: non-finite RMSE/NLL {res['rmse']}/{res['nll']}")
    check(launches == 0, f"LinearK: {launches} rollout kernel launches")
    return out


def phase_deep_path(torch, ro, card):
    """Phase 4e: flutter C4 with a deep transition (``n_layers=2``) in fp32
    at full width (D=4, M=100, N=512, Din=5, one hidden layer of the same
    shapes): ``fit(500)`` (the protocol runs 4000) and ``evaluate()``, with
    the launch count set to 0 just before and read just after.  The deep
    rollout is the torch recursion, so no kernel launches.  The training
    nll is doubly stochastic, so its fall is read on the means of the
    first and last 50 iterations."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    cfg = FFVDConfig(dataset="flutter", case=4, n_layers=2)
    iterations = 500
    ro.rollout.launches = 0          # this path starts here
    model = FFVDModel(cfg, device="cuda")
    check(model.dtype == torch.float32, f"deep dtype {model.dtype}")
    check(len(model.params.hidden) == 1, "deep: no hidden layer grafted")
    torch.cuda.synchronize()
    t0 = time.time()
    model.fit(iterations)
    nll = model.nll_trace.cpu()
    train_s = time.time() - t0
    launches_fit = ro.rollout.launches
    t1 = time.time()
    res = model.evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.time() - t1) * 1e3
    launches_eval = ro.rollout.launches - launches_fit
    hidden_u = float(model.params.hidden[0].u.detach().norm())
    first, last = float(nll[:50].mean()), float(nll[-50:].mean())
    out = {"card": card, "dataset": "flutter", "case": "C4", "n_layers": 2,
           "precision": "fp32", "iterations": int(nll.numel()),
           "protocol_iterations": cfg.total_iterations,
           "train_seconds": train_s, "train_it_per_s": nll.numel() / train_s,
           "eval_ms": eval_ms, "T": model.dataset.n_test, "S": S,
           "rmse": res["rmse"], "nll": res["nll"],
           "nll_first": float(nll[0]), "nll_last": float(nll[-1]),
           "nll_mean_first_50": first, "nll_mean_last_50": last,
           "hidden_u_norm": hidden_u,
           "rollout_launches_fit": launches_fit,
           "rollout_launches_evaluate": launches_eval}
    emit("deep_path", **out)
    check(bool(torch.isfinite(nll).all()), "deep: non-finite nll")
    check(last < first, f"deep: nll did not fall: {first} -> {last}")
    check(hidden_u > 0, "deep: the hidden layer's u did not move")
    check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
          f"deep: non-finite RMSE/NLL {res['rmse']}/{res['nll']}")
    check(launches_fit == 0 and launches_eval == 0,
          f"deep: rollout launches {launches_fit} in fit, {launches_eval} "
          "in evaluate")
    return out


def phase_window_path(torch, ro, card):
    """Phase 4f: random-window minibatch training on a long sequence, fp32:
    ``generate_kink(n=5000)`` (N=5000 training transitions, no control)
    from the cold start ``init_params_random(x_dim=4, M=100)``, C4 with
    ``minibatch_size=256``: ``fit(200)`` with the full objective before and
    after, then ``evaluate()`` (full batch; the kernel at T=5000, U=0), the
    launch count set to 0 just before and read just after.  Then, outside
    the count: 20 full-batch iterations of the same start for comparison,
    and the kernel against its plain version on the evaluated model's
    inputs in fp64 over all 5000 steps."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import generate_kink
    from ffvd_tpu_torch.eval.rollout import rollout_controls, u_and_qsqrt
    from ffvd_tpu_torch.model.conditionals import kernel_precal
    from ffvd_tpu_torch.model.elbo import negative_elbo
    from ffvd_tpu_torch.model.params import (GPSSMParams, SSMData,
                                             init_params_random)
    n, w, iterations = 5000, 256, 200
    ds = generate_kink(n=n, seed=0)
    start = lambda: init_params_random(
        n, 4, 100, 0, generator=torch.Generator().manual_seed(0),
        device="cuda", dtype=torch.float32)
    cfg = FFVDConfig(dataset="kink", case=4, minibatch_size=w)

    def full_objective(m):
        with torch.no_grad():
            return float(negative_elbo(m.params, m.data))

    ro.rollout.launches = 0          # this path starts here
    model = FFVDModel(cfg, device="cuda", dataset=ds, params=start())
    check(model.trainer.window_n == w, "window: not windowed")
    before = full_objective(model)
    torch.cuda.synchronize()
    t0 = time.time()
    model.fit(iterations)
    nll = model.nll_trace.cpu()
    train_s = time.time() - t0
    after = full_objective(model)
    launches_fit = ro.rollout.launches
    t1 = time.time()
    res = model.evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.time() - t1) * 1e3
    launches_eval = ro.rollout.launches - launches_fit

    full = FFVDModel(FFVDConfig(dataset="kink", case=4), device="cuda",
                     dataset=ds, params=start())
    check(full.trainer.window_n is None, "window: comparison is windowed")
    torch.cuda.synchronize()
    t2 = time.time()
    full.fit(20)
    full_trace = full.nll_trace.cpu()
    full_s = time.time() - t2

    # The kernel at this path's shapes (S=10, T=5000, D=4, M=100, U=0)
    # against its plain version, fp64, on the trained model's inputs.
    tr = model.trainer
    p64 = GPSSMParams.from_leaves({k: v.detach().double()
                                   for k, v in model.params.leaves().items()})
    data64 = SSMData(y=tr.data.y.double(), control=tr.data.control.double())
    with torch.no_grad():
        pre = kernel_precal(cfg.kernel_type, p64.kernel, p64.z, cfg.jitter)
        u_val, q_sqrt = u_and_qsqrt(tr, p64, data64, pre)
    controls = rollout_controls(data64, ds.n_test)
    noise = torch.randn((S, ds.n_test, 4), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(5)).cuda()
    args = (p64.kernel, p64.z, pre.lm_inv, u_val, q_sqrt, p64.q, p64.x[-1],
            controls, S)
    xk, vk = ro.rollout(*args, noise=noise)
    plan = ro.rollout.last_plan
    xr, vr = ro.rollout_reference(*args, noise=noise)
    torch.cuda.synchronize()
    err = max(float((xk - xr).abs().max()), float((vk - vr).abs().max()))
    kernel_ok = (torch.allclose(xk, xr, rtol=1e-9, atol=1e-12)
                 and torch.allclose(vk, vr, rtol=1e-9, atol=1e-12))

    out = {"card": card, "dataset": "kink", "N": n, "window": w,
           "case": "C4", "precision": "fp32", "iterations": int(nll.numel()),
           "train_seconds": train_s, "train_it_per_s": nll.numel() / train_s,
           "full_objective_before": before, "full_objective_after": after,
           "full_batch_iterations": int(full_trace.numel()),
           "full_batch_seconds": full_s,
           "full_batch_it_per_s": full_trace.numel() / full_s,
           "eval_ms": eval_ms, "T": ds.n_test, "S": S,
           "rmse": res["rmse"], "nll": res["nll"],
           "nll_first": float(nll[0]), "nll_last": float(nll[-1]),
           "rollout_launches_fit": launches_fit,
           "rollout_launches_evaluate": launches_eval,
           "kernel_vs_plain": {"dtype": "fp64", "max_abs_err": err,
                               "tolerance": "rtol 1e-9, atol 1e-12, all T",
                               "ok": kernel_ok, "plan": plan._asdict()}}
    emit("window_path", **out)
    check(bool(torch.isfinite(nll).all()), "window: non-finite nll")
    check(after < before,
          f"window: the full objective did not fall: {before} -> {after}")
    check(bool(torch.isfinite(full_trace).all()),
          "window: non-finite full-batch nll")
    check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
          f"window: non-finite RMSE/NLL {res['rmse']}/{res['nll']}")
    check(launches_fit == 0 and launches_eval == 1,
          f"window: rollout launches {launches_fit} in fit, {launches_eval} "
          "in evaluate")
    check(kernel_ok and bool(torch.isfinite(xk).all()),
          f"window: kernel vs plain at T={ds.n_test}: {err}")
    return out


def _time_runs(torch, trainer, log):
    """Wrap ``trainer.run`` so each call is timed, synchronised, into
    ``log`` as (precision, iterations, seconds)."""
    run = trainer.run

    def timed(state, n, **kw):
        torch.cuda.synchronize()
        t = time.time()
        state, nll = run(state, n, **kw)
        nll.cpu()
        log.append((trainer.train_precision, n, time.time() - t))
        return state, nll
    trainer.run = timed


def _spy_rollout_inputs(er, ro, seen):
    """Route ``eval.rollout``'s kernel calls through a recorder of the
    factors it passes; the real wrapper, and its launch count, run."""
    import types

    def rollout(*args, **kw):
        seen.update(lm_inv=args[2], q_sqrt=args[4])
        return ro.rollout(*args, **kw)
    er.rollout_ops = types.SimpleNamespace(
        rollout=rollout, rollout_batched=ro.rollout_batched)


def phase_hybrid_path(torch, ro, card, native):
    """Phase 4g: ballbeam C4 with ``collapse_precision="hybrid"`` in fp32
    at full width: ``fit(1000)``, the first 500 native and the last 500
    (the default ``hybrid_tail_iters``) on the float64 collapsed segment,
    each half timed; the tail trainer's precision; ``evaluate()`` with the
    launch count set to 0 before the path and read after it, and the Lm⁻¹
    the kernel got held against ``ds_precal``'s.  RMSE beside phase 4's
    native C4."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval import rollout as er
    from ffvd_tpu_torch.model.ds_collapse import ds_precal
    cfg = FFVDConfig(dataset="ballbeam", case=4, collapse_precision="hybrid")
    ro.rollout.launches = 0          # this path starts here
    model = FFVDModel(cfg, device="cuda")
    check(model.dtype == torch.float32, f"hybrid dtype {model.dtype}")
    runs = []
    tail = model._tail_trainer()
    _time_runs(torch, model.trainer, runs)
    _time_runs(torch, tail, runs)
    t0 = time.time()
    model.fit(1000)
    nll = model.nll_trace.cpu()
    train_s = time.time() - t0
    launches_fit = ro.rollout.launches
    seen = {}
    _spy_rollout_inputs(er, ro, seen)
    try:
        t1 = time.time()
        res = model.evaluate()
        torch.cuda.synchronize()
        eval_ms = (time.time() - t1) * 1e3
    finally:
        er.rollout_ops = ro
    launches_eval = ro.rollout.launches - launches_fit
    # A second evaluate() after the counts are read: the first one pays the
    # float64 segment's first-use cost on the card.
    t2 = time.time()
    model.evaluate()
    torch.cuda.synchronize()
    eval2_ms = (time.time() - t2) * 1e3
    p = model.params
    with torch.no_grad():
        want = ds_precal(cfg.kernel_type, p.kernel, p.z, cfg.jitter).lm_inv
    got = seen.get("lm_inv")
    lm_err = (float((got - want).abs().max()) if got is not None
              else float("inf"))
    halves = {prec: {"iterations": n, "seconds": sec, "it_per_s": n / sec}
              for prec, n, sec in runs}
    b = 1000 - cfg.hybrid_tail_iters          # the switch to the tail
    out = {"card": card, "dataset": "ballbeam", "case": "C4",
           "collapse_precision": "hybrid", "precision": "fp32",
           "iterations": int(nll.numel()),
           "hybrid_tail_iters": cfg.hybrid_tail_iters,
           "runs": [list(r) for r in runs], "halves": halves,
           "train_seconds": train_s,
           "tail_trainer_precision": tail.train_precision,
           "eval_trainer_is_tail": model.eval_trainer is tail,
           "nll_first": float(nll[0]), "nll_last_native": float(nll[b - 1]),
           "nll_first_tail": float(nll[b]), "nll_last": float(nll[-1]),
           "eval_ms": eval_ms, "eval_ms_second_call": eval2_ms,
           "rmse": res["rmse"], "nll": res["nll"],
           "native_c4_rmse": native["rmse"],
           "native_c4_iterations": native["iterations"],
           "lm_inv_dtype": str(got.dtype) if got is not None else None,
           "lm_inv_max_abs_diff_vs_ds_precal": lm_err,
           "lm_inv_bitwise_equal": got is not None and torch.equal(got, want),
           "rollout_launches_fit": launches_fit,
           "rollout_launches_evaluate": launches_eval}
    emit("hybrid_path", **out)
    check([r[:2] for r in runs] == [("native", 500), ("ds64", 500)],
          f"hybrid: runs {runs}")
    check(tail.train_precision == "ds64" and model.eval_trainer is tail,
          "hybrid: the tail trainer is not ds64")
    check(bool(torch.isfinite(nll).all()), "hybrid: non-finite nll")
    check(float(nll[-1]) < float(nll[0]), "hybrid: nll did not fall")
    check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
          f"hybrid: non-finite RMSE/NLL {res['rmse']}/{res['nll']}")
    check(launches_fit == 0 and launches_eval == 1,
          f"hybrid: rollout launches {launches_fit} in fit, {launches_eval} "
          "in evaluate")
    check(got is not None and got.dtype == torch.float32
          and lm_err <= 1e-6 * float(want.abs().max()),
          f"hybrid: the kernel's Lm⁻¹ is not ds_precal's ({lm_err})")
    return out


def phase_ensemble_path(torch, ro, card):
    """Phase 4h: ``fit_ensemble`` of two ballbeam C4 chains in fp32
    (seeds 0 and 1, ``init_jitter=1e-3`` on chain 1's warm start), 200
    iterations each, then ``ensemble_evaluate``: one launch a chain, the
    launch count set to 0 before the path and read after it."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.ensemble import ensemble_evaluate, fit_ensemble
    ro.rollout.launches = 0          # this path starts here
    t0 = time.time()
    models = fit_ensemble(FFVDConfig(dataset="ballbeam", case=4), 2,
                          device="cuda", init_jitter=1e-3,
                          num_iterations=200)
    traces = [m.nll_trace.cpu() for m in models]
    train_s = time.time() - t0
    launches_fit = ro.rollout.launches
    t1 = time.time()
    res = ensemble_evaluate(models)
    eval_ms = (time.time() - t1) * 1e3
    launches_eval = ro.rollout.launches - launches_fit
    out = {"card": card, "dataset": "ballbeam", "case": "C4", "chains": 2,
           "init_jitter": 1e-3, "iterations_per_chain": 200,
           "precision": "fp32", "train_seconds": train_s,
           "train_it_per_s": 400 / train_s, "eval_ms": eval_ms,
           "rmse": res["rmse"], "nll": res["nll"],
           "nll_no_spread": res["nll_no_spread"],
           "per_chain": res["per_chain"],
           "nll_last": [float(t[-1]) for t in traces],
           "rollout_launches_fit": launches_fit,
           "rollout_launches_evaluate": launches_eval}
    emit("ensemble_path", **out)
    check(all(bool(torch.isfinite(t).all()) for t in traces),
          "ensemble: non-finite nll")
    check(float(traces[0][0]) != float(traces[1][0]),
          "ensemble: the jitter did not move chain 1")
    check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
          f"ensemble: non-finite RMSE/NLL {res['rmse']}/{res['nll']}")
    check(launches_fit == 0 and launches_eval == 2,
          f"ensemble: rollout launches {launches_fit} in fit, "
          f"{launches_eval} in evaluate (one a chain)")
    return out


def _launch_log(ro):
    """(rows, plan) of every kernel launch since ``rollout.log`` was
    cleared."""
    return [{"rows": r, "plan": p._asdict()} for r, p in ro.rollout.log]


def _cuda_data(torch, name, dtype):
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.model.params import (SSMData,
                                             init_params_from_warmstart)
    ds = create_dataset(name)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    return ds, SSMData(y=as_t(ds.y_train), control=as_t(ds.control)), \
        init_params_from_warmstart(load_warmstart(name), device="cuda",
                                   dtype=dtype)


def _pooled_metrics(chains, ds):
    from ffvd_tpu_torch.eval.ensemble import _metrics, pool_moments
    py, pv = pool_moments(chains)
    rmse, nll = _metrics(py, pv, ds.y_test, ds.y_train_std, HORIZON)
    per = [dict(zip(("rmse", "nll"), _metrics(
        y.mean(axis=0), v.mean(axis=0) + r2, ds.y_test, ds.y_train_std,
        HORIZON))) for y, v, r2 in chains]
    return {"rmse": rmse, "nll": nll, "per_chain": per}


def phase_multichain_path(torch, ro, card, single):
    """Phase 4i: the chain axis in fp32.  Ballbeam C4 as 8 chains of one
    ``MultiChainTrainer`` (warm start perturbed by 1e-3·N(0,1) per chain)
    for 500 iterations, then ``multichain_moments``: all 8×10 rollouts in
    one launch.  Kernels and host syncs of 10 profiled iterations, 8 chains
    against one.  Then C5 as 4 chains for 20 iterations, thinned on the
    batched gradient, and its 4×10 rollouts in one per-sample launch.  The
    launch count is set to 0 before each path and read after it."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.ensemble import multichain_moments
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.parallel import MultiChainTrainer
    from ffvd_tpu_torch.utils.profiling import profile_window, summarize
    ds, data, p0 = _cuda_data(torch, "ballbeam", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = FFVDConfig(dataset="ballbeam", case=4)
    ro.rollout.launches = 0          # this path starts here
    mct = MultiChainTrainer(cfg, data, 8)
    state = mct.init_state(mct.stack_params(p0, gen))
    torch.cuda.synchronize()
    t0 = time.time()
    state, trace = mct.run(state, CHAIN_ITERATIONS, generator=gen)
    trace = trace.cpu()
    train_s = time.time() - t0
    launches_fit = ro.rollout.launches
    t1 = time.time()
    ro.rollout.log.clear()
    chains, state = multichain_moments(
        mct, state, ds.n_test, generator=torch.Generator().manual_seed(1))
    log = _launch_log(ro)
    eval_ms = (time.time() - t1) * 1e3
    launches_eval = ro.rollout.launches - launches_fit
    c4 = {"chains": 8, "iterations": CHAIN_ITERATIONS,
          "train_seconds": train_s,
          "chain_it_per_s": 8 * CHAIN_ITERATIONS / train_s,
          "single_chain_it_per_s_phase4": single["train_it_per_s"],
          "rhat_tail": mct.rhat(trace), "nll_first": trace[0].tolist(),
          "nll_last": trace[-1].tolist(), "moments_ms": eval_ms,
          "rollout_launches_fit": launches_fit,
          "rollout_launches_evaluate": launches_eval, "launches": log,
          **_pooled_metrics(chains, ds)}
    check(bool(torch.isfinite(trace).all()), "multichain C4: non-finite nll")
    check(len(set(trace[-1].tolist())) == 8,
          "multichain C4: the chains did not decorrelate")
    check(launches_fit == 0 and launches_eval == 1
          and [e["rows"] for e in log] == [80],
          f"multichain C4: launches {launches_fit}/{launches_eval} {log}")
    check(all(math.isfinite(v) for r in [c4] + c4["per_chain"]
              for v in (r["rmse"], r["nll"])),
          f"multichain C4: non-finite RMSE/NLL {c4}")
    # 8 chains against one: kernels, syncs and ms an iteration, profiled
    one = Trainer(cfg, data)
    one_state = one.init_state(p0)
    one.run(one_state, 5)
    prof1, w1 = profile_window(lambda: one.run(one_state, 10))
    prof8, w8 = profile_window(lambda: mct.run(state, 10, generator=gen))
    c4["profiled_10_iterations"] = {"single": summarize(prof1, w1, 10),
                                    "chains_8": summarize(prof8, w8, 10),
                                    "ms_per_iter_single": w1 / 1e4,
                                    "ms_per_iter_chains_8": w8 / 1e4}

    ro.rollout.launches = 0          # the C5 path starts here
    m5 = MultiChainTrainer(FFVDConfig(dataset="ballbeam", case=5), data, 4)
    s5 = m5.init_state(m5.stack_params(p0, gen))
    torch.cuda.synchronize()
    t0 = time.time()
    s5, t5 = m5.run(s5, 20, generator=gen)
    t5 = t5.cpu()
    train5_s = time.time() - t0
    launches_fit5 = ro.rollout.launches
    t1 = time.time()
    ro.rollout.log.clear()
    chains5, s5 = multichain_moments(
        m5, s5, ds.n_test, generator=torch.Generator().manual_seed(2),
        thin_generator=gen)
    log5 = _launch_log(ro)
    eval5_ms = (time.time() - t1) * 1e3
    launches_eval5 = ro.rollout.launches - launches_fit5
    c5 = {"chains": 4, "iterations": 20, "train_seconds": train5_s,
          "chain_it_per_s": 4 * 20 / train5_s, "moments_ms": eval5_ms,
          "thinning_sub_steps": 10 * 32,
          "rollout_launches_fit": launches_fit5,
          "rollout_launches_evaluate": launches_eval5, "launches": log5,
          **_pooled_metrics(chains5, ds)}
    emit("multichain_path", card=card, dataset="ballbeam", precision="fp32",
         C4=c4, C5=c5)
    check(bool(torch.isfinite(t5).all()), "multichain C5: non-finite nll")
    check(launches_fit5 == 0 and launches_eval5 == 1
          and [e["rows"] for e in log5] == [40],
          f"multichain C5: launches {launches_fit5}/{launches_eval5} {log5}")
    check(all(math.isfinite(v) for r in [c5] + c5["per_chain"]
              for v in (r["rmse"], r["nll"])),
          f"multichain C5: non-finite RMSE/NLL {c5}")
    return {"C4x8": launches_fit + launches_eval,
            "C5x4": launches_fit5 + launches_eval5}


def phase_six_datasets(torch, ro, card):
    """Phase 4j: BASELINE config 5 in fp32, the protocol of
    ``bench.py:186-215``: all six datasets resized to M=512, padded to a
    common N with a mask, C4 in one ``MultiDatasetTrainer`` step; 200
    warm-up and 200 timed iterations; kernels, host syncs and device time
    by kernel class of 10 profiled iterations; then ``evaluate()``: each
    dataset one launch on the kernel's global-memory plan."""
    from ffvd_tpu_torch.config import DATASETS, FFVDConfig
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.parallel import MultiDatasetTrainer, stack_datasets
    from ffvd_tpu_torch.utils.profiling import profile_window, summarize
    ro.rollout.launches = 0          # this path starts here
    data, params, lens = stack_datasets(DATASETS, device="cuda",
                                        dtype=torch.float32, m=512)
    mdt = MultiDatasetTrainer(FFVDConfig(dataset="ballbeam", case=4,
                                         num_inducing=512), data)
    state = mdt.init_state(params)
    t0 = time.time()
    state, warm = mdt.run(state, 200, chunk_size=200)
    warm = warm.cpu()
    warm_s = time.time() - t0
    t1 = time.time()
    state, timed_nll = mdt.run(state, 200, chunk_size=200)
    timed_nll = timed_nll.cpu()
    dt = time.time() - t1
    launches_fit = ro.rollout.launches
    dss = [create_dataset(n) for n in DATASETS]
    t2 = time.time()
    ro.rollout.log.clear()
    res = mdt.evaluate(state, dss, lens,
                       generator=torch.Generator().manual_seed(3))
    log = _launch_log(ro)
    eval_ms = (time.time() - t2) * 1e3
    launches_eval = ro.rollout.launches - launches_fit
    prof, wall = profile_window(lambda: mdt.run(state, 10))
    out = {"card": card, "datasets": list(DATASETS), "lengths": lens,
           "n_pad": max(lens), "M": 512, "case": "C4", "precision": "fp32",
           "warmup_iterations": 200, "warmup_seconds": warm_s,
           "timed_iterations": 200, "timed_seconds": dt,
           "ms_per_6model_iter": dt / 200 * 1e3,
           "aggregate_it_per_s": 6 * 200 / dt,
           "nll_first": warm[0].tolist(), "nll_last": timed_nll[-1].tolist(),
           "profiled_10_iterations": {**summarize(prof, wall, 10),
                                      "ms_per_iter": wall / 1e4},
           "evaluate_ms": eval_ms, "results": res,
           "rollout_launches_fit": launches_fit,
           "rollout_launches_evaluate": launches_eval, "launches": log}
    emit("six_datasets_m512", **out)
    check(bool(torch.isfinite(warm).all() and torch.isfinite(timed_nll).all()),
          "six datasets: non-finite nll")
    check(all(float(a) > float(b) for a, b in zip(warm[0], timed_nll[-1])),
          f"six datasets: an nll did not decrease {out['nll_first']} -> "
          f"{out['nll_last']}")
    check(launches_fit == 0 and launches_eval == 6
          and all(not e["plan"]["resident"] for e in log),
          f"six datasets: launches {launches_fit}/{launches_eval} {log}")
    check(all(math.isfinite(r["rmse"]) and math.isfinite(r["nll"])
              for r in res.values()), f"six datasets: {res}")
    return launches_fit + launches_eval


def phase_fp64_batched(torch):
    """Phase 5f: the chain axis in fp64, cuda against CPU: 3 chains of
    ballbeam C4 for 20 iterations, and 2 chains of C5 for 3 iterations with
    the same injected draws, traces and leaves within rtol 1e-8; then a
    checkpoint resume on the card: C5 fp32 with the CUDA generator, saved
    at 10 iterations and resumed to 20, bit-equal to the uninterrupted
    run."""
    import tempfile

    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
    from ffvd_tpu_torch.model.params import (LEAF_PATHS, SSMData,
                                             init_params_from_warmstart)
    from ffvd_tpu_torch.parallel import MultiChainTrainer
    from ffvd_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                 run_with_checkpoints)
    t0 = time.time()
    ds = create_dataset("ballbeam")
    ws = load_warmstart("ballbeam")
    g = torch.Generator().manual_seed(56)
    p_cpu = init_params_from_warmstart(ws)
    normals = {k: torch.randn((3,) + tuple(v.shape), generator=g,
                              dtype=torch.float64)
               for k, v in p_cpu.leaves().items()}
    out = {}
    for case, chains, iters in ((4, 3, 20), (5, 2, 3)):
        cfg = FFVDConfig(dataset="ballbeam", case=case)
        runs, draws = {}, None
        for dev in ("cpu", "cuda"):
            as_t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                             device=dev)
            mct = MultiChainTrainer(cfg, SSMData(y=as_t(ds.y_train),
                                                 control=as_t(ds.control)),
                                    chains)
            state = mct.init_state(mct.stack_params(
                init_params_from_warmstart(ws, device=dev),
                normals={k: v[:chains] for k, v in normals.items()}))
            if mct.has_sghmc and draws is None:
                sub = mct.subset.split(state.params)
                draws = [{"noise": {k: torch.randn(
                    (chains, len(SUBSTEP_FLAGS)) + tuple(v.shape[1:]),
                    generator=g, dtype=torch.float64)
                    for k, v in sub.items()},
                    "feed": torch.randint(0, i + 1, (chains,),
                                          generator=g).tolist()}
                    for i in range(iters)]
            t1 = time.time()
            state, trace = mct.run(state, iters, draws=None if draws is None
                                   else [{"noise": {k: v.to(dev) for k, v in
                                                    d["noise"].items()},
                                          "feed": d["feed"]} for d in draws])
            runs[dev] = (trace.cpu(), {k: v.detach().cpu() for k, v in
                                       state.params.leaves().items()},
                         time.time() - t1)
        rel = float(((runs["cuda"][0] - runs["cpu"][0]).abs()
                     / runs["cpu"][0].abs()).max())
        leaf_ok = all(torch.allclose(runs["cuda"][1][k], runs["cpu"][1][k],
                                     rtol=1e-8, atol=1e-12)
                      for k in LEAF_PATHS)
        out[f"C{case}"] = {"chains": chains, "iterations": iters,
                           "max_rel_diff": rel,
                           "leaves_within_rtol_1e_8": leaf_ok,
                           "seconds_cuda": runs["cuda"][2],
                           "seconds_cpu": runs["cpu"][2]}
        check(torch.allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-8,
                             atol=0) and leaf_ok,
              f"fp64 C{case} chains cuda vs cpu differ: {out[f'C{case}']}")

    # checkpoint resume on the card, fp32 C5, the CUDA generator restored
    cfg = FFVDConfig(dataset="ballbeam", case=5)
    _, data, p0 = _cuda_data(torch, "ballbeam", torch.float32)
    tr = Trainer(cfg, data)
    gen = lambda: torch.Generator(device="cuda").manual_seed(5)
    full, trace = tr.run(tr.init_state(p0), 20, generator=gen())
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        g1 = gen()
        _, first = run_with_checkpoints(tr, tr.init_state(p0), 10, mgr,
                                        every=10, generator=g1)
        g2 = torch.Generator(device="cuda").manual_seed(999)
        resumed = mgr.restore(tr.init_state(p0), generator=g2)
        resumed, rest = run_with_checkpoints(tr, resumed, 20, mgr, every=10,
                                             generator=g2)
    same_trace = torch.equal(torch.cat([first, rest]), trace)
    same_leaves = all(torch.equal(v, full.params.leaves()[k])
                      for k, v in resumed.params.leaves().items())
    out["checkpoint_resume_C5_fp32"] = {
        "saved_at": 10, "resumed_to": 20, "trace_bit_equal": same_trace,
        "leaves_bit_equal": same_leaves}
    emit("fp64_batched", **out, seconds=time.time() - t0)
    check(same_trace and same_leaves,
          f"checkpoint resume on the card differs: {out}")


def phase_fp64_segment(torch):
    """Phase 5e: the float64 collapsed segment, cuda against CPU.
    ``ds_collapsed_terms`` at the ballbeam warm start with fp32 leaves:
    the three terms within 2 fp32 ulps, the gradients of the kernel
    hypers, z, x and log Q at rtol 1e-5; then 3 ds64 C4 iterations with
    fp64 leaves, the nll traces within rtol 1e-9."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.ds_collapse import ds_collapsed_terms
    from ffvd_tpu_torch.model.elbo import gp_inputs
    from ffvd_tpu_torch.model.params import (GPSSMParams, SSMData,
                                             init_params_from_warmstart)
    t0 = time.time()
    ds = create_dataset("ballbeam")
    ws = load_warmstart("ballbeam")
    cfg = FFVDConfig(dataset="ballbeam", case=4, collapse_precision="ds64")
    paths = ("kernel.log_variance", "kernel.log_lengthscales", "z", "x",
             "log_q")
    seg, runs = {}, {}
    for dev in ("cpu", "cuda"):
        as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
        data = SSMData(y=as_t(ds.y_train, torch.float32),
                       control=as_t(ds.control, torch.float32))
        p = init_params_from_warmstart(ws, device=dev, dtype=torch.float32)
        leaves = {k: v.requires_grad_(k in paths)
                  for k, v in p.leaves().items()}
        p = GPSSMParams.from_leaves(leaves)
        terms = ds_collapsed_terms(cfg.kernel_type, p.kernel, p.z, p.x,
                                   gp_inputs(p, data), p.log_q)
        grads = torch.autograd.grad(sum(terms), [leaves[k] for k in paths])
        seg[dev] = ([float(t.detach()) for t in terms],
                    [g.detach().cpu() for g in grads])
        data64 = SSMData(y=as_t(ds.y_train, torch.float64),
                         control=as_t(ds.control, torch.float64))
        tr = Trainer(cfg, data64)
        t1 = time.time()
        _, trace = tr.run(tr.init_state(init_params_from_warmstart(
            ws, device=dev, dtype=torch.float64)), 3)
        runs[dev] = (trace.cpu(), time.time() - t1)
    import numpy as np
    ulps = [abs(a - b) / float(np.spacing(np.float32(abs(b))))
            for a, b in zip(seg["cuda"][0], seg["cpu"][0])]
    grad_rel = {k: float(((g - c).abs() / c.abs().clamp(min=1e-30)).max())
                for k, g, c in zip(paths, seg["cuda"][1], seg["cpu"][1])}
    grad_ok = all(torch.allclose(g, c, rtol=1e-5,
                                 atol=1e-7 * float(c.abs().max()))
                  for g, c in zip(seg["cuda"][1], seg["cpu"][1]))
    tc, tg = runs["cpu"][0], runs["cuda"][0]
    rel = float(((tg - tc).abs() / tc.abs()).max())
    emit("fp64_segment", terms_cuda=seg["cuda"][0], terms_cpu=seg["cpu"][0],
         terms_ulps=ulps, grad_max_rel_diff=grad_rel,
         grads_within_rtol_1e_5=grad_ok, ds64_c4_iterations=3,
         ds64_c4_trace_max_rel_diff=rel, seconds_cuda=runs["cuda"][1],
         seconds_cpu=runs["cpu"][1], seconds=time.time() - t0)
    check(max(ulps) <= 2, f"fp64 segment terms cuda vs cpu: {ulps} ulps")
    check(grad_ok, f"fp64 segment gradients cuda vs cpu: {grad_rel}")
    check(torch.allclose(tg, tc, rtol=1e-9, atol=0),
          f"ds64 C4 trace cuda vs cpu: max rel {rel}")


def phase_fp64_deep(torch):
    """Phase 5d: flutter C4 with ``n_layers=2`` in fp64, 3 outer
    iterations with the same injected inter-layer normals on cuda and on
    the CPU, the nll traces and every leaf within rtol 1e-9; then the deep
    rollout (S=10 over the test half) with the same injected head and
    hidden-layer noise on both, within rtol 1e-9."""
    import dataclasses
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.eval.rollout import collect_posterior
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import (SSMData, init_hidden_layers,
                                             init_params_from_warmstart,
                                             params_from_numpy,
                                             params_to_numpy)
    t0 = time.time()
    cfg = FFVDConfig(dataset="flutter", case=4, n_layers=2)
    ds = create_dataset("flutter")
    head = init_params_from_warmstart(load_warmstart("flutter"))
    leaves = params_to_numpy(dataclasses.replace(head, hidden=init_hidden_layers(
        1, head, generator=torch.Generator().manual_seed(0))))
    g = torch.Generator().manual_seed(88)
    t_len = ds.n_test
    noise = torch.randn((S, t_len, 4), generator=g, dtype=torch.float64)
    hidden_noise = [torch.randn((S, t_len, 4), generator=g,
                                dtype=torch.float64)]
    draws, runs = None, {}
    for dev in ("cpu", "cuda"):
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        tr = Trainer(cfg, SSMData(y=as_t(ds.y_train), control=as_t(ds.control)))
        state = tr.init_state(params_from_numpy(leaves, device=dev))
        if draws is None:
            draws = [tr.grad_draws(1, g, state.params.x) for _ in range(3)]
        t1 = time.time()
        state, trace = tr.run(state, 3, draws=[
            {"prop": [p.to(dev) for p in d["prop"]]} for d in draws])
        train_s = time.time() - t1
        t2 = time.time()
        xs, vs, _ = collect_posterior(tr, state, t_len, num=S,
                                      noise=noise.to(dev),
                                      hidden_noise=[h.to(dev)
                                                    for h in hidden_noise])
        runs[dev] = (trace.cpu(), {k: v.detach().cpu() for k, v
                                   in state.params.leaves().items()},
                     xs.cpu(), vs.cpu(), train_s, time.time() - t2)
    (tc, lc, xc, vc, *sc), (tg, lg, xg, vg, *sg) = runs["cpu"], runs["cuda"]
    rel = float(((tg - tc).abs() / tc.abs()).max())
    leaf_ok = all(torch.allclose(lg[k], v, rtol=1e-9, atol=1e-12)
                  for k, v in lc.items())
    roll_err = max(float((xg - xc).abs().max()), float((vg - vc).abs().max()))
    roll_ok = (torch.allclose(xg, xc, rtol=1e-9, atol=1e-12)
               and torch.allclose(vg, vc, rtol=1e-9, atol=1e-12))
    emit("fp64_deep", case="C4", n_layers=2, iterations=3, max_rel_diff=rel,
         leaves_within_rtol_1e_9=leaf_ok, rollout_T=t_len,
         rollout_max_abs_diff=roll_err, rollout_within_rtol_1e_9=roll_ok,
         seconds_train_cuda=sg[0], seconds_train_cpu=sc[0],
         seconds_rollout_cuda=sg[1], seconds_rollout_cpu=sc[1],
         seconds=time.time() - t0)
    check(torch.allclose(tg, tc, rtol=1e-9, atol=0) and leaf_ok,
          f"fp64 deep C4 cuda vs cpu differ: max rel {rel}")
    check(roll_ok and bool(torch.isfinite(xg).all()),
          f"fp64 deep rollout cuda vs cpu differ: {roll_err}")


def phase_fp64_pg(torch):
    """Phase 5c: ballbeam C6 in fp64, 3 outer iterations with the same
    injected sweep draws on cuda and on the CPU: the nll traces and every
    leaf within rtol 1e-9; and one sweep at the warm start on both, whose
    resampling indices must be identical."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.inference import particle_gibbs as pg
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.conditionals import kernel_precal
    from ffvd_tpu_torch.model.params import (SSMData,
                                             init_params_from_warmstart)
    t0 = time.time()
    cfg = FFVDConfig(dataset="ballbeam", case=6)
    ds = create_dataset("ballbeam")
    ws = load_warmstart("ballbeam")
    g = torch.Generator().manual_seed(66)
    draws, runs = None, {}
    for dev in ("cpu", "cuda"):
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        data = SSMData(y=as_t(ds.y_train), control=as_t(ds.control))
        tr = Trainer(cfg, data, pg_fn=pg.make_pg_fn(cfg))
        state = tr.init_state(init_params_from_warmstart(
            ws, device=dev, dtype=torch.float64))
        if draws is None:
            draws = [pg.pg_draws(cfg, state.params, g) for _ in range(4)]
        on = [{k: v.to(dev) for k, v in d.items()} for d in draws]
        pre = kernel_precal(cfg.kernel_type, state.params.kernel,
                            state.params.z, cfg.jitter)
        _, _, picks = pg.pg_ancestor_style(cfg, state.params, pre, data,
                                           on[3])
        t1 = time.time()
        state, trace = tr.run(state, 3, draws=[{"pg": d} for d in on[:3]])
        runs[dev] = (trace.cpu(), {k: v.detach().cpu() for k, v
                                   in state.params.leaves().items()},
                     {k: v.cpu() for k, v in picks.items()},
                     time.time() - t1)
    rel = float(((runs["cuda"][0] - runs["cpu"][0]).abs()
                 / runs["cpu"][0].abs()).max())
    leaf_ok = all(torch.allclose(runs["cuda"][1][k], v, rtol=1e-9,
                                 atol=1e-12)
                  for k, v in runs["cpu"][1].items())
    same_idx = all(torch.equal(runs["cuda"][2][k], v)
                   for k, v in runs["cpu"][2].items())
    emit("fp64_pg", case="C6", iterations=3, max_rel_diff=rel,
         leaves_within_rtol_1e_9=leaf_ok,
         resampling_indices_identical=same_idx,
         seconds_cuda=runs["cuda"][3], seconds_cpu=runs["cpu"][3],
         seconds=time.time() - t0)
    check(same_idx, "fp64 C6: resampling indices differ between cuda and CPU")
    check(torch.allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-9, atol=0)
          and leaf_ok, f"fp64 C6 cuda vs cpu differ: max rel {rel}")


def phase_fp64_sampler(torch):
    """Phase 5b: ballbeam C5 in fp64, 5 outer iterations with the same
    injected sampler noise and window feeds on cuda and on the CPU; the nll
    traces and every leaf within rtol 1e-8."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
    from ffvd_tpu_torch.model.params import (SSMData,
                                             init_params_from_warmstart)
    t0 = time.time()
    cfg = FFVDConfig(dataset="ballbeam", case=5)
    ds = create_dataset("ballbeam")
    ws = load_warmstart("ballbeam")
    g = torch.Generator().manual_seed(55)
    draws, runs = None, {}
    for dev in ("cpu", "cuda"):
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        tr = Trainer(cfg, SSMData(y=as_t(ds.y_train), control=as_t(ds.control)))
        state = tr.init_state(init_params_from_warmstart(
            ws, device=dev, dtype=torch.float64))
        if draws is None:
            sub = tr.subset.split(state.params)
            draws = [{"noise": {k: torch.randn((len(SUBSTEP_FLAGS),)
                                               + tuple(v.shape), generator=g,
                                               dtype=torch.float64)
                                for k, v in sub.items()},
                      "feed": int(torch.randint(0, i + 1, (), generator=g))}
                     for i in range(5)]
        t1 = time.time()
        state, trace = tr.run(state, 5, draws=[
            {"noise": {k: v.to(dev) for k, v in d["noise"].items()},
             "feed": d["feed"]} for d in draws])
        runs[dev] = (trace.cpu(), {k: v.detach().cpu() for k, v
                                   in state.params.leaves().items()},
                     time.time() - t1)
    rel = float(((runs["cuda"][0] - runs["cpu"][0]).abs()
                 / runs["cpu"][0].abs()).max())
    leaf_ok = all(torch.allclose(runs["cuda"][1][k], v, rtol=1e-8,
                                 atol=1e-12)
                  for k, v in runs["cpu"][1].items())
    emit("fp64_sampler", case="C5", iterations=5, max_rel_diff=rel,
         leaves_within_rtol_1e_8=leaf_ok, seconds_cuda=runs["cuda"][2],
         seconds_cpu=runs["cpu"][2], seconds=time.time() - t0)
    check(torch.allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-8, atol=0)
          and leaf_ok, f"fp64 C5 cuda vs cpu differ: max rel {rel}")


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


def _bound(dtype_name, s, t, d, m, din, cu, itemsize, with_noise_input,
           per_sample=False):
    """Least time for the rollout's work at these shapes: the larger of its
    compulsory bytes over HBM bandwidth and its operations over the peak
    rate.  Lm⁻¹ and q_sqrt are triangular, so only their triangles count.
    ``per_sample``: every sample reads its own parameters, so they count S
    times."""
    tri = d * m * (m + 1) // 2
    per_step = (d * m * (4 * din + 2)      # e: scaled diffs, squares, exp
                + 2 * 2 * tri              # a = σ²Lm⁻¹e, q_sqrtᵀa (FMAs)
                + d * m * 3                # a·U, a², (q_sqrtᵀa)²
                + 3 * d * m                # three reductions over M
                + 8 * d)                   # var, clamp, sqrt, x update
    flops = s * t * per_step
    params = d * m * din + d * din + d + 2 * tri + m * d + d
    elems_in = (s * d + params * (s if per_sample else 1)
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


def _breakdown(torch, ro, inp):
    """Kernel ms at the main shapes with one thing changed at a time, to
    show what a step waits on: one sample (one cluster alone), no q_sqrt
    (no second triangular product), noise given (no in-kernel Philox), one
    step (fill and launch); and the fill alone at phase 3's shape (65,536
    samples of one step), with its bytes moved into shared memory."""
    gen = torch.Generator().manual_seed(11)
    one_step = dict(inp, controls=inp["controls"][:1].contiguous())
    noise = torch.zeros((S, T, 4), device="cuda", dtype=inp["z"].dtype)
    big = 65536
    ms = {
        "s1": _time_ms(torch, lambda: call(ro.rollout, inp, generator=gen,
                                           num_samples=1), 50),
        "no_qsqrt": _time_ms(torch, lambda: call(ro.rollout, inp, False,
                                                 generator=gen), 50),
        "noise_given": _time_ms(torch, lambda: call(ro.rollout, inp,
                                                    noise=noise), 50),
        "t1": _time_ms(torch, lambda: call(ro.rollout, one_step,
                                           generator=gen), 50),
        "s65536_t1": _time_ms(torch, lambda: call(ro.rollout, one_step,
                                                  generator=gen,
                                                  num_samples=big), 10),
    }
    plan = ro.rollout.last_plan
    m = inp["z"].shape[0]
    fill = big * plan.cluster * m * (m + 1) * inp["z"].element_size()
    return {"ms": ms, "s65536_t1_fill_bytes": fill,
            "s65536_t1_fill_bytes_per_s": fill / (ms["s65536_t1"] * 1e-3)}


# ---------------------------------------------------------------------------
# Phase 7: the mesh half of parallel/ across processes
# ---------------------------------------------------------------------------

def _chain_spec(name, c, case, dtype, iters, seed=0, **extra):
    """A ``rank_jobs`` spec: ``name``'s warm start stacked over ``c``
    chains, each leaf + 1e-3·N(0, 1) a chain (numpy, ``seed``)."""
    import numpy as np

    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.model.params import (init_params_from_warmstart,
                                             params_to_numpy)
    ds = create_dataset(name)
    one = params_to_numpy(init_params_from_warmstart(load_warmstart(name)))
    rng = np.random.RandomState(seed)
    leaves = {k: np.stack([v + 1e-3 * rng.randn(*v.shape) for _ in range(c)])
              for k, v in one.items()}
    return dict(cfg=dict(dataset=name, case=case), dtype=dtype,
                leaves=leaves, y=ds.y_train, control=ds.control, iters=iters,
                seed=seed, **extra)


def _kink_spec(dtype, iters, **extra):
    """Kink N=5000 (phase 4f's data and cold start), C4, full batch."""
    import torch

    from ffvd_tpu_torch.data import generate_kink
    from ffvd_tpu_torch.model.params import (init_params_random,
                                             params_to_numpy)
    ds = generate_kink(n=5000, seed=0)
    leaves = params_to_numpy(init_params_random(
        5000, 4, 100, 0, generator=torch.Generator().manual_seed(0)))
    return dict(cfg=dict(dataset="kink", case=4), dtype=dtype,
                leaves=leaves, y=ds.y_train, control=ds.control, iters=iters,
                seed=0, **extra)


def _diff(torch, got, want, rtol, atol):
    """Over the trace and every state tensor of two job results: (max
    |got − want| / max |want| of a tensor, all within rtol/atol, all bit
    equal)."""
    pairs = [(got["trace"], want["trace"])] + [
        (got["state"][k], v) for k, v in want["state"].items()]
    rel, close, equal = 0.0, True, True
    for g, w in pairs:
        g, w = g.double(), w.double()
        rel = max(rel, float((g - w).abs().max()
                             / w.abs().max().clamp(min=1e-300)))
        close = close and bool(torch.allclose(g, w, rtol=rtol, atol=atol))
        equal = equal and bool(torch.equal(g, w))
    return rel, close, equal and set(got["state"]) == set(want["state"])


def _moments_diff(got, want):
    """max relative difference of the chains' moments and of the pooled
    mixture moments."""
    import numpy as np

    from ffvd_tpu_torch.eval.ensemble import pool_moments
    rel = lambda a, b: float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)),
                                                         1e-300))
    chains = max(rel(a, b) for ga, wa in zip(got, want)
                 for a, b in zip(ga, wa))
    pooled = max(rel(a, b) for a, b in zip(pool_moments(got),
                                           pool_moments(want)))
    return chains, pooled


def _mesh_plans():
    """7b's and 7c's jobs: (name, kind, spec) on dp=2 × ep=2 and sp=4."""
    from ffvd_tpu_torch.config import DATASETS
    dpep = dict(mesh=(2, 2))
    b = [("C4x8_fp64", "chains", _chain_spec(
             "ballbeam", 8, 4, "float64", 20,
             moments=dict(test_len=500, seed=1, check_whole=True), **dpep)),
         ("C5x4_fp64", "chains", _chain_spec("ballbeam", 4, 5, "float64", 3,
                                             **dpep)),
         ("C4x8_fp32_timed", "chains", _chain_spec(
             "ballbeam", 8, 4, "float32", 10, timed=200, **dpep)),
         ("six_m512", "datasets", dict(
             cfg=dict(dataset="ballbeam", case=4, num_inducing=512),
             names=list(DATASETS), m=512, dtype="float32", iters=20,
             eval_seed=3, **dpep))]
    sp = dict(mesh=(4,), axis="sp")
    c = [("kink_fp64", "sequence", _kink_spec("float64", 10, **sp)),
         ("kink_fp32_timed", "sequence", _kink_spec("float32", 2, timed=20,
                                                    **sp))]
    return b, c


def _check_dp_ep(torch, ranks, singles, what, on_card=True):
    """7b's checks on the ranks' results (name → (result, s)) against the
    one-process runs on the card.  Returns the report."""
    import math
    rep = {}
    for name in ("C4x8_fp64", "C5x4_fp64"):
        rels = [_diff(torch, r[name][0], singles[name], 1e-10, 1e-12)
                for r in ranks]
        rep[name] = {"max_rel_diff_vs_one_process": max(x[0] for x in rels),
                     "within_rtol_1e-10": all(x[1] for x in rels),
                     "seconds": [r[name][1] for r in ranks]}
        check(all(x[1] for x in rels), f"{what} {name}: {rep[name]}")
    c4 = [r["C4x8_fp64"][0] for r in ranks]
    rows = [x["launch_rows"] for x in c4]
    one = _moments_diff(c4[0]["moments"], c4[0]["moments_one_launch"])
    vs_single = _moments_diff(c4[0]["moments"], singles["C4x8_fp64"]
                              ["moments"])
    rep["moments"] = {
        "launch_rows_by_rank": rows,
        "launches_by_rank": [x["launches"] for x in c4],
        "rollout_calls_by_rank": [x["rollout_calls"] for x in c4],
        "vs_one_80_row_launch_same_state": {"chains": one[0],
                                            "pooled": one[1]},
        "vs_one_process_run": {"chains": vs_single[0],
                               "pooled": vs_single[1]},
        "one_process_launch_rows": singles["C4x8_fp64"]["launch_rows"]}
    calls = sorted(sum(rep["moments"]["rollout_calls_by_rank"], []))
    check(calls == [(40, 0), (40, 40)] and max(one) <= 1e-12
          and sorted(sum(rows, [])) == ([40, 40] if on_card else []),
          f"{what} moments: {rep['moments']}")
    rep["C4x8_fp32_timed"] = [r["C4x8_fp32_timed"][0]["timed"]
                              for r in ranks]
    rep["C4x8_fp32_one_process"] = singles["C4x8_fp32_timed"]["timed"]
    six = [r["six_m512"][0] for r in ranks]
    res = six[0]["results"]
    rep["six_m512"] = {
        "results": res, "launches_by_rank": [x["launches"] for x in six],
        "launch_rows_by_rank": [x["launch_rows"] for x in six],
        "resident": sum((x["launch_resident"] for x in six), []),
        "train_s_20_iterations": [x["train_s"] for x in six],
        "nll_first": six[0]["trace"][0].tolist(),
        "nll_last": six[0]["trace"][-1].tolist()}
    check(sum(x["launches"] for x in six) == (6 if on_card else 0)
          and not any(rep["six_m512"]["resident"])
          and all(x["results"] == res for x in six)
          and all(math.isfinite(v["rmse"]) and math.isfinite(v["nll"])
                  for v in res.values())
          and bool(torch.isfinite(six[0]["trace"]).all()),
          f"{what} six datasets: {rep['six_m512']}")
    return rep


def _check_sp(torch, ranks, singles, what, on_card=True):
    rels = [_diff(torch, r["kink_fp64"][0], singles["kink_fp64"], 1e-10,
                  1e-12) for r in ranks]
    rep = {"kink_fp64": {"max_rel_diff_vs_one_process": max(x[0]
                                                             for x in rels),
                         "within_rtol_1e-10": all(x[1] for x in rels),
                         "seconds": [r["kink_fp64"][1] for r in ranks]},
           "kink_fp32_timed": [r["kink_fp32_timed"][0]["timed"]
                               for r in ranks],
           "kink_fp32_one_process": singles["kink_fp32_timed"]["timed"]}
    check(all(x[1] for x in rels), f"{what} kink: {rep['kink_fp64']}")
    return rep


def phase_mesh(torch, card, device="cuda:0"):
    """Phase 7: the mesh half of ``parallel/``, through
    ``parallel.distributed.spawn_local`` and the jobs of
    ``parallel/rank_jobs.py`` (the ranks import nothing of JAX), each held
    against the same job in this process on the card.

    7a: NCCL at world size 1 on cuda:0, mesh (1, 1): 8 ballbeam C4 chains,
    50 fp32 iterations, then ``multichain_moments``: bit-equal to the run
    without a mesh.  7b: gloo, 4 ranks sharing cuda:0 (NCCL refuses two
    ranks on one card), dp=2 × ep=2: 8 C4 chains fp64 for 20 iterations and
    4 C5 chains fp64 for 3, each within rtol 1e-10 of the one-process run;
    the C4 chains' moments from 2 launches of 40 rows (one a dp group,
    Philox rows offset), equal to one 80-row launch on the same state
    within rtol 1e-12; 8 C4 chains fp32, 200 iterations timed (ms an
    iteration, the collectives' share of the host time) beside one
    process's 8 chains timed alike; six datasets ×
    M=512 for 20 iterations and ``evaluate()`` (6 launches, global plan).
    7c: gloo, 4 ranks sharing cuda:0, sp=4: kink N=5000 C4 full batch,
    fp64 for 10 iterations within rtol 1e-10 of the one-process
    ``Trainer``; fp32 timed beside the one-process rate.  7d: 7b and 7c
    over NCCL on 4 cards when the machine has them.  Timings of ranks that
    share one card measure correctness and overhead, not scaling.
    ``device="cpu"`` rehearses it on the host (gloo throughout, no 7d)."""
    from ffvd_tpu_torch.parallel.distributed import spawn_local
    from ffvd_tpu_torch.parallel.rank_jobs import chains_job, jobs_in_turn
    dev = torch.device(device)
    out = {}
    # 7a
    spec = _chain_spec("ballbeam", 8, 4, "float32", 50,
                       moments=dict(test_len=500, seed=1))
    t0 = time.time()
    (ranked,) = spawn_local(chains_job, 1,
                            "nccl" if dev.type == "cuda" else "gloo", device,
                            args=(dict(spec, mesh=(1, 1)),), timeout=300)
    a_s = time.time() - t0
    one = chains_job(dev, spec)
    rel, _, equal = _diff(torch, ranked, one, 0.0, 0.0)
    m_rel = _moments_diff(ranked["moments"], one["moments"])
    out["7a"] = {"backend": "nccl" if dev.type == "cuda" else "gloo",
                 "world_size": 1, "mesh": [1, 1],
                 "chains": 8, "iterations": 50, "precision": "fp32",
                 "bit_equal": equal, "max_rel_diff": rel,
                 "moments_max_rel_diff": m_rel,
                 "launches": ranked["launches"],
                 "launch_rows": ranked["launch_rows"], "seconds": a_s}
    emit("mesh_7a", **out["7a"])
    card_launches = 1 if dev.type == "cuda" else 0   # plain on the host
    check(equal and max(m_rel) == 0.0
          and ranked["rollout_calls"] == [(80, 0)]
          and ranked["launches"] == card_launches,
          f"7a: mesh (1, 1) differs from one process: {out['7a']}")
    plan_b, plan_c = _mesh_plans()
    singles = {name: jobs_in_turn(dev, [(name, kind, dict(spec, mesh=None))]
                                  )[name][0]
               for name, kind, spec in plan_b[:3] + plan_c}
    # 7b, 7c: gloo ranks sharing the card, in one set of processes
    t0 = time.time()
    ranks = spawn_local(jobs_in_turn, 4, "gloo", device,
                        args=(plan_b + plan_c,), timeout=600)
    bc_s = time.time() - t0
    for key, check_fn in (("7b", _check_dp_ep), ("7c", _check_sp)):
        out[key] = {"backend": "gloo", "ranks": 4, "cards": 1,
                    "seconds_7b_and_7c": bc_s,
                    **check_fn(torch, ranks, singles, key,
                               dev.type == "cuda")}
        emit(f"mesh_{key}", card=card, **out[key])
    # 7d: NCCL over 4 cards
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n >= 4:
        out["7d"] = {"ran": True, "cards": n}
        ranks = spawn_local(jobs_in_turn, 4, "nccl", "cuda",
                            args=(plan_b + plan_c,), timeout=600)
        for key, check_fn in (("7b", _check_dp_ep), ("7c", _check_sp)):
            out["7d"][key] = check_fn(torch, ranks, singles, f"7d {key}")
        emit("7d", **out["7d"])
    else:
        out["7d"] = {"ran": False, "cards": n}
        emit("7d", **out["7d"])
    return {"launches": {
        "mesh_nccl_C4x8": out["7a"]["launches"],
        "mesh_gloo_dp2ep2_C4x8": sum(out["7b"]["moments"]
                                     ["launches_by_rank"]),
        "mesh_gloo_dp2ep2_six_m512": sum(out["7b"]["six_m512"]
                                         ["launches_by_rank"])}}


def phase_timing(torch, ro):
    """Phase 6: kernel and plain-version times at the main shapes, the
    kernel's time at S=64 beside them (64 clusters queue past 132 SMs), and
    the launch plan; then, fp32, 80 per-sample rows (M=100) and S=10 at
    M=512 on the global-memory plan."""
    out = {}
    gen = torch.Generator().manual_seed(7)
    for name, dtype in (("fp32", torch.float32), ("fp64", torch.float64)):
        inp = main_shape_inputs(torch, dtype)
        launches = ro.rollout.launches
        k_ms = _time_ms(torch, lambda: call(ro.rollout, inp, generator=gen),
                        200)
        plan = ro.rollout.last_plan
        k64_ms = _time_ms(torch, lambda: call(ro.rollout, inp, generator=gen,
                                              num_samples=64), 50)
        p_ms = _time_ms(torch, lambda: call(ro.rollout_reference, inp,
                                            generator=gen), 5)
        breakdown = _breakdown(torch, ro, inp)
        per = per_sample_inputs(torch, inp, S)
        ps_ms = _time_ms(torch, lambda: call_batched(
            ro.rollout_batched, per, generator=gen), 200)
        ps_plan = ro.rollout.last_plan
        ps_plain_ms = _time_ms(torch, lambda: call_batched(
            ro.rollout_reference_batched, per, generator=gen), 3)
        ro.rollout.launches = launches   # timing launches are not the path's
        itemsize = 4 if dtype == torch.float32 else 8
        bound_ms, bound_by, flops, nbytes = _bound(
            name, S, T, 4, 100, 5, 1, itemsize, with_noise_input=False)
        bound64_ms = _bound(name, 64, T, 4, 100, 5, 1, itemsize,
                            with_noise_input=False)[0]
        ps_bound_ms, ps_bound_by, _, ps_bytes = _bound(
            name, S, T, 4, 100, 5, 1, itemsize, with_noise_input=False,
            per_sample=True)
        out[name] = {"ms": k_ms, "us_per_step": k_ms * 1e3 / T,
                     "breakdown": breakdown,
                     "plain_ms": p_ms, "bound_ms": bound_ms,
                     "bound_us": bound_ms * 1e3, "bound_by": bound_by,
                     "flops": flops, "bytes": nbytes,
                     "kernel_launches_timed": 200,
                     "s64": {"ms": k64_ms, "us_per_step": k64_ms * 1e3 / T,
                             "bound_ms": bound64_ms,
                             "kernel_launches_timed": 50},
                     "per_sample": {"ms": ps_ms, "plain_ms": ps_plain_ms,
                                    "bound_ms": ps_bound_ms,
                                    "bound_by": ps_bound_by,
                                    "bytes": ps_bytes,
                                    "vs_shared": ps_ms / k_ms,
                                    "kernel_launches_timed": 200,
                                    "plain_calls_timed": 3,
                                    "plan": ps_plan._asdict()},
                     "plan": plan._asdict()}
    # The batched paths' launch shapes, fp32: 80 per-sample rows at M=100
    # (multichain_moments of 8 chains, phase 4i) and S=10 at M=512 on the
    # global-memory plan (the six-dataset evaluate(), phase 4j).
    launches = ro.rollout.launches
    inp = main_shape_inputs(torch, torch.float32)
    per80 = per_sample_inputs(torch, inp, 80)
    s80_ms = _time_ms(torch, lambda: call_batched(
        ro.rollout_batched, per80, generator=gen), 50)
    s80_plan = ro.rollout.last_plan
    s80_plain = _time_ms(torch, lambda: call_batched(
        ro.rollout_reference_batched, per80, generator=gen), 2)
    big = random_inputs(torch, torch.float32, 4, 512, T)
    m512_ms = _time_ms(torch, lambda: call(ro.rollout, big, generator=gen),
                       20)
    m512_plan = ro.rollout.last_plan
    m512_plain = _time_ms(torch, lambda: call(ro.rollout_reference, big,
                                              generator=gen), 2)
    ro.rollout.launches = launches
    b80 = _bound("fp32", 80, T, 4, 100, 5, 1, 4, with_noise_input=False,
                 per_sample=True)
    b512 = _bound("fp32", S, T, 4, 512, 5, 1, 4, with_noise_input=False)
    out["fp32_s80_per_sample"] = {
        "S": 80, "T": T, "M": 100, "ms": s80_ms, "plain_ms": s80_plain,
        "bound_ms": b80[0], "bound_by": b80[1], "flops": b80[2],
        "bytes": b80[3], "kernel_launches_timed": 50, "plain_calls_timed": 2,
        "plan": s80_plan._asdict()}
    out["fp32_m512_global"] = {
        "S": S, "T": T, "M": 512, "ms": m512_ms, "plain_ms": m512_plain,
        "bound_ms": b512[0], "bound_by": b512[1], "flops": b512[2],
        "bytes": b512[3], "kernel_launches_timed": 20,
        "plain_calls_timed": 2, "plan": m512_plan._asdict()}
    check(not m512_plan.resident, f"M=512 fp32 plan: {m512_plan}")
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

    seconds = {"device_build": build_s}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t
        return out

    worst = timed("kernel_vs_plain", phase_kernel_vs_plain, torch, ro)
    ps_worst = timed("per_sample_vs_plain", phase_per_sample_vs_plain, torch,
                     ro)
    timed("generator", phase_generator, torch, ro)
    launches = timed("main_path", phase_main_path, torch, ro, card)
    sampler = timed("sampler_paths", phase_sampler_paths, torch, ro, card)
    pg_path = timed("pg_path", phase_pg_path, torch, ro, card)
    timed("linear_path", phase_linear_path, torch, ro, card)
    deep = timed("deep_path", phase_deep_path, torch, ro, card)
    window = timed("window_path", phase_window_path, torch, ro, card)
    hybrid = timed("hybrid_path", phase_hybrid_path, torch, ro, card,
                   REPORT["main_path"])
    ensemble = timed("ensemble_path", phase_ensemble_path, torch, ro, card)
    multichain = timed("multichain_path", phase_multichain_path, torch, ro,
                       card, REPORT["main_path"])
    six = timed("six_datasets_m512", phase_six_datasets, torch, ro, card)
    timed("fp64_train", phase_fp64_train, torch)
    timed("fp64_sampler", phase_fp64_sampler, torch)
    timed("fp64_pg", phase_fp64_pg, torch)
    timed("fp64_deep", phase_fp64_deep, torch)
    timed("fp64_segment", phase_fp64_segment, torch)
    timed("fp64_batched", phase_fp64_batched, torch)
    mesh = timed("mesh", phase_mesh, torch, card)
    timing = timed("timing", phase_timing, torch, ro)
    emit("phase_seconds", **seconds, total=time.time() - t0)

    f32, f64 = timing["fp32"], timing["fp64"]
    ps32, ps64 = f32["per_sample"], f64["per_sample"]
    kernels = {"kernels": [{
        "name": "rollout", "route": "cuda",
        "source": "ffvd_tpu_torch/csrc/rollout.cu",
        "replaces": "ffvd_tpu/ops/pallas_rollout.py:82",
        "launches": launches, "max_abs_err": worst["fp32"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None, "plan": f32["plan"],
        "launches_by_path": {
            "C4": launches,
            **{k: v["rollout_launches_fit"] + v["rollout_launches_evaluate"]
               for k, v in {**sampler, "C6": pg_path, "deep_C4": deep,
                            "window_C4": window, "hybrid_C4": hybrid,
                            "ensemble_C4x2": ensemble}.items()},
            "multichain_C4x8": multichain["C4x8"],
            "multichain_C5x4": multichain["C5x4"],
            "six_datasets_m512": six, **mesh["launches"]},
        "fp32_s80_per_sample": {k: timing["fp32_s80_per_sample"][k] for k in
                                ("ms", "plain_ms", "bound_ms", "bound_by")},
        "fp32_m512_global": {k: timing["fp32_m512_global"][k] for k in
                             ("ms", "plain_ms", "bound_ms", "bound_by")},
        "fp64": {"ms": f64["ms"], "plain_ms": f64["plain_ms"],
                 "bound_ms": f64["bound_ms"], "bound_by": f64["bound_by"],
                 "max_abs_err": worst["fp64"], "plan": f64["plan"]},
        "per_sample": {
            "launches": sum(v["rollout_launches_evaluate"]
                            for v in sampler.values())
            + multichain["C4x8"] + multichain["C5x4"]
            + sum(mesh["launches"].values()),
            "max_abs_err": ps_worst["fp32"], "ms": ps32["ms"],
            "plain_ms": ps32["plain_ms"], "bound_ms": ps32["bound_ms"],
            "bound_by": ps32["bound_by"], "library_ms": None,
            "fp64": {"ms": ps64["ms"], "plain_ms": ps64["plain_ms"],
                     "bound_ms": ps64["bound_ms"],
                     "bound_by": ps64["bound_by"],
                     "max_abs_err": ps_worst["fp64"]}},
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
