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
4b. the SG-HMC paths in fp32: ballbeam C5 for 70 iterations (the
   64-slot window wrapped) and C2 for 20, each then ``evaluate()`` (thinning, per-sample q(U), one launch),
   with the evaluation split into its stages;
4c. the particle-Gibbs path in fp32: ballbeam C6 (P=100) for 20
   iterations and ``evaluate()``, the sweep timed and split, one sweep's
   mixing statistics, and one sweep's recursion and backtrack run under
   ``torch.cuda.set_sync_debug_mode("error")``;
4d. the LinearK path in fp32: ballbeam C4 with ``kernel_type="LinearK"``
   for 20 iterations and ``evaluate()`` (the torch recursion, its step
   replayed from a CUDA graph, no kernel);
4e. the deep path in fp32: flutter C4 with ``n_layers=2`` (one hidden
   layer of the head's shapes) for 250 iterations and ``evaluate()`` (the
   deep torch recursion, replayed likewise, no kernel);
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
   ``MultiChainTrainer`` for 250 iterations (aggregate chain-iterations/s
   beside phase 4's single-chain rate, split-R̂ over the tail), its 8×10
   ``multichain_moments`` rollouts in one launch, kernels and host syncs
   of 8 chains against one; C5 as 4 chains for 20 iterations, thinned on
   the batched gradient, 4×10 rows in one per-sample launch;
4j. BASELINE config 5 in fp32: all six datasets at M=512 in one
   ``MultiDatasetTrainer`` step, 200 warm-up and 200 timed iterations,
   kernels, host syncs and device time by kernel class an iteration, then
   ``evaluate()``: one grouped launch of the six datasets' 60 rows on the
   global-memory plan;
5e. the float64 collapsed segment, cuda against CPU: ``ds_collapsed_terms``
   at the ballbeam warm start in fp32 (values and gradients), and 3 ds64
   C4 iterations with fp64 leaves;
5f. chains in fp64, cuda against CPU: 3 chains of C4 for 20 iterations, 2
   of C5 for 3 with injected draws; a checkpoint resume on the card (C5
   fp32, the CUDA generator restored) bit-equal to the uninterrupted run;
7. the mesh half of ``parallel/`` across processes (``phase_mesh``): 7a
   NCCL at world size 1, mesh (1, 1), 8 C4 chains fp32, captured and
   eagerly, both bit-equal to one process; 7b gloo, 4 ranks sharing the
   card, dp=2 × ep=2: C4 and C5 chains in fp64 against one process, the
   chains' moments in 2 launches of 40 rows against one of 80, 200 fp32
   iterations timed, six datasets × M=512 and their ``evaluate()``, and
   the capture rule (the step all-reduces over 'ep' on gloo: the default
   ran it eagerly, ``capture=True`` raised); 7c gloo, 4 ranks, sp=4: kink
   N=5000 C4 in fp64 against one process, fp32 timed; 7e gloo, the same 4
   ranks, dp=4 × ep=1, each rank's step captured: 8 C4 chains fp64 for
   20 iterations, 4 C5 chains for 3, 4 C6 chains (P=100) for 3 and 4 deep
   flutter C4 chains for 3, each against its eager run (rtol 1e-12) and
   one process (1e-10), one replay an iteration, 3 more under sync debug
   "error"; the C4 chains' moments in 4 launches of 20 rows (rows offset)
   against one of 80, the C5 chains' captured thinning (10 × 32
   sub-steps) and the deep chains' captured recursion against eager; 8 C4
   chains fp32, 200 iterations captured and 200 eager, ms an iteration
   beside one process's captured 8 chains; 7d 7b and 7c on NCCL over 4
   cards, eagerly and under the default (captured: the all-reduces inside
   a graph that lives for one call), with 4 C6 chains over 'ep', each
   against its eager twin (1e-12) and one card (1e-10), one replay an
   iteration, 2 more under "error"; the C4 chains' launches against the
   plain rollout; a checkpoint of 8 C4 chains saved every 500 of 1000
   iterations, resumed bit-equal, ms an iteration beside the
   uninterrupted run; every rank's ``destroy_process_group`` returning
   with its trainers held; or ``{"phase": "7d", "ran": false,
   "cards": n}``;
8a. checkpoints of a meshed run, in 7b's 4 gloo ranks sharing the card,
   dp=2 × ep=2, 8 ballbeam C4 chains fp32, 10 iterations, a checkpoint, a
   restore into a fresh state, 10 more: bit-equal to 20 uninterrupted meshed
   iterations, one file a checkpoint, and the file restored into one
   process is the state the mesh restored, bit for bit;
8b. the same ranks with sp=4: kink N=5000 C4 on windows of 256, fp64 for
   10 iterations within rtol 1e-10 of one process's windowed ``Trainer``,
   fp32 timed beside one process;
8c. ``scripts/bench_torch.py``'s measurement in this process at
   ``--quick``, its JSON line printed, and its rollout launches;
8d. the eight examples of ``examples_torch/`` in this process at
   ``--quick``, each one's rollout launches;
9. captured against eager (``utils/graphs.py``): fp64 on the card,
   ``run(capture=False)`` against ``run(capture=True)`` from equal states
   with the same draws, the trace and every state tensor within rtol 1e-12
   (bit-equal by construction): ballbeam C4 over 200 iterations, C5 with
   injected draws and from a CUDA generator, C6 with injected sweep draws,
   deep flutter C4 and the kink N=5000 W=256 window with injected draws, 8
   C4 chains; one graph replay an iteration; 5 more replays of each under
   ``torch.cuda.set_sync_debug_mode("error")``; C5's thinning, 10 × 32
   sub-steps eager against captured, one replay a sub-step, again under
   "error".  Then fp32 rates of one trainer each, an eager span then a
   captured one in this call: C4, C5 (and its ``evaluate()`` ms eager and
   captured), C2, C6, deep flutter C4, kink W=256, 8 C4 chains, six
   datasets × M=512; capture seconds and graph pool MiB; and the
   branch-free Cholesky retry's cost against one factorisation at C4's
   shapes, timed inside a graph;
10. the batched recursion and the batched sweep: fp64 on the card, the
   LinearK and deep rollouts with ``capture=False`` against
   ``capture=True`` (one captured step replayed a step) within rtol 1e-12
   for deep flutter C4 (iid, one group of 10 rows), LinearK ballbeam C4
   (iid), deep flutter C5 (thinned, 4 groups of one) and 4 LinearK chains
   (``multichain_moments``, 4 groups of 10), each recursion once more
   under sync debug "error"; 8 ballbeam C6 chains (P=100) for 3
   iterations, the batched sweep against per-member sweeps (the swept x
   and the nll trace) and the captured batched step against the eager
   one (the whole state) within rtol 1e-12, 2 more replays under
   "error".  Then fp32 times in this call: ``evaluate()`` eager and
   captured for deep flutter C4, LinearK ballbeam C4 and deep flutter C5
   (10 × 32 thinning), the captured step's kernels and busy share; 8 C6
   chains captured with per-member sweeps against the batched sweep,
   beside phase 9's one chain, with kernels a replay, busy share, capture
   seconds and graph pool MiB;
11. the study runner (``scripts/study_torch.py``) at ``--quick`` in this
   process, into a temporary file: ballbeam C4, C5 and C6 and the drive
   12k arm's native and ds64 runs, each record finite with the fields the
   study's pins read, the header naming the card, one rollout launch an
   ``evaluate()``; a second call skips every tag; 11b, the other arm
   families at ``--quick``: C6 live, C6 P=500 and drive C6 as chains
   groups, a C4 ensemble, the kink cold start under hybrid and ballbeam
   C6 in fp64 on the card, one launch an ``evaluate()``; 11c, the last
   arms at ``--quick``: flutter C5 and 12k in fp64, drive at x_dim 2, 4
   and 6 (BASELINE config 4), one launch an ``evaluate()``, and LinearK
   on gas_furnace and dryer (config 2), none; then the kernel at drive
   x_dim 6's trained inputs (a cluster of six CTAs, 20 rollouts) against
   the plain rollout;
6. kernel timing with CUDA events at S=10 and S=64, shared and per-sample
   inputs, with the launch plan; fp32 at 80 per-sample rows and at M=512
   (global plan); the six-dataset evaluation's grouped launch (10 rows of
   each of the six test lengths, M=512, fp32) beside its six separate
   launches, each group's rows bit-equal to its own launch; and one
   ``{"kernels": [...]}`` line.

Every training ``run``, thinning and LinearK or deep rollout above takes
the default, a replayed CUDA graph on the card (a meshed step whose
all-reduces run on gloo, 7b and 7c, stays eager); phases 7, 9 and 10 and
the profile script (``scripts/profile_torch_train.py``) set
``capture=False`` to compare.

``python3 chip_smoke.py --nccl-cards`` builds the kernel and runs phases
2, 2b, 7d and 6, on a machine with 4 cards, and prints a kernels line
whose launches are 7d's (report: ``chiprun_out/chip_smoke_nccl_report.json``).

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
# Ballbeam C4's 30-step RMSE band: at most the TF reference's (PARITY §2).
RMSE_BAND_C4 = 0.0282
# Phase 4i's depth, short enough to leave the script's time to later phases.
CHAIN_ITERATIONS = 250
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
    check(res["rmse"] <= RMSE_BAND_C4,
          f"C4 RMSE {res['rmse']} above PARITY §2's band {RMSE_BAND_C4}")
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
    kernel hypers sampled, collapsed q(U) per thinned sample) for 70
    iterations, the window full after 64 and wrapped; then C2 (hypers and U
    sampled, no q_sqrt) for 20.  Depth is cut from the protocol's 4000
    iterations to stay inside the run's time limit."""
    t0 = time.time()
    c5 = _sampler_path(torch, ro, card, 5, 70)
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
    # in a CUDA graph needs that); kernel_precal and the draws are timed
    # apart above.
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
    shapes): ``fit(250)`` (the protocol runs 4000) and ``evaluate()``, with
    the launch count set to 0 just before and read just after.  The deep
    rollout is the torch recursion, so no kernel launches.  The training
    nll is doubly stochastic, so its fall is read on the means of the
    first and last 50 iterations."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    cfg = FFVDConfig(dataset="flutter", case=4, n_layers=2)
    iterations = 250
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
    import inspect
    import types

    def rollout(*args, **kw):
        got = inspect.signature(ro.rollout).bind(*args, **kw).arguments
        seen.update(lm_inv=got["lm_inv"], q_sqrt=got["q_sqrt"])
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
    for 250 iterations, then ``multichain_moments``: all 8×10 rollouts in
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
    by kernel class of 10 profiled iterations; then ``evaluate()``: one
    grouped launch of every dataset's rows on the kernel's global-memory
    plan."""
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
    emit("six_datasets_m512", **out, rollout_groups=ro.rollout.last_groups)
    check(bool(torch.isfinite(warm).all() and torch.isfinite(timed_nll).all()),
          "six datasets: non-finite nll")
    check(all(float(a) > float(b) for a, b in zip(warm[0], timed_nll[-1])),
          f"six datasets: an nll did not decrease {out['nll_first']} -> "
          f"{out['nll_last']}")
    check(launches_fit == 0 and launches_eval == 1
          and ro.rollout.last_groups == 6
          and [e["rows"] for e in log] == [60]
          and all(not e["plan"]["resident"] for e in log),
          f"six datasets: launches {launches_fit}/{launches_eval} "
          f"groups {ro.rollout.last_groups} {log}")
    check(all(math.isfinite(r["rmse"]) and math.isfinite(r["nll"])
              for r in res.values()), f"six datasets: {res}")
    return launches_fit + launches_eval


def _rel_diff(torch, a, b):
    """max |a − b| / max(max |b|, tiny) of two tensors of one shape."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300)) \
        if a.numel() else 0.0


def _hold_equal(torch, what, a, b, trace_a, trace_b, rtol=1e-12):
    """The eager run (``a``, ``trace_a``) against the captured one: the
    trace and every tensor of the state within ``rtol`` of the scale of
    each, and whether all of it is bit-equal."""
    pairs = [(trace_a, trace_b)] + list(zip(a.tensors(), b.tensors()))
    worst = max(_rel_diff(torch, x, y) for x, y in pairs)
    same = all(torch.equal(x, y) for x, y in pairs)
    check(len(a.tensors()) == len(b.tensors()) and worst <= rtol,
          f"captured vs eager, {what}: max rel diff {worst}")
    return {"max_rel_diff": worst, "bit_equal": same,
            "tensors": len(pairs)}


def _no_syncs(torch, fn):
    """Run ``fn`` with the card's sync debug mode at "error": any host
    synchronisation inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _graph_info(step_graph):
    return {"replays": step_graph.replays,
            "capture_s": step_graph.capture_s,
            "pool_MiB": None if step_graph.pool_bytes is None
            else step_graph.pool_bytes / 2 ** 20}


def _captured_holds(torch):
    """Phase 9's holds: fp64 on the card, eager ``run(capture=False)`` and
    captured ``run(capture=True)`` from equal fresh states with the same
    draws (injected on the card, or from two equal CUDA generators); then
    more replays of each captured trainer under sync debug "error"."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import generate_kink
    from ffvd_tpu_torch.eval.rollout import thin_posterior
    from ffvd_tpu_torch.inference import particle_gibbs as pg
    from ffvd_tpu_torch.inference.trainer import SUBSTEP_FLAGS, Trainer
    from ffvd_tpu_torch.model.params import init_params_random
    from ffvd_tpu_torch.parallel import MultiChainTrainer
    from ffvd_tpu_torch.utils.graphs import WARMUP
    f64 = torch.float64
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    out = {}

    def hold(name, tr, fresh, n, draws=None, seed=None, more=5):
        a, b = fresh(), fresh()
        ga, gb = (None, None) if seed is None else (gen(seed), gen(seed))
        t0 = time.time()
        _, ta = tr.run(a, n, draws=draws, generator=ga, capture=False)
        t1 = time.time()
        _, tb = tr.run(b, n, draws=draws, generator=gb, capture=True)
        torch.cuda.synchronize()
        t2 = time.time()
        res = _hold_equal(torch, name, a, b, ta, tb)
        replays = tr._graph.graph.replays
        check(replays == n - WARMUP,
              f"{name}: {replays} replays for {n} iterations")
        extra = None if draws is None else draws[:more]
        _no_syncs(torch, lambda: tr.run(b, more, draws=extra, generator=gb,
                                        capture=True, nan_check=False))
        check(tr._graph.graph.replays == replays + more,
              f"{name}: a captured iteration is not one replay")
        out[name] = {**res, "iterations": n, "eager_s": t1 - t0,
                     "captured_s": t2 - t1, "replays_under_sync_error":
                     more, **_graph_info(tr._graph.graph)}

    _, data, p0 = _cuda_data(torch, "ballbeam", f64)
    c4 = Trainer(FFVDConfig(dataset="ballbeam", case=4), data)
    hold("C4", c4, lambda: c4.init_state(p0), 200)

    c5 = Trainer(FFVDConfig(dataset="ballbeam", case=5), data)
    sub = c5.subset.split(p0)
    g = gen(91)
    draws = [{"noise": {k: torch.randn((len(SUBSTEP_FLAGS),) + tuple(v.shape),
                                       generator=g, dtype=f64, device="cuda")
                        for k, v in sub.items()},
              "feed": torch.randint(0, min(i + 1, 64), (1,), generator=g,
                                    device="cuda")} for i in range(10)]
    hold("C5_injected", c5, lambda: c5.init_state(p0), 10, draws)
    hold("C5_generator", c5, lambda: c5.init_state(p0), 10, seed=92)
    # the thinning sub-step from the warm start: 10 samples × 32 sub-steps,
    # eager and captured, from two equal CUDA generators
    gb = gen(97)
    sa, ma = thin_posterior(c5, c5.init_state(p0), S, 32, gen(97),
                            capture=False)
    sb, mb = thin_posterior(c5, c5.init_state(p0), S, 32, gb, capture=True)
    worst = max(_rel_diff(torch, p.leaves()[k], q.leaves()[k])
                for p, q in zip(sa + [ma.params], sb + [mb.params])
                for k in c5.subset.paths)
    check(worst <= 1e-12, f"thinning: captured vs eager {worst}")
    thin_replays = c5._thin_graph.graph.replays
    check(thin_replays == S * 32 - WARMUP,
          f"thinning: {thin_replays} replays for {S * 32} sub-steps")
    _no_syncs(torch, lambda: thin_posterior(c5, mb, S, 32, gb,
                                            capture=True))
    check(c5._thin_graph.graph.replays == thin_replays + S * 32,
          "thinning: a sub-step is not one replay")
    out["C5_thinning"] = {"samples": S, "spacing": 32, "max_rel_diff": worst,
                          **_graph_info(c5._thin_graph.graph)}

    cfg6 = FFVDConfig(dataset="ballbeam", case=6)
    c6 = Trainer(cfg6, data, pg_fn=pg.make_pg_fn(cfg6))
    g = gen(93)
    draws = [{"pg": pg.pg_draws(cfg6, p0, g)} for _ in range(8)]
    hold("C6_injected", c6, lambda: c6.init_state(p0), 3, draws)

    deep = FFVDModel(FFVDConfig(dataset="flutter", case=4, n_layers=2),
                     device="cuda", dtype=f64)
    dt = deep.trainer
    g = gen(94)
    draws = [dt.grad_draws(1, g, deep.params.x) for _ in range(10)]
    hold("deep_C4_injected", dt, lambda: dt.init_state(deep.params), 5,
         draws)

    n = 5000
    kink = FFVDModel(FFVDConfig(dataset="kink", case=4, minibatch_size=256),
                     device="cuda", dtype=f64, dataset=generate_kink(n=n),
                     params=init_params_random(
                         n, 4, 100, 0, generator=torch.Generator()
                         .manual_seed(0), device="cuda", dtype=f64))
    kt = kink.trainer
    g = gen(95)
    draws = [kt.grad_draws(1, g, kink.params.x) for _ in range(10)]
    hold("window_kink_N5000_W256_injected", kt,
         lambda: kt.init_state(kink.params), 5, draws)

    mct = MultiChainTrainer(FFVDConfig(dataset="ballbeam", case=4), data, 8)
    stacked = mct.stack_params(p0, gen(96))
    hold("C4x8_chains", mct, lambda: mct.init_state(stacked), 50)
    return out


def _rate(torch, fn, n):
    """it/s of ``fn(n)``, the card synchronised around it."""
    torch.cuda.synchronize()
    t = time.time()
    fn(n)
    torch.cuda.synchronize()
    return n / (time.time() - t)


def _captured_rates(torch, main):
    """Phase 9's rates, fp32: each trainer runs an eager span, then its
    first captured call (warm-up and capture), then a timed captured span,
    in this call; the C4 protocol rate of phase 4 beside them."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import DATASETS, FFVDConfig
    from ffvd_tpu_torch.data import generate_kink
    from ffvd_tpu_torch.model.params import init_params_random
    from ffvd_tpu_torch.parallel import (MultiChainTrainer,
                                         MultiDatasetTrainer, stack_datasets)
    from ffvd_tpu_torch.utils.graphs import WARMUP
    out = {}

    def model_rates(name, model, eager_n, captured_n, evaluate=False):
        tr = model.trainer
        model.capture = False
        model.fit(1)
        eager = _rate(torch, model.fit, eager_n)
        model.capture = None
        torch.cuda.synchronize()
        t = time.time()
        model.fit(WARMUP + 1)                     # warm-up, capture, replay
        torch.cuda.synchronize()
        first = time.time() - t
        captured = _rate(torch, model.fit, captured_n)
        r = {"eager_it_per_s": eager, "captured_it_per_s": captured,
             "speedup": captured / eager, "eager_iterations": eager_n,
             "captured_iterations": captured_n,
             "first_captured_call_s": first, **_graph_info(tr._graph.graph)}
        if evaluate:
            ms = {}
            for mode, cap in (("eager", False), ("captured_first", None),
                              ("captured", None)):
                model.capture = cap
                torch.cuda.synchronize()
                t = time.time()
                res = model.evaluate()
                torch.cuda.synchronize()
                ms[mode] = (time.time() - t) * 1e3
                check(math.isfinite(res["rmse"]), f"{name}: evaluate {res}")
            r["evaluate_ms"] = ms
            r["thin_graph"] = _graph_info(tr._thin_graph.graph)
        check(all(math.isfinite(v) for v in model.nll_trace[-5:].tolist()),
              f"{name}: non-finite nll")
        out[name] = r

    def trainer_rates(name, tr, state, gen, eager_n, captured_n):
        run = lambda cap: (lambda n: tr.run(state, n, generator=gen,
                                            capture=cap))
        run(False)(1)
        eager = _rate(torch, run(False), eager_n)
        torch.cuda.synchronize()
        t = time.time()
        run(True)(WARMUP + 1)
        torch.cuda.synchronize()
        first = time.time() - t
        captured = _rate(torch, run(True), captured_n)
        out[name] = {"eager_it_per_s": eager, "captured_it_per_s": captured,
                     "speedup": captured / eager, "eager_iterations": eager_n,
                     "captured_iterations": captured_n,
                     "first_captured_call_s": first,
                     **_graph_info(tr._graph.graph)}

    model_rates("C4", FFVDModel(FFVDConfig(dataset="ballbeam", case=4),
                                device="cuda"), 300, 2000)
    out["C4"]["phase4_protocol_captured_it_per_s"] = main["train_it_per_s"]
    model_rates("C5", FFVDModel(FFVDConfig(dataset="ballbeam", case=5),
                                device="cuda"), 5, 40, evaluate=True)
    model_rates("C2", FFVDModel(FFVDConfig(dataset="ballbeam", case=2),
                                device="cuda"), 5, 40)
    model_rates("C6", FFVDModel(FFVDConfig(dataset="ballbeam", case=6),
                                device="cuda"), 3, 20)
    model_rates("deep_flutter_C4", FFVDModel(
        FFVDConfig(dataset="flutter", case=4, n_layers=2), device="cuda"),
        60, 300)
    n = 5000
    model_rates("window_kink_N5000_W256", FFVDModel(
        FFVDConfig(dataset="kink", case=4, minibatch_size=256),
        device="cuda", dataset=generate_kink(n=n),
        params=init_params_random(n, 4, 100, 0, generator=torch.Generator()
                                  .manual_seed(0), device="cuda",
                                  dtype=torch.float32)), 60, 300)
    _, data, p0 = _cuda_data(torch, "ballbeam", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mct = MultiChainTrainer(FFVDConfig(dataset="ballbeam", case=4), data, 8)
    trainer_rates("C4x8_chains", mct, mct.init_state(mct.stack_params(
        p0, gen)), gen, 60, 300)
    out["C4x8_chains"]["captured_chain_it_per_s"] = \
        8 * out["C4x8_chains"]["captured_it_per_s"]
    sdata, sparams, _ = stack_datasets(DATASETS, device="cuda",
                                       dtype=torch.float32, m=512)
    mdt = MultiDatasetTrainer(FFVDConfig(dataset="ballbeam", case=4,
                                         num_inducing=512), sdata)
    trainer_rates("six_datasets_m512", mdt, mdt.init_state(sparams), gen,
                  20, 100)
    return out


def _retry_cost(torch):
    """The branch-free Cholesky retry against the one factorisation that a
    healthy element needed before, at C4's shapes (D=4 blocks of 100×100,
    fp32), as the captured step pays it: 20 calls captured in a CUDA graph,
    10 replays timed with CUDA events (eager calls would time their
    launches); and the calls in one C4 iteration."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.ops import chol
    from ffvd_tpu_torch.utils import graphs
    g = torch.Generator(device="cuda").manual_seed(7)
    b = torch.randn((4, 100, 100), generator=g, device="cuda")
    a = b @ b.mT / 100 + torch.eye(100, device="cuda")

    def per_call_us(fn, calls=20, replays=10):
        step = graphs.StepGraph(lambda d: [fn() for _ in range(calls)], {},
                                True)
        for _ in range(graphs.WARMUP + 1):      # warm-ups, then the capture
            step({})
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            step({})
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (calls * replays) * 1e3

    one = per_call_us(lambda: torch.linalg.cholesky_ex(a))
    three = per_call_us(lambda: chol._psd_cholesky_impl(a, 1e-4))
    calls, impl = [], chol._psd_cholesky_impl
    chol._psd_cholesky_impl = lambda m, j: calls.append(m.shape) or impl(m, j)
    try:
        _, data, p0 = _cuda_data(torch, "ballbeam", torch.float32)
        tr = Trainer(FFVDConfig(dataset="ballbeam", case=4), data)
        tr.outer_step(tr.init_state(p0))
    finally:
        chol._psd_cholesky_impl = impl
    return {"shape": [4, 100, 100], "dtype": "fp32", "timed": "in a graph",
            "one_factorisation_us": one, "branch_free_us": three,
            "added_us_per_call": three - one,
            "calls_per_C4_iteration": len(calls),
            "added_us_per_C4_iteration": (three - one) * len(calls)}


def phase_captured(torch, card, main):
    """Phase 9: captured against eager, on the card (see the module
    docstring)."""
    t0 = time.time()
    backend = str(torch.backends.cuda.preferred_linalg_library())
    holds = _captured_holds(torch)
    rates = _captured_rates(torch, main)
    retry = _retry_cost(torch)
    emit("captured_vs_eager", card=card, linalg_backend=backend,
         holds=holds, rates_fp32=rates, cholesky_retry=retry,
         seconds=time.time() - t0)
    return {"holds": holds, "rates": rates}


def _collected(torch):
    """Collect the cyclic garbage of earlier phases and synchronise, so
    that freeing it is not timed."""
    import gc
    gc.collect()
    torch.cuda.synchronize()


def _per_member_trainer(torch):
    """A ``MultiChainTrainer`` whose C6 sweeps run one member at a time,
    as ``BatchedTrainer._pg`` ran them before the sweep was batched: the
    reference of phase 10's sweep hold and rates."""
    import dataclasses
    from ffvd_tpu_torch.parallel import MultiChainTrainer
    from ffvd_tpu_torch.parallel.sharding import member

    class PerMember(MultiChainTrainer):
        def _pg(self, params, generator, pg):
            xs = [self.pg_fn(member(params, i), generator, self.data,
                             draws=None if pg is None else pg[i]).x
                  for i in range(self.n)]
            return dataclasses.replace(params, x=torch.stack(xs))
    return PerMember


def _recursion_holds(torch):
    """Phase 10's recursion holds, fp64: each cell's rollouts with
    ``capture=False`` (the step run eagerly) and ``capture=True`` (one
    captured step, replayed), from equal CUDA generators; one replay a
    step; then the captured recursion once more under sync debug
    "error"."""
    import dataclasses
    import numpy as np
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.eval.ensemble import multichain_moments
    from ffvd_tpu_torch.eval.rollout import collect_posterior
    from ffvd_tpu_torch.parallel import MultiChainTrainer
    from ffvd_tpu_torch.utils.graphs import WARMUP
    f64 = torch.float64
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    out = {}

    def hold(name, tr, run):
        a, b = run(False), run(True)
        pairs = [(torch.as_tensor(np.asarray(x)), torch.as_tensor(
            np.asarray(y))) if not torch.is_tensor(x) else (x, y)
            for x, y in zip(a, b)]
        worst = max(_rel_diff(torch, x, y) for x, y in pairs)
        same = all(torch.equal(x, y) for x, y in pairs)
        check(worst <= 1e-12, f"{name}: captured vs eager {worst}")
        g = tr._rollout_graph
        steps, replays = g.xs.shape[2], g.graph.replays
        check(g.graph.captured and replays == steps - WARMUP,
              f"{name}: {replays} replays for {steps} steps")
        _no_syncs(torch, lambda: g.run(g.static))
        check(g.graph.replays == replays + steps,
              f"{name}: a step is not one replay")
        out[name] = {"max_rel_diff": worst, "bit_equal": same,
                     "groups_rows": list(g.xs.shape[:2]), "steps": steps,
                     "replays_under_sync_error": steps, **_graph_info(g.graph)}

    deep = FFVDModel(FFVDConfig(dataset="flutter", case=4, n_layers=2),
                     device="cuda", dtype=f64)
    hold("deep_C4_iid", deep.trainer, lambda cap: collect_posterior(
        deep.trainer, deep.state, deep.dataset.n_test, generator=gen(1),
        capture=cap)[:2])
    lin = FFVDModel(FFVDConfig(dataset="ballbeam", case=4,
                               kernel_type="LinearK"), device="cuda",
                    dtype=f64)
    hold("LinearK_C4_iid", lin.trainer, lambda cap: collect_posterior(
        lin.trainer, lin.state, lin.dataset.n_test, generator=gen(2),
        capture=cap)[:2])
    # thinned: 4 samples, 4 sub-steps apart (the protocol's 10 × 32 is
    # timed in the rates below)
    d5 = FFVDModel(dataclasses.replace(
        FFVDConfig(dataset="flutter", case=5, n_layers=2),
        num_posterior_samples=4, posterior_sample_spacing=4),
        device="cuda", dtype=f64)
    hold("deep_C5_thinned", d5.trainer, lambda cap: collect_posterior(
        d5.trainer, d5.state, d5.dataset.n_test, generator=gen(3),
        thin_generator=gen(4), capture=cap)[:2])
    ds, data, p0 = _cuda_data(torch, "ballbeam", f64)
    mct = MultiChainTrainer(FFVDConfig(dataset="ballbeam", case=4,
                                       kernel_type="LinearK"), data, 4)
    state = mct.init_state(mct.stack_params(p0, gen(5)))
    hold("LinearK_C4x4_chains", mct, lambda cap: [
        a for ch in multichain_moments(mct, state, ds.n_test,
                                       generator=gen(6), capture=cap)[0]
        for a in ch])
    return out


def _sweep_holds(torch):
    """Phase 10's sweep holds, fp64: 8 ballbeam C6 chains (P=100) for 3
    iterations from equal CUDA generators, the batched sweep against the
    per-member sweeps (both eager): the swept trajectories x and the nll
    trace within rtol 1e-12, the rest of the state recorded; and the
    captured batched step against the eager one, the whole state within
    rtol 1e-12; then 2 more replays under sync debug "error".

    The batched and the per-member sweeps are one computation, but not the
    same kernels: cuBLAS and cuSOLVER round a batch of 32 blocks apart
    from 8 batches of 4 (Lm⁻¹ 6.9e-16 apart), x ends ≈1e-13 apart and the
    gradient of z ≈40 times that, so Adam's moments of z differ by
    1.4-3.5e-12 (read on an H100 80GB HBM3 at 700 W).  The hold reads the
    sweep's own output."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.parallel import MultiChainTrainer
    from ffvd_tpu_torch.utils.graphs import WARMUP
    f64 = torch.float64
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    cfg = FFVDConfig(dataset="ballbeam", case=6)
    _, data, p0 = _cuda_data(torch, "ballbeam", f64)
    batched = MultiChainTrainer(cfg, data, 8, pg_fn=make_pg_fn(cfg))
    per = _per_member_trainer(torch)(cfg, data, 8, pg_fn=make_pg_fn(cfg))
    stacked = batched.stack_params(p0, gen(7))
    a, b, c = (tr.init_state(stacked) for tr in (per, batched, batched))
    t0 = time.time()
    _, ta = per.run(a, 3, generator=gen(8), capture=False)
    t1 = time.time()
    _, tb = batched.run(b, 3, generator=gen(8), capture=False)
    t2 = time.time()
    gc = gen(8)
    _, tc = batched.run(c, 3, generator=gc, capture=True)
    torch.cuda.synchronize()
    sweep = {"x": _rel_diff(torch, b.params.x, a.params.x),
             "nll_trace": _rel_diff(torch, tb, ta)}
    check(max(sweep.values()) <= 1e-12,
          f"C6x8: batched vs per-member sweeps {sweep}")
    out = {"chains": 8, "iterations": 3,
           "batched_vs_per_member": {
               **sweep, "bit_equal": all(torch.equal(x, y) for x, y in zip(
                   a.tensors(), b.tensors())),
               "whole_state_max_rel_diff": max(
                   _rel_diff(torch, y, x) for x, y in zip(a.tensors(),
                                                          b.tensors()))},
           "captured_vs_eager": _hold_equal(
               torch, "C6x8 captured vs eager", b, c, tb, tc),
           "per_member_eager_s": t1 - t0, "batched_eager_s": t2 - t1}
    check(not torch.equal(b.params.x[0], b.params.x[1]),
          "C6x8: the chains' trajectories are equal")
    replays = batched._graph.graph.replays
    check(replays == 3 - WARMUP, f"C6x8: {replays} replays for 3 iterations")
    _no_syncs(torch, lambda: batched.run(c, 2, generator=gc, capture=True,
                                         nan_check=False))
    check(batched._graph.graph.replays == replays + 2,
          "C6x8: an iteration is not one replay")
    out.update(replays_under_sync_error=2,
               **_graph_info(batched._graph.graph))
    return out


def _recursion_and_sweep_rates(torch, one_chain_c6):
    """Phase 10's times, fp32, in this call: ``evaluate()`` eager
    (``capture=False``), then captured twice (the first call warms up and
    captures) for deep flutter C4, LinearK ballbeam C4 and deep flutter C5
    (thinned, 10 × 32), with the captured step profiled over one
    recursion; and 8 ballbeam C6 chains (P=100) captured, per-member sweeps
    against the batched sweep, each with its kernels a replay and busy
    share, beside ``one_chain_c6``, phase 9's captured C6 it/s."""
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
    from ffvd_tpu_torch.parallel import MultiChainTrainer
    from ffvd_tpu_torch.utils.graphs import WARMUP
    from ffvd_tpu_torch.utils.profiling import profile_window, summarize
    out = {}

    def evaluate_ms(name, cfg, fit_n):
        t0 = time.time()
        model = FFVDModel(cfg, device="cuda")
        model.fit(fit_n)
        ms = {}
        for mode, cap in (("eager", False), ("captured_first", None),
                          ("captured", None)):
            model.capture = cap
            _collected(torch)
            t = time.time()
            res = model.evaluate()
            torch.cuda.synchronize()
            ms[mode] = (time.time() - t) * 1e3
            check(math.isfinite(res["rmse"]) and math.isfinite(res["nll"]),
                  f"{name}: evaluate {res}")
        g = model.trainer._rollout_graph
        check(g.graph.captured, f"{name}: the default evaluate() did not "
              "replay a captured step")
        prof, wall = profile_window(lambda: g.run(g.static))
        summ = summarize(prof, wall, g.xs.shape[2])
        out[name] = {"evaluate_ms": ms, "speedup": ms["eager"] / ms[
            "captured"], "seconds": time.time() - t0,
            "rmse": res["rmse"], "nll": res["nll"],
            "fit_iterations": fit_n, "groups_rows": list(g.xs.shape[:2]),
            "steps": g.xs.shape[2], "recursion_ms_profiled": wall / 1e3,
            "kernels_per_replay": summ["cuda_kernels"],
            "device_busy_share": summ["device_busy_share"],
            **_graph_info(g.graph)}

    evaluate_ms("deep_flutter_C4", FFVDConfig(dataset="flutter", case=4,
                                              n_layers=2), 5)
    evaluate_ms("LinearK_ballbeam_C4", FFVDConfig(
        dataset="ballbeam", case=4, kernel_type="LinearK"), 5)
    evaluate_ms("deep_flutter_C5_thinned", FFVDConfig(
        dataset="flutter", case=5, n_layers=2), 5)

    cfg = FFVDConfig(dataset="ballbeam", case=6)
    _, data, p0 = _cuda_data(torch, "ballbeam", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    c6 = {"one_chain_it_per_s_phase9": one_chain_c6}
    for name, tr, timed, profiled in (
            ("per_member_x8", _per_member_trainer(torch)(
                cfg, data, 8, pg_fn=make_pg_fn(cfg)), 3, 1),
            ("batched_x8", MultiChainTrainer(cfg, data, 8,
                                             pg_fn=make_pg_fn(cfg)), 10, 2)):
        state = tr.init_state(tr.stack_params(p0, gen))
        _collected(torch)
        t = time.time()
        tr.run(state, WARMUP + 1, generator=gen)   # warm-ups, capture
        first = time.time() - t
        rate = _rate(torch, lambda n: tr.run(state, n, generator=gen), timed)
        t = time.time()
        prof, wall = profile_window(lambda: tr.run(state, profiled,
                                                   generator=gen))
        summ = summarize(prof, wall, profiled)
        profile_s = time.time() - t
        c6[name] = {"it_per_s": rate, "chain_it_per_s": rate * 8,
                    "timed_iterations": timed,
                    "first_captured_call_s": first,
                    "kernels_per_replay": summ["cuda_kernels"],
                    "device_busy_share": summ["device_busy_share"],
                    "ms_per_iter_profiled": wall / 1e3 / profiled,
                    "profile_s": profile_s,
                    **_graph_info(tr._graph.graph)}
        check(all(math.isfinite(v) for v in
                  tr.run(state, 1, generator=gen)[1].flatten().tolist()),
              f"C6 {name}: non-finite nll")
    c6["batched_over_per_member"] = (c6["batched_x8"]["it_per_s"]
                                     / c6["per_member_x8"]["it_per_s"])
    out["C6x8_chains"] = c6
    return out


def phase_batched(torch, card, captured):
    """Phase 10: the batched recursion and the batched sweep (see the
    module docstring); ``captured``: phase 9's results."""
    t0 = time.time()
    _collected(torch)
    recursion = _recursion_holds(torch)
    sweep = _sweep_holds(torch)
    rates = _recursion_and_sweep_rates(
        torch, captured["rates"]["C6"]["captured_it_per_s"])
    emit("batched_recursion_and_sweep", card=card,
         recursion_holds_fp64=recursion, sweep_holds_fp64=sweep,
         rates_fp32=rates, seconds=time.time() - t0)
    return {"recursion": recursion, "sweep": sweep, "rates": rates}


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

def _chain_spec(name, c, case, dtype, iters, seed=0, n_layers=1, **extra):
    """A ``rank_jobs`` spec: ``name``'s warm start (with ``n_layers`` − 1
    near-identity hidden layers, as ``FFVDModel`` grafts them) stacked over
    ``c`` chains, each leaf + 1e-3·N(0, 1) a chain (numpy, ``seed``)."""
    import dataclasses

    import numpy as np
    import torch

    from ffvd_tpu_torch.data import create_dataset, load_warmstart
    from ffvd_tpu_torch.model.params import (init_hidden_layers,
                                             init_params_from_warmstart,
                                             params_to_numpy)
    ds = create_dataset(name)
    params = init_params_from_warmstart(load_warmstart(name))
    if n_layers > 1:
        params = dataclasses.replace(params, hidden=init_hidden_layers(
            n_layers - 1, params, generator=torch.Generator().manual_seed(
                seed)))
    one = params_to_numpy(params)
    rng = np.random.RandomState(seed)
    leaves = {k: np.stack([v + 1e-3 * rng.randn(*v.shape) for _ in range(c)])
              for k, v in one.items()}
    return dict(cfg=dict(dataset=name, case=case, n_layers=n_layers),
                dtype=dtype, leaves=leaves, y=ds.y_train, control=ds.control,
                iters=iters, seed=seed, **extra)


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
    # one grouped launch a 'dp' group (its 'ep'-index-0 rank, 3 datasets)
    check(sum(x["launches"] for x in six) == (2 if on_card else 0)
          and sorted(sum(rep["six_m512"]["launch_rows_by_rank"], []))
          == ([30, 30] if on_card else [])
          and not any(rep["six_m512"]["resident"])
          and all(x["results"] == res for x in six)
          and all(math.isfinite(v["rmse"]) and math.isfinite(v["nll"])
                  for v in res.values())
          and bool(torch.isfinite(six[0]["trace"]).all()),
          f"{what} six datasets: {rep['six_m512']}")
    return rep


def _check_sp(torch, ranks, singles, what, on_card=True, prefix="kink"):
    """7c's (and, ``prefix="kink_window"``, 8b's) checks: the jobs
    ``<prefix>_fp64`` and ``<prefix>_fp32_timed`` of the ranks against the
    one-process runs."""
    f64, f32 = f"{prefix}_fp64", f"{prefix}_fp32_timed"
    rels = [_diff(torch, r[f64][0], singles[f64], 1e-10, 1e-12)
            for r in ranks]
    rep = {f64: {"max_rel_diff_vs_one_process": max(x[0] for x in rels),
                 "within_rtol_1e-10": all(x[1] for x in rels),
                 "seconds": [r[f64][1] for r in ranks]},
           f32: [r[f32][0]["timed"] for r in ranks],
           f"{prefix}_fp32_one_process": singles[f32]["timed"]}
    check(all(x[1] for x in rels), f"{what} {prefix}: {rep[f64]}")
    return rep


# 7e's replays of each captured step under sync debug "error".  Each 7e
# job runs twice in the same 4 gloo ranks sharing the card: with the
# default (captured: a 'dp'-only step issues no collective) and with
# ``capture=False``.  Its C4 specs are 7b's but for the mesh, so 7b's
# one-process runs serve them.
DP_ONLY_SYNC_REPLAYS = 3


def _dp_only_plan():
    """7e's jobs (name, kind, spec), captured then eager, and the specs."""
    dp = dict(mesh=(4, 1), sync_check=DP_ONLY_SYNC_REPLAYS)
    specs = {
        "C4x8_fp64": _chain_spec(
            "ballbeam", 8, 4, "float64", 20,
            moments=dict(test_len=T, seed=1, check_whole=True), **dp),
        "C5x4_thin_fp64": _chain_spec(
            "ballbeam", 4, 5, "float64", 3,
            moments=dict(test_len=T, seed=3), **dp),
        "C6x4_fp64": _chain_spec("ballbeam", 4, 6, "float64", 3, **dp),
        "deep_C4x4_fp64": _chain_spec(
            "flutter", 4, 4, "float64", 3, n_layers=2,
            moments=dict(test_len=T, seed=2), **dp),
        "C4x8_fp32_timed": _chain_spec("ballbeam", 8, 4, "float32", 10,
                                       timed=200, **dp)}
    plan = []
    for name, spec in specs.items():
        eager = dict(spec, capture=False, sync_check=None)
        if "moments" in spec:
            eager["moments"] = dict(spec["moments"], check_whole=False)
        plan += [(f"7e_{name}", "chains", spec),
                 (f"7e_{name}_eager", "chains", eager)]
    return plan, specs


def _check_dp_only(torch, ranks, singles, specs, what, on_card=True):
    """7e's checks on the ranks' results against their eager twins (1e-12
    of each tensor's scale, phases 9 and 10's bar) and the one-process
    runs on the card (1e-10 likewise; 2 chains a rank against 8 in one
    batch round apart): one replay an iteration, none of them syncing, the
    recursion and the C5 chains' thinning likewise (one replay a step or
    sub-step), the C4 chains' moments from 4 offset launches of 20 rows
    equal to one 80-row launch.  Returns the report."""
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.utils.graphs import WARMUP
    rep = {}
    for name in ("C4x8_fp64", "C5x4_thin_fp64", "C6x4_fp64",
                 "deep_C4x4_fp64"):
        cap = [r[f"7e_{name}"][0] for r in ranks]
        eag = [r[f"7e_{name}_eager"][0] for r in ranks]
        vs_eager = [_diff(torch, c, e, 1e-12, 0.0) for c, e in zip(cap, eag)]
        vs_one = [_diff(torch, c, singles[name], 1e-10, 1e-12) for c in cap]
        n = specs[name]["iters"]
        replays = [c["replays"] for c in cap]
        after = [c.get("replays_after_sync_check") for c in cap]
        want = n - WARMUP if on_card else None
        rep[name] = {
            "captured_vs_eager_max_rel_diff": max(x[0] for x in vs_eager),
            "captured_vs_eager_bit_equal": all(x[2] for x in vs_eager),
            "vs_one_process_max_rel_diff": max(x[0] for x in vs_one),
            "replays_by_rank": replays,
            "replays_after_sync_check_by_rank": after,
            "eager_replays_by_rank": [e["replays"] for e in eag],
            "step_collectives": cap[0]["step_collectives"],
            "seconds_captured": [r[f"7e_{name}"][1] for r in ranks],
            "seconds_eager": [r[f"7e_{name}_eager"][1] for r in ranks]}
        check(max(x[0] for x in vs_eager) <= 1e-12
              and max(x[0] for x in vs_one) <= 1e-10
              and all(x == want for x in replays)
              and all(x == (want + DP_ONLY_SYNC_REPLAYS if on_card else None)
                      for x in after)
              and all(e["replays"] is None for e in eag)
              and all(c["step_collectives"] == () for c in cap),
              f"{what} {name}: {rep[name]}")
        if "moments" in specs[name]:
            m_eager = max(max(_moments_diff(c["moments"], e["moments"]))
                          for c, e in zip(cap, eag))
            m_one = max(max(_moments_diff(c["moments"],
                                          singles[name]["moments"]))
                        for c in cap)
            rep[name].update(
                moments_captured_vs_eager=m_eager,
                moments_vs_one_process=m_one,
                rollout_calls_by_rank=[c["rollout_calls"] for c in cap],
                launch_rows_by_rank=[c["launch_rows"] for c in cap],
                launches_by_rank=[c["launches"] for c in cap],
                recursion_replays_by_rank=[c["rollout_replays"]
                                           for c in cap],
                thinning_replays_by_rank=[c["thin_replays"] for c in cap])
            check(m_eager <= 1e-12 and m_one <= 1e-10,
                  f"{what} {name} moments: {rep[name]}")
    c4 = [r["7e_C4x8_fp64"][0] for r in ranks]
    one = max(_moments_diff(c4[0]["moments"], c4[0]["moments_one_launch"]))
    rep["C4x8_fp64"]["moments_vs_one_80_row_launch"] = one
    check(rep["C4x8_fp64"]["rollout_calls_by_rank"]
          == [[(20, 20 * i)] for i in range(4)]
          and rep["C4x8_fp64"]["launch_rows_by_rank"]
          == ([[20]] * 4 if on_card else [[]] * 4) and one <= 1e-12,
          f"{what} C4 moments: {rep['C4x8_fp64']}")
    c5 = rep["C5x4_thin_fp64"]
    cfg5 = FFVDConfig(dataset="ballbeam", case=5)
    sub_steps = cfg5.num_posterior_samples * cfg5.posterior_sample_spacing
    check(c5["rollout_calls_by_rank"] == [[(10, 10 * i)] for i in range(4)]
          and c5["thinning_replays_by_rank"]
          == [sub_steps - WARMUP if on_card else None] * 4,
          f"{what} C5 thinning: {c5}")
    deep = rep["deep_C4x4_fp64"]
    check(deep["launches_by_rank"] == [0] * 4
          and deep["recursion_replays_by_rank"]
          == [T - WARMUP if on_card else None] * 4,
          f"{what} deep recursion: {deep}")
    timed = lambda key: [r[key][0]["timed"]["ms_per_iter"] for r in ranks]
    rep["C4x8_fp32"] = {
        "ms_per_iter_captured_by_rank": timed("7e_C4x8_fp32_timed"),
        "ms_per_iter_eager_by_rank": timed("7e_C4x8_fp32_timed_eager"),
        "one_process_8_chains_captured_ms_per_iter":
            singles["C4x8_fp32_timed"]["timed"]["ms_per_iter"],
        "iterations": specs["C4x8_fp32_timed"]["timed"]}
    return rep


# 7d's meshed checkpoint over NCCL: iterations of the run, saved every half.
NCCL_CK_ITERS = 1000


def _nccl_jobs():
    """7d's jobs beyond 7b's and 7c's: 4 ballbeam C6 chains (P=100) over
    dp=2 × ep=2 in fp64, whose step gathers the dims over 'ep'
    (``MeshBatchedTrainer.whole_dims``), and the meshed checkpoint of 8 C4
    chains in fp32 (``checkpoint_job``'s "full" mode: ``NCCL_CK_ITERS``
    iterations uninterrupted, then through ``run_with_checkpoints`` saving
    every half, restored there and run on).  Returns (the C6 job, the
    checkpoint job, its directory)."""
    import tempfile
    c6 = ("C6x4_ep_fp64", "chains",
          _chain_spec("ballbeam", 4, 6, "float64", 3, mesh=(2, 2)))
    ck_dir = tempfile.mkdtemp(prefix="ffvd_ckpt_nccl_")
    ck = ("ck_full", "checkpoint", _chain_spec(
        "ballbeam", 8, 4, "float32", NCCL_CK_ITERS, mesh=(2, 2),
        hold_trainer=True, trainer="chains", mode="full",
        first=NCCL_CK_ITERS // 2, dir=ck_dir))
    return c6, ck, ck_dir


def _nccl_plan(plan_b, plan_c, c6, ck):
    """7d's jobs: 7b's, 7c's and the C6 job eagerly (``capture=False``),
    then the fp64 and timed ones and the C6 job again under the default
    (``capture=None``: the all-reduces over 'ep' or 'sp' captured in a
    graph that lives for one call) with 2 more replays under sync debug
    "error", then the checkpoint's job (default).  The C4 chains' moments
    hold each rollout launch against the plain rollout, and every
    default job's trainer stays referenced (``hold_trainer``) through its
    rank's ``destroy_process_group``."""
    def plain(spec):
        if "moments" not in spec:
            return spec
        return dict(spec, moments=dict(spec["moments"], check_plain=True))
    eager = [(n, k, dict(plain(s), capture=False))
             for n, k, s in plan_b + plan_c + [c6]]
    default = [(f"{n}_captured", k, dict(plain(s), capture=None,
                                          sync_check=2, hold_trainer=True))
               for n, k, s in plan_b[:3] + plan_c + [c6]]
    return eager + default + [ck]


def _check_nccl_default(torch, ranks, singles, name, spec):
    """A default (captured) 7d job against its eager twin (1e-12 of each
    tensor's scale) and, in fp64, one card (1e-10): captured, one replay an
    iteration (``timed``: over the timed calls, which capture again),
    none of 2 more syncing, its graph released when its call returned.
    Returns its report entry."""
    from ffvd_tpu_torch.utils.graphs import WARMUP
    cap = [r[f"{name}_captured"][0] for r in ranks]
    eag = [r[name][0] for r in ranks]
    d = [_diff(torch, c, e, 1e-12, 0.0) for c, e in zip(cap, eag)]
    one = max(_diff(torch, c, singles[name], 1e-10, 1e-12)[0] for c in cap)
    stats = [c["graph_stats"] or {} for c in cap]
    entry = {"captured_vs_eager_max_rel_diff": max(x[0] for x in d),
             "bit_equal": all(x[2] for x in d),
             "vs_one_card_max_rel_diff": one,
             "replays_by_rank": [c["replays"] for c in cap],
             "eager_replays_by_rank": [e["replays"] for e in eag],
             "sync_check_replays_by_rank": [c.get("sync_check_replays")
                                            for c in cap],
             "sync_check_recaptured_by_rank": [
                 c.get("sync_check_recaptured") for c in cap],
             "capture_s_by_rank": [st.get("capture_s") for st in stats],
             "pool_MiB_by_rank": [(st.get("pool_bytes") or 0) / 2 ** 20
                                  for st in stats],
             "graphs_held_after_the_calls": [c["held_live_graphs"]
                                             for c in cap],
             "step_collectives": cap[0]["step_collectives"],
             "seconds_default": [r[f"{name}_captured"][1] for r in ranks],
             "seconds_eager": [r[name][1] for r in ranks]}
    timed = spec.get("timed")
    if timed:
        m = max(timed // 10, 2)
        want = 2 * timed + m - WARMUP
        entry.update(
            ms_per_iter_default_first_call_by_rank=[
                c["timed"]["ms_per_iter"] for c in cap],
            ms_per_iter_default_second_call_by_rank=[
                c["timed"]["ms_per_iter_second_call"] for c in cap],
            ms_per_iter_eager_by_rank=[e["timed"]["ms_per_iter"]
                                       for e in eag],
            ms_per_iter_eager_second_call_by_rank=[
                e["timed"]["ms_per_iter_second_call"] for e in eag],
            one_card_captured_ms_per_iter=singles[name]["timed"]
            ["ms_per_iter"],
            one_card_captured_ms_per_iter_second_call=singles[name]["timed"]
            ["ms_per_iter_second_call"],
            timed_iterations=timed)
    else:
        want = spec["iters"] - WARMUP
    fp64 = spec.get("dtype") == "float64"
    check(entry["captured_vs_eager_max_rel_diff"] <= 1e-12
          and (one <= 1e-10 or not fp64)
          and all(c["replays"] == want for c in cap)
          and all(e["replays"] is None for e in eag)
          and all(c.get("sync_check_replays") == 2 for c in cap)
          and all(h == [] for h in entry["graphs_held_after_the_calls"])
          and entry["step_collectives"] in ((("ep", "nccl"),),
                                            (("sp", "nccl"),)),
          f"7d {name}: the default over NCCL: {entry}")
    return entry


def phase_mesh_cards(torch, card, singles, plan_b, plan_c, device="cuda"):
    """7d: 7b and 7c over NCCL, one rank a card on 4 cards, eagerly and
    under the default (captured, ``_check_nccl_default``), with C6 chains
    over 'ep' and a meshed checkpoint resumed bit-equal to the
    uninterrupted run; both rates beside one card's captured rate
    (``singles``, this process on cuda:0); the C4 chains' rollout launches
    against the plain rollout; and the teardown: every rank returns from
    ``destroy_process_group`` with its default runs' trainers alive and no
    collection of cyclic garbage, or ``spawn_local`` raises at 240 s.
    Returns the report, with the launches and their largest difference
    from the plain rollout.  ``device="cpu"`` rehearses the jobs on the
    host over gloo, where the default runs eagerly and the checks of a
    capture fail."""
    import shutil

    from ffvd_tpu_torch.parallel.distributed import spawn_local
    from ffvd_tpu_torch.parallel.rank_jobs import chains_job, jobs_in_turn
    from ffvd_tpu_torch.utils.graphs import WARMUP
    on_card = device == "cuda"
    c6, ck, ck_dir = _nccl_jobs()
    singles = dict(singles, **{c6[0]: chains_job(
        torch.device("cuda:0" if on_card else "cpu"),
        dict(c6[2], mesh=None))})
    t0 = time.time()
    try:
        ranks = spawn_local(jobs_in_turn, 4, "nccl" if on_card else "gloo",
                            device,
                            args=(_nccl_plan(plan_b, plan_c, c6, ck),),
                            timeout=240)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    rep = {"ran": True, "cards": torch.cuda.device_count(),
           "backend": "nccl" if on_card else "gloo",
           "seconds": time.time() - t0,
           "teardown": "every rank returned from destroy_process_group "
                       "with its trainers held (spawn_local joined them)"}
    for key, check_fn in (("7b", _check_dp_ep), ("7c", _check_sp)):
        rep[key] = check_fn(torch, ranks, singles, f"7d {key}", on_card)
    rep["default"] = {
        name: _check_nccl_default(torch, ranks, singles, name, spec)
        for name, _, spec in plan_b[:3] + plan_c + [c6]}
    c4 = [(r["C4x8_fp64"][0], r["C4x8_fp64_captured"][0]) for r in ranks]
    launches = sum(e["launches"] + c["launches"] for e, c in c4)
    plain_err = max(sum((e["plain_max_abs_err"] + c["plain_max_abs_err"]
                         for e, c in c4), []), default=math.nan)
    moments = max(max(_moments_diff(c["moments"], e["moments"]))
                  for e, c in c4)
    rep["default"]["C4x8_fp64"].update(
        moments_default_vs_eager=moments,
        launch_rows_by_rank=[c["launch_rows"] for _, c in c4],
        rollout_calls_by_rank=[c["rollout_calls"] for _, c in c4],
        launches_eager_and_default=launches,
        launches_vs_plain_max_abs_err=plain_err)
    check(moments <= 1e-12 and plain_err <= 1e-9
          and sorted(sum((c["rollout_calls"] for _, c in c4), []))
          == [(40, 0), (40, 40)] and launches == (4 if on_card else 0),
          f"7d C4 moments: {rep['default']['C4x8_fp64']}")
    full = [r["ck_full"][0] for r in ranks]
    half = NCCL_CK_ITERS // 2
    bit = lambda a, b: (_diff(torch, a, b, 0.0, 0.0)[2]
                        and torch.equal(a["trace"], b["trace"]))
    ms = lambda key: [1e3 * f[key]["seconds"] / NCCL_CK_ITERS for f in full]
    ck_rep = {
        "chains": 8, "precision": "fp32", "iterations": NCCL_CK_ITERS,
        "saved_every": half,
        "resumed_bit_equal_by_rank": [bit(f, f["uninterrupted"])
                                      for f in full],
        "checkpointed_bit_equal_by_rank": [
            bit(f["checkpointed"], f["uninterrupted"]) for f in full],
        "files_by_rank": [f["files"] for f in full],
        "replays_by_rank": [[f[k]["replays"] for k in (
            "uninterrupted", "checkpointed")] + [f["replays"]] for f in full],
        "ms_per_iter_uninterrupted_by_rank": ms("uninterrupted"),
        "ms_per_iter_checkpointed_by_rank": ms("checkpointed"),
        "graphs_held_after_the_calls": [f["held_live_graphs"] for f in full]}
    rep["checkpoint"] = ck_rep
    check(all(ck_rep["resumed_bit_equal_by_rank"])
          and all(ck_rep["checkpointed_bit_equal_by_rank"])
          and all(f == [f"ckpt_{half:09d}.pt", f"ckpt_{NCCL_CK_ITERS:09d}.pt"]
                  for f in ck_rep["files_by_rank"])
          and all(x == [NCCL_CK_ITERS - WARMUP] * 2 + [half - WARMUP]
                  for x in ck_rep["replays_by_rank"])
          and all(h == [] for h in ck_rep["graphs_held_after_the_calls"]),
          f"7d checkpoint over NCCL: {ck_rep}")
    emit("7d", card=card, **rep)
    return {**rep, "launches": launches, "plain_max_abs_err": plain_err}


def _one_process_runs(torch, dev, plan_b, plan_c, specs_e=None):
    """The one-process twins of 7b's, 7c's and (``specs_e``) 7e's jobs, in
    this process on ``dev`` (captured by default on the card)."""
    from ffvd_tpu_torch.parallel.rank_jobs import chains_job, jobs_in_turn
    out = {name: jobs_in_turn(dev, [(name, kind, dict(
        spec, mesh=None, refuse=False, sync_check=None))])[name][0]
        for name, kind, spec in plan_b[:3] + plan_c}
    for name in ("C5x4_thin_fp64", "C6x4_fp64",
                 "deep_C4x4_fp64") if specs_e else ():
        out[name] = chains_job(dev, dict(specs_e[name], mesh=None,
                                         sync_check=None))
    return out


def phase_mesh(torch, card, device="cuda:0"):
    """Phase 7: the mesh half of ``parallel/``, through
    ``parallel.distributed.spawn_local`` and the jobs of
    ``parallel/rank_jobs.py`` (the ranks import nothing of JAX), each held
    against the same job in this process on the card.

    7a: NCCL at world size 1 on cuda:0, mesh (1, 1): 8 ballbeam C4 chains,
    50 fp32 iterations, then ``multichain_moments``, captured (a world of
    one issues no collective) and eagerly: both bit-equal to the run
    without a mesh.  7b: gloo, 4 ranks sharing cuda:0 (NCCL refuses two
    ranks on one card), dp=2 × ep=2: 8 C4 chains fp64 for 20 iterations and
    4 C5 chains fp64 for 3, each within rtol 1e-10 of the one-process run;
    the C4 chains' moments from 2 launches of 40 rows (one a dp group,
    Philox rows offset), equal to one 80-row launch on the same state
    within rtol 1e-12; the capture rule: the default ran the step eagerly
    (it all-reduces over 'ep' on gloo) and ``capture=True`` raised, naming
    both; 8 C4 chains fp32, 200 iterations timed (ms an
    iteration, the collectives' share of the host time) beside one
    process's 8 chains timed alike; six datasets ×
    M=512 for 20 iterations and ``evaluate()`` (6 launches, global plan).
    7c: gloo, 4 ranks sharing cuda:0, sp=4: kink N=5000 C4 full batch,
    fp64 for 10 iterations within rtol 1e-10 of the one-process
    ``Trainer``; fp32 timed beside the one-process rate.  7e
    (``_check_dp_only``): gloo, the same 4 ranks, dp=4 × ep=1, each rank's
    step captured.  7d (``phase_mesh_cards``): 7b and 7c over NCCL on 4
    cards, eager and captured, when the machine has them.  8a and 8b
    (``_check_8``) run in 7b's gloo ranks.  Timings of ranks that
    share one card measure correctness and overhead, not scaling.
    ``device="cpu"`` rehearses it on the host (gloo throughout, no 7d)."""
    from ffvd_tpu_torch.parallel.distributed import spawn_local
    from ffvd_tpu_torch.parallel.rank_jobs import chains_job, jobs_in_turn
    from ffvd_tpu_torch.utils.graphs import WARMUP
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = {}
    # 7a
    spec = _chain_spec("ballbeam", 8, 4, "float32", 50, mesh=(1, 1),
                       moments=dict(test_len=500, seed=1))
    t0 = time.time()
    (ranked,) = spawn_local(
        jobs_in_turn, 1, "nccl" if on_card else "gloo", device,
        args=([("captured", "chains", spec),
               ("eager", "chains", dict(spec, capture=False))],),
        timeout=300)
    a_s = time.time() - t0
    cap, eager = ranked["captured"][0], ranked["eager"][0]
    one = chains_job(dev, dict(spec, mesh=None))
    rel, _, equal = _diff(torch, cap, one, 0.0, 0.0)
    rel_e, _, equal_e = _diff(torch, cap, eager, 0.0, 0.0)
    m_rel = _moments_diff(cap["moments"], one["moments"])
    m_rel_e = _moments_diff(cap["moments"], eager["moments"])
    out["7a"] = {"backend": "nccl" if on_card else "gloo",
                 "world_size": 1, "mesh": [1, 1],
                 "chains": 8, "iterations": 50, "precision": "fp32",
                 "bit_equal": equal, "max_rel_diff": rel,
                 "moments_max_rel_diff": m_rel,
                 "captured_bit_equal_eager": equal_e,
                 "captured_vs_eager_max_rel_diff": rel_e,
                 "moments_captured_vs_eager": m_rel_e,
                 "replays": cap["replays"],
                 "eager_replays": eager["replays"],
                 "step_collectives": cap["step_collectives"],
                 "launches": cap["launches"],
                 "launch_rows": cap["launch_rows"], "seconds": a_s}
    emit("mesh_7a", **out["7a"])
    card_launches = 1 if on_card else 0   # plain on the host
    check(equal and equal_e and max(m_rel) == 0.0 and max(m_rel_e) == 0.0
          and cap["rollout_calls"] == [(80, 0)]
          and cap["launches"] == card_launches
          and cap["replays"] == (50 - WARMUP if on_card else None)
          and eager["replays"] is None,
          f"7a: mesh (1, 1) differs from one process or eager: {out['7a']}")
    plan_b, plan_c = _mesh_plans()
    plan_e, specs_e = _dp_only_plan()
    singles = _one_process_runs(torch, dev, plan_b, plan_c, specs_e)
    # 7b, 7c, 8a, 8b, 7e: gloo ranks sharing the card, in one set of
    # processes; 7b's C4 chains also try capture=True
    plan_8, ck, kink = _plan_8()
    gloo_b = [(n, k, dict(s, refuse=True) if n == "C4x8_fp64" else s)
              for n, k, s in plan_b]
    t0 = time.time()
    ranks = spawn_local(jobs_in_turn, 4, "gloo", device,
                        args=(gloo_b + plan_c + plan_8 + plan_e,),
                        timeout=900)
    bc_s = time.time() - t0
    for key, check_fn in (("7b", _check_dp_ep), ("7c", _check_sp)):
        out[key] = {"backend": "gloo", "ranks": 4, "cards": 1,
                    "seconds_7b_7c_8a_8b_7e": bc_s,
                    **check_fn(torch, ranks, singles, key, on_card)}
        if key == "7b":
            c4 = [r["C4x8_fp64"][0] for r in ranks]
            out[key]["capture_rule"] = rule = {
                "replays_by_rank": [x["replays"] for x in c4],
                "step_collectives": c4[0]["step_collectives"],
                "capture_true_raised": c4[0]["refusal"]}
            check(all(x["replays"] is None
                      and x["step_collectives"] == (("ep", "gloo"),)
                      and "'ep' on gloo" in (x["refusal"] or "")
                      for x in c4), f"7b: the capture rule: {rule}")
        emit(f"mesh_{key}", card=card, **out[key])
    _check_8(torch, ranks, ck, kink, card, dev)
    out["7e"] = {"backend": "gloo", "ranks": 4, "cards": 1, "mesh": [4, 1],
                 **_check_dp_only(torch, ranks, singles, specs_e, "7e",
                                  on_card)}
    emit("mesh_dp_only_7e", card=card, **out["7e"])
    # 7d: NCCL over 4 cards
    n = torch.cuda.device_count() if on_card else 0
    nccl = {}
    if n >= 4:
        out["7d"] = phase_mesh_cards(torch, card, singles, plan_b, plan_c)
        nccl = {"mesh_nccl_4cards_dp2ep2_C4x8": out["7d"]["launches"]}
    else:
        out["7d"] = {"ran": False, "cards": n}
        emit("7d", **out["7d"])
    return {"launches": {
        "mesh_nccl_C4x8": out["7a"]["launches"],
        "mesh_gloo_dp2ep2_C4x8": sum(out["7b"]["moments"]
                                     ["launches_by_rank"]),
        "mesh_gloo_dp2ep2_six_m512": sum(out["7b"]["six_m512"]
                                         ["launches_by_rank"]),
        "mesh_gloo_dp4_C4x8_captured": sum(out["7e"]["C4x8_fp64"]
                                           ["launches_by_rank"]),
        "mesh_gloo_dp4_C5x4_captured": sum(out["7e"]["C5x4_thin_fp64"]
                                           ["launches_by_rank"]), **nccl}}


def phase_nccl_cards_only(torch, card):
    """``--nccl-cards``: phase 7d alone, for a machine with 4 cards (its
    one-card twins on cuda:0 first).  Returns 7d's report."""
    plan_b, plan_c = _mesh_plans()
    n = torch.cuda.device_count()
    check(n >= 4, f"--nccl-cards needs 4 cards, found {n}")
    singles = _one_process_runs(torch, torch.device("cuda:0"), plan_b,
                                plan_c)
    return phase_mesh_cards(torch, card, singles, plan_b, plan_c)


# ---------------------------------------------------------------------------
# Phase 8: checkpoints of a meshed run, windows over 'sp', the benchmark
# script and the examples
# ---------------------------------------------------------------------------

EXAMPLES = ("01_quickstart", "02_all_datasets_one_jit",
            "04_synthetic_cold_start", "05_multidim_emission",
            "06_minibatch_long_sequence", "07_deep_transition",
            "08_ensemble_calibration", "09_particle_gibbs_c6")


# 8a: one process continuing a restored fp32 state against the dp=2 × ep=2
# mesh continuing it, 10 iterations apart only in the order of the sums
# over 'ep'.  Read at 1.36e-4 (max relative difference, trace and state) on
# an H100 80GB HBM3 at 700 W in two runs; the limit leaves 7× room.
CONTINUATION_RTOL = 1e-3


def _plan_8():
    """8a's and 8b's jobs, run in 7b's set of 4 gloo ranks: (the plan,
    8a's checkpoint spec, the kink specs by name)."""
    import tempfile
    chains = _chain_spec("ballbeam", 8, 4, "float32", 20, mesh=(2, 2))
    ck = dict(chains, trainer="chains", mode="resume", first=10,
              dir=tempfile.mkdtemp(prefix="ffvd_ckpt_"))
    kink = {"kink_window_fp64": _kink_spec("float64", 10, mesh=(4,),
                                           axis="sp"),
            "kink_window_fp32_timed": _kink_spec("float32", 2, timed=20,
                                                 mesh=(4,), axis="sp")}
    for spec in kink.values():
        spec["cfg"] = dict(spec["cfg"], minibatch_size=256)
    plan = [("whole_8a", "chains", chains), ("ck_8a", "checkpoint", ck)] + [
        (name, "sequence", spec) for name, spec in kink.items()]
    return plan, ck, kink


def _check_8(torch, ranks, ck, kink, card, dev):
    """Phases 8a and 8b on the results of 7b's 4 gloo ranks sharing the
    card.

    8a: dp=2 × ep=2, 8 ballbeam C4 chains in fp32: 10 iterations through
    ``run_with_checkpoints``, a restore into a fresh state with another
    generator, 10 more, bit-equal to 20 uninterrupted meshed iterations
    (trace and whole state), one file a checkpoint; the same file restored
    into one process on the card is the state the mesh restored, bit for
    bit, and its 10 more iterations stay within ``CONTINUATION_RTOL`` of
    the mesh's.  8b: sp=4, kink N=5000 C4 from a cold start on windows of 256
    (``minibatch_size``): fp64 for 10 iterations within rtol 1e-10 of one
    process's windowed ``Trainer`` with the same generator, then fp32
    timed beside one process timed alike."""
    import shutil

    from ffvd_tpu_torch.parallel.rank_jobs import checkpoint_job, sequence_job
    files = ["ckpt_000000010.pt", "ckpt_000000020.pt"]
    whole = [r["whole_8a"][0] for r in ranks]
    got = [r["ck_8a"][0] for r in ranks]
    bit = [_diff(torch, g, w, 0.0, 0.0)[2] and torch.equal(g["trace"],
                                                          w["trace"])
           for g, w in zip(got, whole)]
    one = checkpoint_job(dev, dict(ck, mode="restore", mesh=None))
    shutil.rmtree(ck["dir"], ignore_errors=True)
    restored_equal = (set(one["restored"]) == set(got[0]["restored"])
                      and all(torch.equal(v, got[0]["restored"][k])
                              for k, v in one["restored"].items()))
    cont = _diff(torch, {"trace": one["trace"], "state": one["state"]},
                 {"trace": whole[0]["trace"][10:],
                  "state": whole[0]["state"]}, 0.0, 0.0)[0]
    a = {"backend": "gloo", "ranks": 4, "cards": 1, "mesh": [2, 2],
         "chains": 8, "precision": "fp32", "saved_at": 10, "resumed_to": 20,
         "resume_bit_equal_by_rank": bit,
         "files_by_rank": [g["files"] for g in got],
         "one_process_restore_bit_equal": restored_equal,
         "one_process_continuation_max_rel_diff": cont,
         "seconds": [r["ck_8a"][1] for r in ranks]}
    emit("mesh_checkpoint_8a", card=card, **a)
    check(all(bit) and all(g["files"] == files for g in got)
          and restored_equal and cont <= CONTINUATION_RTOL,
          f"8a: meshed checkpoint resume: {a}")
    singles = {name: sequence_job(dev, dict(spec, mesh=None))
               for name, spec in kink.items()}
    b = {"backend": "gloo", "ranks": 4, "cards": 1, "N": 5000,
         "window": 256, **_check_sp(torch, ranks, singles, "8b",
                                    prefix="kink_window")}
    emit("mesh_window_8b", card=card, **b)


def _load_script(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_bench_quick(torch, ro, card, device="cuda"):
    """Phase 8c: ``scripts/bench_torch.py``'s measurement in this process
    at ``--quick`` (a few iterations of each workload), its JSON line
    printed; the rollout launches of its two ``evaluate()`` calls.
    ``device="cpu"`` rehearses it on the host (no launches)."""
    bench = _load_script(ROOT / "scripts" / "bench_torch.py")
    on_card = device == "cuda"
    ro.rollout.launches = 0          # this path starts here
    t0 = time.time()
    line = bench.measure(device, quick=True)
    launches = ro.rollout.launches
    print(json.dumps(line), flush=True)
    numbers = [line["value"]] + [v for v in line["extra"].values()
                                 if isinstance(v, float)]
    emit("bench_quick_8c", card=card, launches=launches,
         seconds=time.time() - t0)
    check(line["extra"]["platform"] == ("gpu" if on_card else "cpu")
          and all(math.isfinite(v) for v in numbers)
          and launches == (2 if on_card else 0),
          f"8c: bench_torch --quick: {line}, {launches} launches")
    return launches


def phase_examples_quick(torch, ro, card, device="cuda"):
    """Phase 8d: the eight examples of ``examples_torch/`` in this
    process at ``--quick``, on the card, in a scratch directory (example
    01 writes a results file); each one's rollout launches and the tail of
    what it printed.  ``device="cpu"`` rehearses it on the host."""
    import contextlib
    import io
    import os
    import runpy
    import tempfile
    out, launches = {}, {}
    argv, cwd = sys.argv, os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name in EXAMPLES:
                path = ROOT / "examples_torch" / f"{name}.py"
                sys.argv = [str(path), "--quick"] + (
                    ["--cpu"] if device == "cpu" else [])
                buf = io.StringIO()
                ro.rollout.launches = 0      # this example's path
                t0 = time.time()
                with contextlib.redirect_stdout(buf):
                    runpy.run_path(str(path), run_name="__main__")
                launches[name] = ro.rollout.launches
                out[name] = {"seconds": time.time() - t0,
                             "launches": launches[name],
                             "printed": buf.getvalue().splitlines()[-3:]}
        finally:
            sys.argv = argv
            os.chdir(cwd)
    emit("examples_quick_8d", card=card, **out)
    on_card = device == "cuda"
    check(all(v["printed"] for v in out.values())
          and (launches["01_quickstart"] >= 1) == on_card
          and launches["02_all_datasets_one_jit"] == (1 if on_card else 0),
          f"8d: examples: {out}")
    return launches


STUDY_ARMS = "c4_six,c5_ballbeam,c6_ballbeam,drive12k"
# Ballbeam C4, C5 and C6, and the drive 12k arm's native and ds64 runs,
# with their iterations at --quick.
STUDY_TAGS = {"ballbeam": 50, "ballbeam_C5_s0": 3,
              "ballbeam_C6_ancestor_s0": 2, "drive_long12k_s1": 50,
              "drive_long12k_s1_ds64": 50}
STUDY_NUMBERS = ("rmse", "nll", "nll_first", "nll_last", "budget_s2C2",
                 "max_Q", "train_s", "it_per_s", "eval_ms")
STUDY_FIELDS = STUDY_NUMBERS + (
    "dataset", "case", "seed", "init_jitter", "collapse_precision", "dtype",
    "iterations", "n_layers", "mode", "Q")


def phase_study_quick(torch, ro, card, device="cuda"):
    """Phase 11: ``scripts/study_torch.py --quick`` in this process, into a
    temporary file, for ballbeam C4, C5 and C6 and the drive 12k arm's
    native and ds64 runs; then the same call again, which must skip every
    tag.  Every record finite with the fields the pins of
    ``tests/test_torch_study_artifacts.py`` read, the header naming the
    card, one rollout launch per ``evaluate()`` (all five are C4, C5 or
    C6).  ``device="cpu"`` rehearses it on the host (no launches)."""
    import tempfile
    study = _load_script(ROOT / "scripts" / "study_torch.py")
    on_card = device == "cuda"
    match = "^(" + "|".join(STUDY_TAGS) + ")$"
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--quick", "--arms", STUDY_ARMS, "--match", match,
                "--device", device, "--out", str(Path(tmp) / "study.json")]
        ro.rollout.launches = 0          # this path starts here
        first = study.main(argv)
        launches = ro.rollout.launches
        again = study.main(argv)
        doc = json.loads((Path(tmp) / "study.json").read_text())
    runs = doc["runs"]
    emit("11_study_quick", card=card, arm_seconds=first["arm_seconds"],
         launches=launches, seconds=time.time() - t0,
         header=doc["header"], runs={t: {k: r[k] for k in (
             "iterations", "rmse", "nll", "it_per_s", "eval_ms")}
             for t, r in runs.items()})
    check(sorted(first["ran"]) == sorted(STUDY_TAGS)
          and not again["ran"]
          and sorted(again["skipped"]) == sorted(STUDY_TAGS),
          f"11: ran {first['ran']}, then ran {again['ran']} and skipped "
          f"{again['skipped']}")
    bad = [t for t, r in runs.items()
           if any(k not in r for k in STUDY_FIELDS)
           or not all(math.isfinite(r[k]) for k in STUDY_NUMBERS)
           or not all(math.isfinite(q) for q in r["Q"])
           or r["iterations"] != STUDY_TAGS[t]]
    check(not bad, f"11: records not finite or fields missing: {bad}")
    c5, c6 = runs["ballbeam_C5_s0"], runs["ballbeam_C6_ancestor_s0"]
    check(isinstance(c5.get("clip_saturated"), bool)
          and all(math.isfinite(c6["mixing_mean"][k]) for k in
                  ("ref_survival", "unique_frac", "accepted")),
          f"11: C5 clip {c5.get('clip_saturated')}, C6 mixing "
          f"{c6.get('mixing_mean')}")
    check(doc["header"]["quick"] and doc["header"]["device"] == device
          and doc["header"]["card"] == (card if on_card else "cpu"),
          f"11: header {doc['header']} against the card {card}")
    check(launches == (len(STUDY_TAGS) if on_card else 0),
          f"11: {launches} rollout launches for {len(STUDY_TAGS)} "
          f"evaluate() calls")
    return launches


# The other study arm families at --quick: C6 live, C6 P=500 and C6 on
# drive as two-member chains groups, a 4-chain C4 ensemble, the kink cold
# start under hybrid, and ballbeam C6 in fp64 on the card; each tag's
# iterations and evaluate() launches (an ensemble rolls out once a chain,
# the cold start twice).
STUDY_NEW_ARMS = "c6_live,c6_p500,c6_drive,ensemble,coldstart,c6_ballbeam_fp64"
STUDY_NEW_TAGS = {"ballbeam_C6_live_s0": (2, 1), "ballbeam_C6_live_s1": (2, 1),
                  "ballbeam_C6_liveP500_s0": (2, 1),
                  "ballbeam_C6_liveP500_s1": (2, 1),
                  "drive_C6_ancestor_s0": (2, 1),
                  "drive_C6_ancestor_s1": (2, 1),
                  "ensemble/ballbeam": (50, 4),
                  "kink_cold_hybrid_s0": (20, 2),
                  "ballbeam_C6_ancestor_s0_fp64card": (2, 1)}


def phase_study_arms_quick(torch, ro, card, device="cuda"):
    """Phase 11b: the other arm families through ``scripts/study_torch.py
    --quick`` in this process, into a temporary file (``STUDY_NEW_TAGS``):
    the chains groups' members trained in one ``MultiChainTrainer`` and
    evaluated one by one, the ensemble pooled, the cold start's ds64-bound
    nll, the fp64 record in fp64; every number finite, the rollout
    launches one an ``evaluate()`` (a drive member above 1.5 adds its 10
    redraws).  ``device="cpu"`` rehearses it on the host (no
    launches)."""
    import tempfile
    study = _load_script(ROOT / "scripts" / "study_torch.py")
    on_card = device == "cuda"
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ro.rollout.launches = 0          # this path starts here
        out = study.main([
            "--quick", "--arms", STUDY_NEW_ARMS, "--device", device,
            "--match", "^(" + "|".join(STUDY_NEW_TAGS) + ")$",
            "--out", str(Path(tmp) / "study.json")])
        launches = ro.rollout.launches
        runs = json.loads((Path(tmp) / "study.json").read_text())["runs"]
    redraws = [t for t in runs if t.endswith("_redraw")]
    emit("11b_study_arms_quick", card=card, arm_seconds=out["arm_seconds"],
         launches=launches, seconds=time.time() - t0,
         runs={t: {k: r[k] for k in ("iterations", "rmse", "nll",
                                     "nll_final_ds64_bound", "mode",
                                     "chains", "dtype") if k in r}
               for t, r in runs.items()})
    check(sorted(t for t in runs if t not in redraws)
          == sorted(STUDY_NEW_TAGS),
          f"11b: ran {sorted(runs)}, expected {sorted(STUDY_NEW_TAGS)}")
    bad = [t for t, (n, _) in STUDY_NEW_TAGS.items()
           if runs[t]["iterations"] != n
           or not all(math.isfinite(v) for k, v in runs[t].items()
                      if isinstance(v, float))]
    check(not bad, f"11b: records not finite or cut wrong: {bad}")
    groups = {t: runs[t] for t in STUDY_NEW_TAGS if "_C6_" in t
              and "fp64card" not in t}
    check(all(r["mode"] == "chains" and r["chains"] == 2
              for r in groups.values())
          and runs["ensemble/ballbeam"]["chains"] == 4
          and len(runs["ensemble/ballbeam"]["per_chain"]) == 4
          and runs["ballbeam_C6_ancestor_s0_fp64card"]["dtype"] == "fp64"
          and math.isfinite(runs["kink_cold_hybrid_s0"]
                            ["nll_final_ds64_bound"]),
          "11b: chains "
          f"{[(r['mode'], r.get('chains')) for r in groups.values()]}")
    want = sum(k for _, k in STUDY_NEW_TAGS.values()) + 10 * len(redraws)
    check(launches == (want if on_card else 0),
          f"11b: {launches} rollout launches for {want} evaluate() calls")
    return launches


# The last arms at --quick: flutter in fp64 (C5 and the 12k run), BASELINE
# config 4 (drive at x_dim 2, 4 and 6) and config 2 (LinearK); each tag's
# iterations.  Every shallow evaluate() launches the kernel once; LinearK
# rolls out on the torch recursion, no launch.
STUDY_LAST_TAGS = {"flutter_C5_s0_fp64card": 3,
                   "flutter_long12k_s1_fp64cpu": 50, "drive_xd2": 50,
                   "drive_xd4": 50, "drive_xd6": 50}
STUDY_LINEAR_TAGS = {"gas_furnace_C4_linear": 50, "dryer_C4_linear": 50}


def model_rollout_inputs(torch, model, dtype, t_len):
    """A fitted model's rollout inputs: the collapsed q(U) mean and factor,
    Lm⁻¹, Q, the last training state and the first ``t_len`` test
    controls, cast to ``dtype``."""
    from ffvd_tpu_torch.eval.rollout import u_and_qsqrt
    from ffvd_tpu_torch.model.conditionals import kernel_precal
    from ffvd_tpu_torch.ops.kernels import KernelParams
    params, data = model.params, model.data
    with torch.no_grad():
        pre = kernel_precal(model.cfg.kernel_type, params.kernel, params.z)
        u_val, q_sqrt = u_and_qsqrt(model.trainer, params, data, pre)
    n = model.dataset.n_train
    cast = lambda t: t.detach().to(dtype).contiguous()
    return dict(kparams=KernelParams(cast(params.kernel.log_variance),
                                     cast(params.kernel.log_lengthscales)),
                z=cast(params.z), lm_inv=cast(pre.lm_inv),
                u_val=cast(u_val), q_sqrt=cast(q_sqrt), q=cast(params.q),
                x0=cast(params.x[-1]),
                controls=cast(data.control[n:n + t_len]))


def phase_study_last_quick(torch, ro, card, device="cuda"):
    """Phase 11c: the last study arms through ``scripts/study_torch.py
    --quick`` in this process, into a temporary file: ``flutter_fp64`` and
    ``config4`` (``STUDY_LAST_TAGS``: one rollout launch an
    ``evaluate()``, x_dim 6 on a cluster of six CTAs), then ``config2``
    (LinearK: no launch).  Every record finite, at its length, in its
    dtype and settings.  Then drive at x_dim 6 with config 4's 20
    rollouts, trained 50 iterations: the kernel against the plain rollout
    on its inputs and shared noise, fp32 over the metric horizon and
    fp64 throughout (those launches are not counted).  ``device="cpu"``
    rehearses the study half on the host (no launches, no kernel)."""
    import tempfile
    study = _load_script(ROOT / "scripts" / "study_torch.py")
    on_card = device == "cuda"
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "study.json"

        def run(arms, tags):
            ro.rollout.launches = 0          # this path starts here
            res = study.main(["--quick", "--arms", arms, "--device", device,
                              "--match", "^(" + "|".join(tags) + ")$",
                              "--out", str(out)])
            return res, ro.rollout.launches
        shallow, launches = run("flutter_fp64,config4", STUDY_LAST_TAGS)
        linear, linear_launches = run("config2", STUDY_LINEAR_TAGS)
        runs = json.loads(out.read_text())["runs"]
    want = {**STUDY_LAST_TAGS, **STUDY_LINEAR_TAGS}
    emit("11c_study_last_quick", card=card, launches=launches,
         linear_launches=linear_launches, seconds=time.time() - t0,
         arm_seconds={**shallow["arm_seconds"], **linear["arm_seconds"]},
         runs={t: {k: r[k] for k in ("iterations", "rmse", "nll", "dtype",
                                     "it_per_s", "eval_ms")}
               for t, r in runs.items()})
    check(sorted(runs) == sorted(want),
          f"11c: ran {sorted(runs)}, expected {sorted(want)}")
    bad = [t for t, n in want.items()
           if runs[t]["iterations"] != n
           or not all(math.isfinite(v) for v in runs[t].values()
                      if isinstance(v, float))]
    check(not bad, f"11c: records not finite or cut wrong: {bad}")
    check(all(runs[t]["dtype"] == "fp64" for t in want if "fp64" in t)
          and runs["drive_xd6"]["cfg"]["x_dim"] == 6
          and runs["dryer_C4_linear"]["cfg"]["kernel_type"] == "LinearK",
          f"11c: settings {[(t, r['dtype'], r.get('cfg')) for t, r in runs.items()]}")
    check(launches == (len(STUDY_LAST_TAGS) if on_card else 0)
          and linear_launches == 0,
          f"11c: {launches} rollout launches for {len(STUDY_LAST_TAGS)} "
          f"evaluate() calls, {linear_launches} on LinearK")
    if not on_card:
        return launches
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    model = FFVDModel(FFVDConfig(dataset="drive", case=4, x_dim=6,
                                 num_posterior_samples=20,
                                 posterior_sample_spacing=50), device="cuda")
    model.fit(50)
    n_s, t_len = 20, model.dataset.n_test
    gen = torch.Generator().manual_seed(66)
    noise = torch.randn((n_s, t_len, 6), generator=gen, dtype=torch.float64)
    errs = {}
    for name, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        inp = model_rollout_inputs(torch, model, dtype, t_len)
        nz = noise.to("cuda", dtype)
        xk, vk = call(ro.rollout, inp, True, noise=nz, num_samples=n_s)
        plan = ro.rollout.last_plan
        xr, vr = call(ro.rollout_reference, inp, True, noise=nz,
                      num_samples=n_s)
        torch.cuda.synchronize()
        h = slice(None) if name == "fp64" else slice(0, HORIZON)
        rtol, atol = (1e-9, 1e-12) if name == "fp64" else (1e-4, 1e-5)
        ok = (torch.allclose(xk[:, h], xr[:, h], rtol=rtol, atol=atol)
              and torch.allclose(vk[:, h], vr[:, h], rtol=rtol, atol=atol))
        errs[name] = max(float((xk[:, h] - xr[:, h]).abs().max()),
                         float((vk[:, h] - vr[:, h]).abs().max()))
        check(ok and plan.cluster == 6 and bool(torch.isfinite(xk).all()),
              f"11c: x_dim 6 kernel vs plain {name}: err {errs[name]}, "
              f"plan {plan._asdict()}")
    emit("11c_xdim6_kernel_vs_plain", max_abs_err=errs, samples=n_s,
         steps=t_len, plan=plan._asdict(), tolerance={
             "fp64": "rtol 1e-9, atol 1e-12, all steps",
             "fp32": f"rtol 1e-4, atol 1e-5, first {HORIZON} steps"})
    return launches


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
    out["fp32_m512_grouped_six"] = _grouped_six(torch, ro)
    emit("timing", shapes={"S": S, "T": T, "D": 4, "M": 100, "Din": 5},
         noise="in-kernel Philox", library="no single PyTorch call computes "
         "this rollout; library_ms is null", **out)
    return out


def _grouped_six(torch, ro):
    """The six-dataset evaluation's launch shape (phase 4j; the
    benchmark's ``m512x6-eval``): 10 rows of each of the six test lengths
    at M=512, fp32, each group with its own parameter set, controls and
    generator, as one grouped launch and as six launches.  Each group's
    rows must equal its own launch's bit for bit, zero past its length,
    and the plain grouped version over the first HORIZON steps at phase
    2's fp32 tolerance."""
    from ffvd_tpu_torch.ops.kernels import KernelParams
    launches = ro.rollout.launches
    lens = (512, 500, 250, 500, 512, 148)
    base = random_inputs(torch, torch.float32, 4, 512, max(lens))
    sets = per_sample_inputs(torch, base, len(lens))
    ctrl = [base["controls"][:t] for t in lens]
    kp = sets["kparams"]
    seeded = lambda: [torch.Generator().manual_seed(50 + g)
                      for g in range(len(lens))]

    def one(g, gen):
        return ro.rollout(
            KernelParams(kp.log_variance[g], kp.log_lengthscales[g]),
            sets["z"][g], sets["lm_inv"][g], sets["u_val"][g],
            sets["q_sqrt"][g], sets["q"][g], sets["x0"][g], ctrl[g], S,
            generator=gen)

    def grouped(gens, fn=ro.rollout_grouped):
        return fn(kp, sets["z"], sets["lm_inv"], sets["u_val"],
                  sets["q_sqrt"], sets["q"], sets["x0"], ctrl, S,
                  generators=gens)

    gx, gv = grouped(seeded())
    plan, groups = ro.rollout.last_plan, ro.rollout.last_groups
    sep = [one(g, gen) for g, gen in enumerate(seeded())]
    px, pv = grouped(seeded(), ro.rollout_reference_grouped)
    torch.cuda.synchronize()
    same = [bool(torch.equal(gx[g, :, :t], x) and torch.equal(gv[g, :, :t], v)
                 and not gx[g, :, t:].any() and not gv[g, :, t:].any())
            for g, (t, (x, v)) in enumerate(zip(lens, sep))]
    h = slice(0, HORIZON)
    plain_close = bool(
        torch.allclose(gx[:, :, h], px[:, :, h], rtol=1e-4, atol=1e-5)
        and torch.allclose(gv[:, :, h], pv[:, :, h], rtol=1e-4, atol=1e-5)
        and all(not px[g, :, t:].any() and not pv[g, :, t:].any()
                for g, t in enumerate(lens)))
    err = max(float((gx[:, :, h] - px[:, :, h]).abs().max()),
              float((gv[:, :, h] - pv[:, :, h]).abs().max()))
    gens = seeded()
    six_ms = _time_ms(torch, lambda: [one(g, gen)
                                      for g, gen in enumerate(gens)], 10)
    grouped_ms = _time_ms(torch, lambda: grouped(gens), 20)
    plain_ms = _time_ms(torch, lambda: grouped(
        gens, ro.rollout_reference_grouped), 2)
    ro.rollout.launches = launches   # timing launches are not the path's
    bounds = [_bound("fp32", S, t, 4, 512, 5, 1, 4, with_noise_input=False)
              for t in lens]
    bound_ms = sum(b[0] for b in bounds)
    rep = {"lengths": list(lens), "rows_per_group": S, "M": 512,
           "groups": groups, "grouped_ms": grouped_ms,
           "six_launches_ms": six_ms, "speedup": six_ms / grouped_ms,
           "us_per_step_grouped": grouped_ms * 1e3 / max(lens),
           "bound_ms": bound_ms, "bound_by": bounds[0][1],
           "grouped_roofline_pct": 100 * bound_ms / grouped_ms,
           "six_launches_roofline_pct": 100 * bound_ms / six_ms,
           "bit_equal_by_group": same, "max_abs_err": err,
           "plain_close": plain_close, "plain_ms": plain_ms,
           "tolerance": f"rtol 1e-4, atol 1e-5, first {HORIZON} steps",
           "grouped_launches_timed": 20, "six_launch_sets_timed": 10,
           "plain_calls_timed": 2, "plan": plan._asdict()}
    check(all(same) and plain_close and groups == len(lens)
          and not plan.resident, f"grouped launch of six M=512 sets: {rep}")
    return rep


def _kernel_entry(timing, launches, max_abs_err, **extra):
    """The rollout kernel's entry of the ``kernels`` line: its launches
    on the path this run drove, its largest difference from the plain
    version, and phase 6's times at the main shapes in fp32."""
    f32 = timing["fp32"]
    return {"name": "rollout", "route": "cuda",
            "source": "ffvd_tpu_torch/csrc/rollout.cu",
            "replaces": "ffvd_tpu/ops/pallas_rollout.py:82",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": None, **extra}


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
    if "--nccl-cards" in sys.argv[1:]:
        # The kernel against its plain version, 7d (whose rollout
        # launches are the path's, each held against the plain rollout),
        # then the kernel's times.
        worst = phase_kernel_vs_plain(torch, ro)
        phase_per_sample_vs_plain(torch, ro)
        rep = phase_nccl_cards_only(torch, card)
        timing = phase_timing(torch, ro)
        emit("phase_seconds", total=time.time() - t0)
        kernels = {"kernels": [_kernel_entry(
            timing, rep["launches"],
            max(worst["fp32"], rep["plain_max_abs_err"]),
            launches_by_path={"mesh_nccl_4cards_dp2ep2_C4x8":
                              rep["launches"]},
            meshed_launches_vs_plain_max_abs_err=rep["plain_max_abs_err"])]}
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_nccl_report.json").write_text(
            json.dumps({**REPORT, **kernels}, indent=1))
        print(card)
        print(json.dumps(kernels))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
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
    captured = timed("captured_vs_eager", phase_captured, torch, card,
                     REPORT["main_path"])
    timed("batched_recursion_and_sweep", phase_batched, torch, card,
          captured)
    timed("fp64_train", phase_fp64_train, torch)
    timed("fp64_sampler", phase_fp64_sampler, torch)
    timed("fp64_pg", phase_fp64_pg, torch)
    timed("fp64_deep", phase_fp64_deep, torch)
    timed("fp64_segment", phase_fp64_segment, torch)
    timed("fp64_batched", phase_fp64_batched, torch)
    mesh = timed("mesh", phase_mesh, torch, card)
    bench_launches = timed("bench_quick", phase_bench_quick, torch, ro, card)
    example_launches = timed("examples_quick", phase_examples_quick, torch,
                             ro, card)
    study_launches = timed("study_quick", phase_study_quick, torch, ro,
                           card)
    timed("study_arms_quick", phase_study_arms_quick, torch, ro, card)
    study_last = timed("study_last_quick", phase_study_last_quick, torch, ro,
                       card)
    timing = timed("timing", phase_timing, torch, ro)
    emit("phase_seconds", **seconds, total=time.time() - t0)

    f32, f64 = timing["fp32"], timing["fp64"]
    ps32, ps64 = f32["per_sample"], f64["per_sample"]
    kernels = {"kernels": [_kernel_entry(
        timing, launches, worst["fp32"], plan=f32["plan"],
        launches_by_path={
            "C4": launches,
            **{k: v["rollout_launches_fit"] + v["rollout_launches_evaluate"]
               for k, v in {**sampler, "C6": pg_path, "deep_C4": deep,
                            "window_C4": window, "hybrid_C4": hybrid,
                            "ensemble_C4x2": ensemble}.items()},
            "multichain_C4x8": multichain["C4x8"],
            "multichain_C5x4": multichain["C5x4"],
            "six_datasets_m512": six, **mesh["launches"],
            "bench_torch_quick": bench_launches,
            "study_quick_11": study_launches,
            "study_last_quick_11c": study_last,
            **{f"example_{k}": v for k, v in example_launches.items()}},
        fp32_s80_per_sample={k: timing["fp32_s80_per_sample"][k] for k in
                             ("ms", "plain_ms", "bound_ms", "bound_by")},
        fp32_m512_global={k: timing["fp32_m512_global"][k] for k in
                          ("ms", "plain_ms", "bound_ms", "bound_by")},
        fp32_m512_grouped_six={k: timing["fp32_m512_grouped_six"][k]
                               for k in ("grouped_ms", "six_launches_ms",
                                         "plain_ms", "max_abs_err",
                                         "bound_ms", "bound_by")},
        fp64={"ms": f64["ms"], "plain_ms": f64["plain_ms"],
              "bound_ms": f64["bound_ms"], "bound_by": f64["bound_by"],
              "max_abs_err": worst["fp64"], "plan": f64["plan"]},
        per_sample={
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
                     "max_abs_err": ps_worst["fp64"]}})]}
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
