"""Flutter C4 under the float64 segment: both packages, on the CPU.

The question (ROADMAP Queue 3, F2): on flutter, the port's
``collapse_precision="ds64"`` trains the σ²C² budget to 39.26 over 12,000
iterations on an H100 (``flutter_long12k_s1_ds64`` in ``study_h100.json``),
where the JAX package's double-single run of the same protocol on a TPU
recorded 0.237 (``tests/golden/fp32_stall_study.json``).  C4 draws no
random numbers, so four trajectories from the vendored ``file_id=3`` warm
start, with ``fp32_stall_study.py``'s flutter configuration (seed 1,
``rollout_qsqrt_dim0``), settle which one the design computes:

- ``jax_fp64``: the JAX package in float64 (``jax_enable_x64``, native
  collapse);
- ``jax_ds64``: the JAX package with float32 leaves and its double-single
  segment (``ffvd_tpu/model/ds_collapse.py``), ``jax_enable_x64`` off as
  in production;
- ``port_fp64``: the port in float64;
- ``port_ds64``: the port with float32 leaves and its float64 segment
  (``ffvd_tpu_torch/model/ds_collapse.py``).

Each runs in a process of its own, ``jax_ds64`` as one jitted
``Trainer.outer_step`` an iteration (its scanned chunk does not finish
compiling in an hour on an 8-core CPU) and cut after ``--ds64-seconds``;
the JSON states the common length.  Every 1000 iterations the budget,
the largest Q and the nll are recorded, and ``port_ds64``'s leaves are
kept.  Then, at the warm start and at each kept state, the gradient of
the ds64 objective is taken in both packages (JAX's with
``jax_enable_x64`` off and on), the float64 gradient and the port's
native float32 one at the same point, and their distances are recorded
with the JAX segment's Cholesky guard there (``jax_guard``).  Writes
``f2_flutter_check.json`` beside itself and the trajectories to
``--work``; with ``--save-states``, ``f2_flutter_states.npz``: the warm
start and the kept states named, each with JAX's ds64 and fp64
gradients (the inputs of ``tests/test_torch_f2_flutter.py``).

    python tests/golden_torch/f2_flutter_check.py --iters 12000 \\
        --ds64-seconds 1500 --work f2_work --save-states 6000,12000
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
OUT = HERE / "f2_flutter_check.json"
STATES = HERE / "f2_flutter_states.npz"
KINDS = ("jax_fp64", "jax_ds64", "port_fp64", "port_ds64")
EVERY = 1000
CHUNK = 100
PART_RTOL = 1e-6
CFG = {"dataset": "flutter", "case": 4, "iterations": 2000, "seed": 1,
       "rollout_qsqrt_dim0": True}
LEAF_ORDER = ("x", "u", "z", "kernel.log_variance", "kernel.log_lengthscales",
              "log_q", "c", "d", "log_rchol")
# The leaves C4 trains; u is collapsed and has no gradient.
TRAINED = ("x", "z", "kernel.log_variance", "kernel.log_lengthscales",
           "log_q", "c", "d", "log_rchol")


def _jax(x64: bool):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    return jax


def summary(leaves: dict) -> dict:
    """The budget Σ exp(log σ²)·C² and the largest Q, in float64."""
    lv = np.asarray(leaves["kernel.log_variance"], np.float64).reshape(-1)
    c = np.asarray(leaves["c"], np.float64)
    q = np.exp(np.asarray(leaves["log_q"], np.float64))
    return {"budget_s2C2": float((np.exp(lv)[:, None] * c * c).sum()),
            "max_Q": float(q.max())}


def jax_leaves(p) -> dict:
    return {"x": p.x, "u": p.u, "z": p.z,
            "kernel.log_variance": p.kernel.log_variance,
            "kernel.log_lengthscales": p.kernel.log_lengthscales,
            "log_q": p.log_q, "c": p.c, "d": p.d, "log_rchol": p.log_rchol}


def jax_params(leaves: dict, dtype):
    import jax.numpy as jnp
    from ffvd_tpu.model.params import GPSSMParams
    from ffvd_tpu.ops.kernels import KernelParams
    a = {k: jnp.asarray(np.asarray(v), dtype) for k, v in leaves.items()}
    return GPSSMParams(x=a["x"], u=a["u"], z=a["z"],
                       kernel=KernelParams(a["kernel.log_variance"],
                                           a["kernel.log_lengthscales"]),
                       log_q=a["log_q"], c=a["c"], d=a["d"],
                       log_rchol=a["log_rchol"])


def _trajectory_jax(kind: str, iters: int, deadline=None) -> dict:
    ds64 = kind == "jax_ds64"
    _jax(x64=not ds64)
    import jax.numpy as jnp
    from ffvd_tpu.api import FFVDModel
    from ffvd_tpu.config import FFVDConfig
    cfg = FFVDConfig(**CFG, collapse_precision="ds64" if ds64 else "native")
    model = FFVDModel(cfg, dtype=jnp.float32 if ds64 else jnp.float64)

    if not ds64:
        def fit(n):
            model.fit(n, chunk_size=CHUNK)
            np.asarray(model.nll_trace[-1])        # wait for the chunk
        return _trajectory(fit, lambda: {
            k: np.asarray(v) for k, v in jax_leaves(model.params).items()},
            lambda: np.asarray(model.nll_trace), iters, deadline)
    # The double-single trainer's scanned chunk did not finish compiling
    # in an hour on an 8-core CPU; one jitted ``Trainer.outer_step`` (the
    # body ``Trainer.run`` scans; C4 reads no key) compiles in minutes.
    import jax
    step = jax.jit(model.trainer.outer_step)
    box = {"state": model.state, "trace": []}

    def fit_steps(n):
        key = jax.random.key(0)
        for i in range(n):
            box["state"], nll = step(box["state"], key, model.data)
            box["trace"].append(np.asarray(nll))
            if deadline is not None and time.time() > deadline:
                return i + 1
        return n
    return _trajectory(fit_steps, lambda: {
        k: np.asarray(v) for k, v in
        jax_leaves(box["state"].params).items()},
        lambda: np.asarray(box["trace"], np.float64), iters, deadline)


def _trajectory_port(kind: str, iters: int, deadline=None) -> dict:
    import torch
    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.model.params import params_to_numpy
    torch.set_num_threads(1)
    ds64 = kind == "port_ds64"
    cfg = FFVDConfig(**CFG, collapse_precision="ds64" if ds64 else "native")
    model = FFVDModel(cfg, device="cpu",
                      dtype=torch.float32 if ds64 else torch.float64)
    return _trajectory(lambda n: model.fit(n, chunk_size=CHUNK),
                       lambda: params_to_numpy(model.params),
                       lambda: model.nll_trace.double().numpy(), iters,
                       deadline)


def _trajectory(fit, leaves, trace, iters: int, deadline=None) -> dict:
    """Fit ``iters`` iterations in chunks of ``CHUNK`` (``fit`` returns the
    iterations it ran, or None for all), stopping at the first chunk past
    ``deadline`` (a ``time.time()``); the summaries and leaves every
    ``EVERY`` iterations and at the end, the nll trace and the seconds."""
    checkpoints, states = [], {}
    t0 = time.time()
    done = 0
    while done < iters:
        n = min(CHUNK, iters - done)
        ran = fit(n)
        done += n if ran is None else ran
        late = deadline is not None and time.time() > deadline
        if done % EVERY and done < iters and not late:
            continue
        lv = {k: np.array(v, copy=True) for k, v in leaves().items()}
        tr = trace()
        checkpoints.append({"iteration": done, "nll": float(tr[-1]),
                            **summary(lv)})
        states[done] = lv
        print(f"{done}/{iters} {time.time() - t0:.0f} s "
              f"{checkpoints[-1]}", file=sys.stderr, flush=True)
        if late:
            break
    return {"checkpoints": checkpoints, "states": states,
            "trace": np.asarray(trace(), np.float64),
            "seconds": time.time() - t0}


def run_trajectory(kind: str, iters: int, work: Path,
                   seconds=None) -> None:
    """One trajectory, in this process, cut after about ``seconds`` when
    given; writes ``work/<kind>.npz``."""
    deadline = None if seconds is None else time.time() + seconds
    out = (_trajectory_jax if kind.startswith("jax") else
           _trajectory_port)(kind, iters, deadline)
    flat = {f"it{i}/{k}": v for i, lv in out["states"].items()
            for k, v in lv.items()}
    np.savez(work / f"{kind}.npz", trace=out["trace"],
             seconds=out["seconds"],
             checkpoints=json.dumps(out["checkpoints"]), **flat)


def first_parting(a: np.ndarray, b: np.ndarray, rtol=PART_RTOL):
    """The first iteration at which two nll traces differ by more than
    ``rtol`` relative, or None over their common length."""
    n = min(len(a), len(b))
    bad = np.nonzero(np.abs(a[:n] - b[:n]) > rtol * np.abs(b[:n]))[0]
    return int(bad[0]) if bad.size else None


def warm_leaves() -> dict:
    """The vendored flutter warm start, rounded to float32 (the point the
    ds64 segment evaluates at)."""
    from ffvd_tpu_torch.data import load_warmstart
    from ffvd_tpu_torch.model.params import (init_params_from_warmstart,
                                             params_to_numpy)
    return {k: v.astype(np.float32) for k, v in params_to_numpy(
        init_params_from_warmstart(load_warmstart("flutter"))).items()}


def _port_trainer(precision: str, dtype):
    import torch
    from ffvd_tpu_torch.config import FFVDConfig
    from ffvd_tpu_torch.data import create_dataset
    from ffvd_tpu_torch.inference.trainer import Trainer
    from ffvd_tpu_torch.model.params import SSMData
    ds = create_dataset("flutter")
    data = SSMData(y=torch.as_tensor(ds.y_train, dtype=dtype),
                   control=torch.as_tensor(ds.control, dtype=dtype))
    return Trainer(FFVDConfig(**CFG, collapse_precision=precision), data)


def port_grad(leaves: dict, precision: str, dtype=None) -> dict:
    """The port's gradient of its training objective at ``leaves``:
    "ds64" with float32 leaves, "native" in float64 (or in ``dtype``)."""
    import torch
    from ffvd_tpu_torch.inference.trainer import grads_of
    from ffvd_tpu_torch.model.params import params_from_numpy
    if dtype is None:
        dtype = torch.float32 if precision == "ds64" else torch.float64
    tr = _port_trainer(precision, dtype)
    p = params_from_numpy({k: np.asarray(v) for k, v in leaves.items()},
                          dtype=dtype)
    req = {k: v.detach().clone().requires_grad_(True)
           for k, v in p.leaves().items()}
    nll = tr.train_nll(type(p).from_leaves(req))
    g = grads_of(nll, [req[k] for k in TRAINED])
    return {k: v.detach().double().numpy() for k, v in zip(TRAINED, g)}


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(precision: str):
    """The jitted gradient of the JAX trainer's objective and its data
    (one compile a process: the double-single one takes minutes)."""
    import jax
    import jax.numpy as jnp
    from ffvd_tpu.config import FFVDConfig
    from ffvd_tpu.data import create_dataset
    from ffvd_tpu.inference.trainer import Trainer
    from ffvd_tpu.model.params import SSMData
    dtype = jnp.float32 if precision == "ds64" else jnp.float64
    ds = create_dataset("flutter")
    data = SSMData(y=jnp.asarray(ds.y_train, dtype),
                   control=jnp.asarray(ds.control, dtype))
    tr = Trainer(FFVDConfig(**CFG, collapse_precision=precision), data)
    return jax.jit(jax.grad(tr.nll_fn)), data, dtype


def jax_grad(leaves: dict, precision: str) -> dict:
    """The JAX package's gradient of its training objective at ``leaves``,
    under the process's ``jax_enable_x64``: "ds64" with float32 leaves,
    "native" in float64 (x64 on)."""
    fn, data, dtype = _jax_grad_fn(precision)
    g = fn(jax_params(leaves, dtype), data)
    gl = jax_leaves(g)
    return {k: np.asarray(gl[k], np.float64) for k in TRAINED}


def jax_guard(leaves: dict, threshold: float = 0.25) -> dict:
    """The seed-quality guard of the JAX package's double-single Cholesky
    (``ffvd_tpu/ops/ds64.py::chol_and_inv``) at ``leaves``, for its two
    factorisations in the ds64 objective, Kmm + jitter and H = A Aᵀ/Q + I:
    per latent dim ρ₀ = max|X₀ (A − L₀L₀ᵀ) X₀ᵀ| of the float32 seed (L₀ the
    float32 Cholesky of the matrix's high part, X₀ its inverse).  Where
    ρ₀ ≥ ``threshold`` the JAX segment returns the float32 seed for that
    matrix instead of the refined factor.  x64 must be off."""
    import jax.numpy as jnp
    from ffvd_tpu.data import create_dataset
    from ffvd_tpu.model import ds_collapse as dsc
    from ffvd_tpu.model.elbo import _gp_inputs
    from ffvd_tpu.model.params import SSMData
    from ffvd_tpu.ops import ds64 as ds
    from ffvd_tpu.ops.chol import _tri_inv
    p = jax_params(leaves, jnp.float32)
    fl = create_dataset("flutter")
    data = SSMData(y=jnp.asarray(fl.y_train, jnp.float32),
                   control=jnp.asarray(fl.control, jnp.float32))
    xc = _gp_inputs(p, data)
    m = p.z.shape[0]
    eye = jnp.eye(m, dtype=jnp.float32)
    kmm = dsc.se_cross(p.kernel, p.z, p.z)
    kmm = ds.add(kmm, ds.mul_f(ds.const(1e-5), eye))
    _, _, a, _ = dsc._ds_projection("SquaredExponential", p.kernel, p.z,
                                    xc, 1e-5)
    qinv = ds.exp(ds.neg(ds.lift(p.log_q)))
    aat = ds.matmul(a, ds.transpose(a))
    h = ds.add(ds.mul(aat, ds.dsmap(lambda t: t[:, None, None], qinv)),
               ds.lift(jnp.broadcast_to(eye, aat.hi.shape)))

    def rho(hi):
        l0 = jnp.linalg.cholesky(hi)
        x0 = _tri_inv(l0)
        g0 = x0 @ (hi - l0 @ l0.swapaxes(-1, -2)) @ x0.swapaxes(-1, -2)
        r = np.asarray(jnp.max(jnp.abs(g0), axis=(-2, -1)), np.float64)
        return np.where(np.isfinite(r), r, np.inf)

    hh = np.asarray(h.hi, np.float64) + np.asarray(h.lo, np.float64)
    r_k, r_h = rho(kmm.hi), rho(h.hi)
    return {"rho_kmm": r_k.tolist(), "rho_h": r_h.tolist(),
            "guarded_kmm": int((r_k >= threshold).sum()),
            "guarded_h": int((r_h >= threshold).sum()),
            "cond_h": [float(np.linalg.cond(hh[d]))
                       for d in range(hh.shape[0])]}


def distance(g: dict, ref: dict) -> dict:
    """‖g − ref‖/‖ref‖ over the trained leaves, and the largest
    elementwise |g − ref| / max(|ref|, 1)."""
    num = sum(float(((g[k] - ref[k]) ** 2).sum()) for k in TRAINED)
    den = sum(float((ref[k] ** 2).sum()) for k in TRAINED)
    elem = max(float((np.abs(g[k] - ref[k])
                      / np.maximum(np.abs(ref[k]), 1.0)).max())
               for k in TRAINED)
    return {"rel_norm": (num / den) ** 0.5, "max_elem": elem}


def _grads_child(which: str, path: str) -> None:
    """Gradients at every state of ``path`` (an npz of ``it<k>/<leaf>``);
    ``which``: "port", "jax32" (x64 off: ds64) or "jax64" (x64 on: ds64
    and native).  Writes ``path`` + ``.<which>.npz``."""
    if which.startswith("jax"):
        _jax(x64=which == "jax64")
    states = load_states(path)
    out = {}
    for it, lv in states.items():
        if which == "port":
            pairs = (("ds64", port_grad(lv, "ds64")),
                     ("native", port_grad(
                         {k: v.astype(np.float64) for k, v in lv.items()},
                         "native")))
        elif which == "jax32":
            pairs = (("ds64", jax_grad(lv, "ds64")),)
            out[f"it{it}/guard"] = json.dumps(jax_guard(lv))
        else:
            pairs = (("ds64", jax_grad(lv, "ds64")),
                     ("native", jax_grad(
                         {k: v.astype(np.float64) for k, v in lv.items()},
                         "native")))
        for prec, g in pairs:
            for k, v in g.items():
                out[f"it{it}/{prec}/{k}"] = v
        print(f"{which} grads at {it}", file=sys.stderr, flush=True)
    np.savez(f"{path}.{which}.npz", **out)


def load_states(path) -> dict:
    """{iteration: leaves} from an npz of ``it<k>/<leaf>`` arrays."""
    z = np.load(path)
    out = {}
    for key in z.files:
        if key.startswith("it"):
            it, leaf = key[2:].split("/", 1)
            if "/" not in leaf:
                out.setdefault(int(it), {})[leaf] = z[key]
    return dict(sorted(out.items()))


def _spawn(args: list, log: Path) -> subprocess.Popen:
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false",
           "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, __file__, *args], env=env,
                            stderr=open(log, "w"), cwd=ROOT)


def _wait(procs: dict) -> None:
    for name, p in procs.items():
        if p.wait():
            raise RuntimeError(f"{name} failed (rc {p.returncode})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=12000)
    ap.add_argument("--work", default=None,
                    help="directory for the trajectories and kept states")
    ap.add_argument("--ds64-seconds", type=float, default=None,
                    help="cut JAX's double-single trajectory after about "
                         "this many seconds (its jit alone takes minutes)")
    ap.add_argument("--reuse", action="store_true",
                    help="keep the trajectories already in --work")
    ap.add_argument("--save-states", default=None,
                    help="iterations of port_ds64 to keep, with the JAX "
                         "gradients there, in f2_flutter_states.npz "
                         "(comma-separated; the warm start is always kept)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seconds", type=float, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--grads", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    work = Path(args.work or Path(tempfile.gettempdir()) / "f2_flutter")
    work.mkdir(parents=True, exist_ok=True)
    if args.child:
        run_trajectory(args.child, args.iters, work, args.seconds)
        return 0
    if args.grads:
        which, path = args.grads.split(":", 1)
        _grads_child(which, path)
        return 0

    t0 = time.time()
    todo = [k for k in KINDS
            if not (args.reuse and (work / f"{k}.npz").exists())]
    _wait({k: _spawn(["--child", k, "--iters", str(args.iters), "--work",
                      str(work)] + (
                          ["--seconds", str(args.ds64_seconds)]
                          if k == "jax_ds64" and args.ds64_seconds else []),
                     work / f"{k}.log") for k in todo})
    runs = {k: np.load(work / f"{k}.npz") for k in KINDS}
    doc = {"config": {**CFG, "iterations_asked": args.iters,
                      "checkpoint_every": EVERY, "parting_rtol": PART_RTOL},
           "trajectories": {
               k: {"checkpoints": json.loads(str(z["checkpoints"])),
                   "iterations": int(len(z["trace"])),
                   "seconds": float(z["seconds"]),
                   "nll_first": float(z["trace"][0])}
               for k, z in runs.items()},
           "common_length": min(int(len(z["trace"])) for z in runs.values()),
           "first_parting": {
               f"{a} vs {b}": first_parting(runs[a]["trace"],
                                            runs[b]["trace"])
               for a, b in (("port_fp64", "jax_fp64"),
                            ("port_ds64", "jax_ds64"),
                            ("jax_ds64", "jax_fp64"),
                            ("port_ds64", "port_fp64"))}}

    # the gradients at the warm start and at port_ds64's kept states
    states = {0: warm_leaves(), **load_states(work / "port_ds64.npz")}
    spath = work / "grad_states.npz"
    if not (args.reuse and spath.exists()):
        np.savez(spath, **{f"it{i}/{k}": v for i, lv in states.items()
                           for k, v in lv.items()})
    _wait({w: _spawn(["--grads", f"{w}:{spath}"], work / f"grads_{w}.log")
           for w in ("port", "jax32", "jax64")
           if not (args.reuse and Path(f"{spath}.{w}.npz").exists())})
    g = {w: np.load(f"{spath}.{w}.npz") for w in ("port", "jax32", "jax64")}

    def grad(w, it, prec):
        return {k: g[w][f"it{it}/{prec}/{k}"] for k in TRAINED}

    import torch
    doc["gradients"] = {}
    for it in states:
        fp64 = grad("jax64", it, "native")
        doc["gradients"][str(it)] = {
            "port_ds64 vs jax_ds64": distance(grad("port", it, "ds64"),
                                              grad("jax32", it, "ds64")),
            "port_ds64 vs fp64": distance(grad("port", it, "ds64"), fp64),
            "jax_ds64 vs fp64": distance(grad("jax32", it, "ds64"), fp64),
            "jax_ds64 x64-on vs x64-off": distance(
                grad("jax64", it, "ds64"), grad("jax32", it, "ds64")),
            "port_fp64 vs jax_fp64": distance(grad("port", it, "native"),
                                              fp64),
            "port_fp32 vs fp64": distance(port_grad(
                states[it], "native", torch.float32), fp64),
            "jax_ds64_guard": json.loads(str(g["jax32"][f"it{it}/guard"])),
            **summary(states[it])}
    doc["seconds"] = time.time() - t0
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    if args.save_states:
        keep = [0] + [int(s) for s in args.save_states.split(",")]
        out = {}
        for i in keep:
            out.update({f"it{i}/{k}": v for k, v in states[i].items()})
            for name, (w, prec) in (("jax_ds64", ("jax32", "ds64")),
                                    ("jax_fp64", ("jax64", "native"))):
                out.update({f"it{i}/{name}/{k}": v
                            for k, v in grad(w, i, prec).items()})
        np.savez_compressed(STATES, **out)
    print(json.dumps({k: doc[k] for k in ("first_parting",)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
