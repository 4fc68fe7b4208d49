"""Experiment driver CLI — counterpart of ``ffvd_tpu/cli.py`` (the rebuild of
the reference's ``FFVD_Main.py``).

Usage:  python -m ffvd_tpu_torch.cli --file_index 5 --case_val 4

The flags are the JAX CLI's.  ``--platform`` is ``gpu`` (the default; fails
without a CUDA device) or ``cpu``; ``--precision`` defaults to fp32 on the
card and fp64 on the CPU.  ``--prng_impl rbg`` selects a JAX PRNG, which
does not apply to the port (its draws come from ``torch.Generator``s): it
stops with an error that says so.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run an FFVD-GPSSM experiment (PyTorch/CUDA port)")
    p.add_argument("--num_inducing", type=int, default=100)
    p.add_argument("--minibatch_size", type=int, default=None)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--posterior_sample_spacing", type=int, default=32)
    p.add_argument("--file_id", type=int, default=3)
    p.add_argument("--file_index", type=int, default=2)
    p.add_argument("--case_val", type=int, default=4)
    p.add_argument("--x_dims", type=int, default=4)
    p.add_argument("--samples", type=int, default=10)
    p.add_argument("--n_layers", type=int, default=1)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--kernel_type", choices=["SquaredExponential", "LinearK"],
                   default="SquaredExponential")
    p.add_argument("--kernel_train_flag", type=_str2bool, default=True)
    p.add_argument("--data_index", type=int, default=4)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--prior_type",
                   choices=["determinantal", "normal", "strauss", "uniform"],
                   default="normal")
    p.add_argument("--prng_impl", choices=["threefry2x32", "rbg"],
                   default="threefry2x32",
                   help="JAX PRNG choice; not applicable here: the port "
                        "draws its SG-HMC noise and window feeds from a "
                        "torch.Generator seeded by --seed and its rollout "
                        "noise from Philox, so only the default is accepted")
    p.add_argument("--hyperparameter_sampling", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_ensemble", type=int, default=1,
                   help="train K independent chains (seeds seed..seed+K-1) "
                        "and report the pooled mixture prediction "
                        "(PARITY.md §2d)")
    p.add_argument("--eval_spread", action="store_true",
                   help="keep the across-rollout spread of predictive means "
                        "in the predictive variance")
    p.add_argument("--rollout_qsqrt_dim0", action="store_true",
                   help="bug-compat: reproduce the reference's rollout "
                        "variance slip (conditionals_multi_output.py:322)")
    p.add_argument("--pg_ancestor_trace", type=_str2bool, nargs="?",
                   const=True, default=None)
    p.add_argument("--pg_particles", type=int, default=100)
    p.add_argument("--pg_compat_noop", action="store_true")
    p.add_argument("--sghmc_log_clip", type=str, default=None)
    p.add_argument("--sghmc_log_clip_lower", type=str, default=None)
    p.add_argument("--deep_sample_hidden", action="store_true")
    p.add_argument("--tensorboard_dir", type=str, default=None)
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--precision", choices=["fp32", "fp64"], default=None,
                   help="default: fp64 on cpu, fp32 on gpu")
    p.add_argument("--collapse_precision",
                   choices=["native", "ds64", "hybrid"], default="native",
                   help="'ds64' evaluates the collapsed GP bound as one "
                        "float64 segment at the float32 parameter values "
                        "(DESIGN.md §12); 'hybrid' trains native and runs "
                        "the last --hybrid_tail_iters iterations, and the "
                        "evaluation, on it")
    p.add_argument("--hybrid_tail_iters", type=int, default=500)
    p.add_argument("--ds64_refine", type=int, default=None,
                   help="accepted for the JAX CLI's sake; float64 has no "
                        "double-single refinement, so it has no effect")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--chunk_size", type=int, default=500)
    return p


def _log_clip_kwargs(value, lower=None):
    """Parse --sghmc_log_clip[_lower] as the JAX CLI does."""
    kw = {}
    if value is not None:
        if value.strip().lower() in ("none", "off") or float(value) == 0.0:
            kw["sghmc_log_clip"] = None
        else:
            kw["sghmc_log_clip"] = float(value)
    if lower is not None:
        if lower.strip().lower() in ("none", "off"):
            kw["sghmc_log_clip_lower"] = None
        else:
            kw["sghmc_log_clip_lower"] = float(lower)
    return kw


def _not_applicable(args):
    """The flags that select a JAX-only path, which the port does not
    have."""
    out = []
    if args.prng_impl != "threefry2x32":
        out.append("--prng_impl rbg (a JAX PRNG; the port draws from "
                   "torch.Generator)")
    return out


def _results_path(args, dataset, cfg):
    """Results-npz path, reference naming scheme (base_model.py:512-517)."""
    fileid = datetime.now().strftime("%Y_%m_%d_%H_%M_%S_%f") \
        + f"file_id{args.file_id}"
    case = cfg.case_config.name
    return os.path.join(
        args.results_dir, dataset,
        f"{case}VFE_result_{dataset}_{fileid}.npz_results.npz")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    jax_only = _not_applicable(args)
    if jax_only:
        raise SystemExit("does not apply to the PyTorch port: "
                         + "; ".join(jax_only))

    import torch

    from ffvd_tpu_torch.api import FFVDModel
    from ffvd_tpu_torch.config import FILE_INDEX_ORDER, FFVDConfig
    from ffvd_tpu_torch.utils.device import default_dtype, resolve_device

    device = resolve_device("cuda" if args.platform == "gpu" else "cpu")
    dtype = default_dtype(device, args.precision)
    precision = "fp64" if dtype == torch.float64 else "fp32"
    dataset = FILE_INDEX_ORDER[args.file_index]
    cfg = FFVDConfig(
        dataset=dataset, case=args.case_val, num_inducing=args.num_inducing,
        x_dim=args.x_dims, iterations=args.iterations,
        num_posterior_samples=args.samples,
        posterior_sample_spacing=args.posterior_sample_spacing,
        prior_type=args.prior_type, kernel_type=args.kernel_type,
        kernel_train_flag=args.kernel_train_flag, file_id=args.file_id,
        hyperparameter_sampling=args.hyperparameter_sampling,
        prng_impl=args.prng_impl, pg_particles=args.pg_particles,
        seed=args.seed,
        minibatch_size=args.minibatch_size, n_layers=args.n_layers,
        rollout_qsqrt_dim0=args.rollout_qsqrt_dim0,
        pg_compat_noop=args.pg_compat_noop,
        pg_ancestor_trace=args.pg_ancestor_trace,
        deep_sample_hidden=args.deep_sample_hidden,
        collapse_precision=args.collapse_precision,
        ds64_refine=args.ds64_refine,
        hybrid_tail_iters=args.hybrid_tail_iters,
        **_log_clip_kwargs(args.sghmc_log_clip, args.sghmc_log_clip_lower))

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"#### {dataset} | case C{cfg.case} | {name} {precision} ####")

    if args.n_ensemble > 1:
        return _ensemble(args, cfg, dataset, device, dtype)

    model = FFVDModel(cfg, device=device, dtype=dtype)

    t0 = time.time()
    model.fit(chunk_size=args.chunk_size,
              tensorboard_dir=args.tensorboard_dir)
    nlls = model.nll_trace
    nll_first, nll_last = float(nlls[0]), float(nlls[-1])   # synchronises
    train_time = time.time() - t0
    print(f"trained {cfg.total_iterations} iters in {train_time:.2f}s "
          f"({cfg.total_iterations / train_time:.1f} it/s); "
          f"nll {nll_first:.4f} -> {nll_last:.4f}")

    t1 = time.time()
    res = model.evaluate(spread=args.eval_spread)
    eval_time = time.time() - t1
    print(f"RMSE: {res['rmse']:.6f}  NLL: {res['nll']:.6f}  "
          f"(eval {eval_time:.2f}s)")

    out = _results_path(args, dataset, cfg)
    model.save_results(out, case=cfg.case_config.name)
    print(f"saved {out}")
    return {"rmse": res["rmse"], "nll": res["nll"],
            "train_time": train_time, "final_elbo": -nll_last}


def _ensemble(args, cfg, dataset, device, dtype):
    """--n_ensemble K: K chains trained one after another, pooled; the
    results npz holds the pooled predictions beside chain 0's parameters
    and ELBO trace (``ffvd_tpu/cli.py:220-246``)."""
    from ffvd_tpu_torch.eval.ensemble import ensemble_evaluate, fit_ensemble
    if args.eval_spread:
        print("note: --eval_spread is subsumed by ensemble pooling "
              "(the mixture's cross-chain spread term is always on)")
    t0 = time.time()
    models = fit_ensemble(cfg, args.n_ensemble, device=device, dtype=dtype,
                          chunk_size=args.chunk_size)
    final_elbo = -float(models[0].nll_trace[-1])            # synchronises
    train_time = time.time() - t0
    res = ensemble_evaluate(models)
    for i, pc in enumerate(res["per_chain"]):
        print(f"chain {i} (seed {cfg.seed + i}): "
              f"RMSE {pc['rmse']:.6f}  NLL {pc['nll']:.6f}")
    print(f"ensemble({args.n_ensemble}) pooled: "
          f"RMSE: {res['rmse']:.6f}  NLL: {res['nll']:.6f}  "
          f"(no-spread NLL {res['nll_no_spread']:.6f}; "
          f"trained {train_time:.2f}s)")
    out = _results_path(args, dataset, cfg)
    models[0].save_results(
        out, case=cfg.case_config.name,
        predictions=(res["predict_y"], res["predict_y_var"]))
    print(f"saved {out}")
    return {"rmse": res["rmse"], "nll": res["nll"],
            "per_chain": res["per_chain"], "train_time": train_time,
            "final_elbo": final_elbo}


if __name__ == "__main__":
    main()
