"""Several datasets trained in one batched step: BASELINE.md stress config 5.

Counterpart of ``ffvd_tpu/parallel/multidataset.py``.  Datasets of
different lengths are padded to a common N with a transition mask (the
masked ELBO normalises each by its real length), their parameters are
stacked on a leading axis, and ``BatchedTrainer`` (``parallel/sharding.py``)
runs the full training protocol over that axis with the data batched too:
one step's launches train every model.  On a ('dp', 'ep') mesh the datasets
split over 'dp' and each model's D per-dim GPs over 'ep', as in
``MultiChainTrainer`` (``ffvd_tpu/parallel/multidataset.py:7-8``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.inference.trainer import Trainer, TrainState
from ffvd_tpu_torch.model.params import (GPSSMParams, SSMData,
                                         init_params_from_warmstart)
from ffvd_tpu_torch.parallel.distributed import all_sum
from ffvd_tpu_torch.parallel.sharding import (MeshBatchedTrainer, axis_index,
                                              member, stack_members)


def pad_dataset(data: SSMData, params: GPSSMParams, n_pad: int
                ) -> Tuple[SSMData, GPSSMParams]:
    """Pad one dataset and its params to ``n_pad`` transitions: y with zero
    rows, control (train and test rows) to 2·n_pad rows, a mask that is 1
    on the real transitions, and x to n_pad+1 rows that repeat the last
    state (the masked objective never reads them)."""
    n = data.y.shape[0]
    pad = n_pad - n
    if pad < 0:
        raise ValueError(f"n_pad {n_pad} < dataset length {n}")
    y = torch.cat([data.y, data.y.new_zeros((pad, data.y.shape[1]))])
    c_pad = max(2 * n_pad - data.control.shape[0], 0)
    control = torch.cat([data.control,
                         data.control.new_zeros((c_pad,
                                                 data.control.shape[1]))])
    mask = torch.cat([data.y.new_ones((n,)), data.y.new_zeros((pad,))])
    x_pad = params.x[-1].expand(pad, params.x.shape[1])
    params = dataclasses.replace(params, x=torch.cat([params.x, x_pad]))
    return SSMData(y=y, control=control, mask=mask), params


def stack_datasets(names: Sequence[str], file_id: int = 3, device="cpu",
                   dtype=torch.float64, m: Optional[int] = None,
                   seed: int = 0) -> Tuple[SSMData, GPSSMParams, List[int]]:
    """Load, warm-start, pad and stack several datasets.  ``m`` resizes the
    inducing set of every model (``_resize_inducing``; the warm starts carry
    M=100).  Returns (stacked data, stacked params, the real lengths)."""
    datas, paramss, lens = [], [], []
    for name in names:
        ds = create_dataset(name)
        params = init_params_from_warmstart(load_warmstart(name, file_id),
                                            device=device, dtype=dtype)
        if m is not None and m != params.z.shape[0]:
            params = _resize_inducing(params, m, seed)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        datas.append(SSMData(y=as_t(ds.y_train), control=as_t(ds.control)))
        paramss.append(params)
        lens.append(ds.n_train)
    n_pad = max(lens)
    padded = [pad_dataset(d, p, n_pad) for d, p in zip(datas, paramss)]
    data = SSMData(*(torch.stack([getattr(d, f) for d, _ in padded])
                     for f in ("y", "control", "mask")))
    return data, stack_members([p for _, p in padded]), lens


def _resize_inducing(params: GPSSMParams, m: int, seed: int) -> GPSSMParams:
    """Grow or shrink the inducing set, drawing from
    ``np.random.RandomState(seed)`` in the JAX package's order, so Z and U
    equal its own: m < M subsamples rows; m > M adds points drawn from the
    latent trajectory's states (plus N(0, 1) control columns and
    0.1·N(0, 1) jitter), so Z stays well separated and Kmm well
    conditioned, with zero U rows.  The reference has no resize."""
    if params.hidden:
        raise ValueError("resize the inducing set before attaching deep "
                         "hidden layers (api.py grafts hidden AFTER resize)")
    m0, din = params.z.shape
    rng = np.random.RandomState(seed)
    if m <= m0:
        idx = torch.as_tensor(rng.choice(m0, size=m, replace=False),
                              device=params.z.device)
        z, u = params.z[idx], params.u[idx]
    else:
        extra = m - m0
        x = params.x.detach().cpu().numpy()
        rows = x[rng.choice(x.shape[0], size=extra)]
        ctrl = rng.randn(extra, din - x.shape[1])
        z_new = np.concatenate([rows, ctrl], axis=1) \
            + 0.1 * rng.randn(extra, din)
        z = torch.cat([params.z, torch.as_tensor(
            z_new, dtype=params.z.dtype, device=params.z.device)])
        u = torch.cat([params.u, params.u.new_zeros((extra,
                                                     params.u.shape[1]))])
    return dataclasses.replace(params, z=z, u=u)


class MultiDatasetTrainer(MeshBatchedTrainer):
    """The FFVD protocol over a stacked-dataset axis, the data batched too
    (``ffvd_tpu/parallel/multidataset.py:110-187``).  With a ``mesh`` this
    process trains datasets [m0, m1) over 'dp' (``stacked_data`` is the
    whole stack) and its block of each model's latent dims over 'ep'."""

    axis_name = "dataset"

    def __init__(self, cfg: FFVDConfig, stacked_data: SSMData, mesh=None,
                 pg_fn=None):
        super().__init__(cfg, stacked_data, stacked_data.y.shape[0],
                         data_axis=True, mesh=mesh, pg_fn=pg_fn)

    @torch.no_grad()
    def evaluate(self, state: TrainState, datasets, lens,
                 generator: Optional[torch.Generator] = None,
                 horizon: int = 30, thin_generator=None, noise=None):
        """Per-dataset posterior-rollout RMSE/NLL after stacked training.

        ``datasets``: the loader objects (y_test, y_train_std, control);
        ``lens``: the real lengths from ``stack_datasets``.  Each model's
        params are un-padded to x[:n+1] and evaluated through a single
        ``Trainer``'s ``collect_posterior``, so each dataset is one rollout
        launch on the card.  Dataset i draws from its own generators, seeded
        by the i-th draws of ``generator`` (the rollout seeds) and
        ``thin_generator`` (a sampler case's thinning normals), as JAX
        splits its key per dataset; ``noise``, one (S, T, D) tensor per
        dataset, replaces the rollout noise.  For an SG-HMC case the
        thinning restarts its preconditioner, as in JAX.

        ``datasets`` and ``lens`` may stop short of the stack: the first
        ones are evaluated.  On a mesh they are the whole lists; the first
        process of each 'ep' group evaluates its datasets with all D dims,
        and every process returns the whole dict."""
        from ffvd_tpu_torch.eval.rollout import (collect_posterior,
                                                 predict_summary, rmse_nll)
        from ffvd_tpu_torch.ops.rollout import draw_seed
        if self.has_sghmc:
            warnings.warn(
                "MultiDatasetTrainer.evaluate restarts the SGHMC "
                "preconditioner for the eval thinning chain — sampler-case "
                f"(C{self.cfg.case}) results are approximate; for exact "
                "reference eval semantics run each dataset through a single "
                "Trainer whose state carries the trained preconditioner.",
                stacklevel=2)
        def per_dataset(g):
            if g is None:
                return [None] * len(datasets)
            return [torch.Generator(device=g.device).manual_seed(
                draw_seed(g)) for _ in datasets]

        gens, thin_gens = per_dataset(generator), per_dataset(thin_generator)
        params = self.whole_dims(state.params)
        dt, dev = params.x.dtype, params.x.device
        as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        m0, m1 = self.place.members
        # (rmse, nll) of every dataset; each filled by one process.
        table = torch.zeros((len(datasets), 2), dtype=torch.float64,
                            device=dev)
        for i in (range(m0, min(m1, len(datasets)))
                  if axis_index(self.mesh, "ep") == 0 else ()):
            ds, n = datasets[i], lens[i]
            p = member(params, i - m0)
            p = dataclasses.replace(p, x=p.x[:n + 1])
            tr = Trainer(self.cfg, SSMData(y=as_t(ds.y_train),
                                           control=as_t(ds.control)))
            xs, vs, _ = collect_posterior(
                tr, tr.init_state(p), ds.n_test, generator=gens[i],
                thin_generator=thin_gens[i],
                noise=None if noise is None else noise[i])
            py, pv, _ = predict_summary(p, xs, vs, self.cfg.emission_noise)
            rmse, nll = rmse_nll(as_t(ds.y_test), py, pv, ds.y_train_std,
                                 horizon=horizon)
            table[i, 0], table[i, 1] = float(rmse), float(nll)
        if self.mesh is not None:
            all_sum(table, dist.group.WORLD)
        return {ds.name: {"rmse": float(table[i, 0]),
                          "nll": float(table[i, 1])}
                for i, ds in enumerate(datasets)}
