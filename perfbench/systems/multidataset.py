"""Several datasets in one batched step: one ``MultiDatasetTrainer`` of the
port.

The configuration names the datasets and the number of inducing points M.
Each model starts from its dataset's warm start with the inducing set grown
to M (``parallel.stack_datasets(m=, seed=)``, drawing from a
``RandomState`` whose seed the benchmark takes from the run's seed); the
datasets are padded to the longest and masked.  Training is
``MultiDatasetTrainer.run``; an evaluation is
``MultiDatasetTrainer.evaluate``: each dataset's S rollouts over its own
test half, one launch a dataset, and its RMSE and NLL over the whole test
half (``horizon`` = the longest test half; the published score reads the
first 30 steps, which would leave the rest of the rollout unread).
"""

from __future__ import annotations

import numpy as np

from perfbench.systems.base import TrainerSystem


def make_inputs(cfg: dict, rng: np.random.Generator, ref, data_dir):
    """The port's inputs: the seed of the inducing sets' growth and the
    training generator's."""
    return {"resize_seed": int(rng.integers(2 ** 32)),
            "train_seed": int(rng.integers(2 ** 62))}


def make_members(cfg: dict, inputs: dict, ref, data_dir) -> list:
    """One reference member a dataset: its series and its starting leaves
    (float64), the inducing set grown to M from the same seed."""
    m = cfg["model"]["num_inducing"]
    return [{"series": ref.load_series(data_dir, name),
             "leaves": ref.resize_inducing(
                 ref.warm_start(data_dir, name, cfg["file_id"]), m,
                 inputs["resize_seed"])}
            for name in cfg["datasets"]]


class System(TrainerSystem):
    def __init__(self, cfg: dict, inputs: dict, device, dtype):
        import torch

        from ffvd_tpu_torch.config import FFVDConfig
        from ffvd_tpu_torch.data import create_dataset
        from ffvd_tpu_torch.parallel import (MultiDatasetTrainer,
                                             stack_datasets)

        names = cfg["datasets"]
        self.cfg = FFVDConfig(**cfg["model"], dataset=names[0])
        data, params, self.lens = stack_datasets(
            names, file_id=cfg["file_id"], device=device, dtype=dtype,
            m=self.cfg.num_inducing, seed=inputs["resize_seed"])
        self.trainer = MultiDatasetTrainer(self.cfg, data)
        self.state = self.trainer.init_state(params)
        self.generator = torch.Generator(device=device).manual_seed(
            inputs["train_seed"])
        self.datasets = [create_dataset(n) for n in names]
        self.members = len(names)
        self.horizon = max(ds.n_test for ds in self.datasets)
        d, cu = self.cfg.x_dim, data.control.shape[-1]
        s = self.cfg.num_posterior_samples
        self.work = {"n": list(self.lens), "m": self.cfg.num_inducing,
                     "d": d, "din": d + cu, "cu": cu,
                     "itemsize": torch.finfo(dtype).bits // 8,
                     "launches": [{"rows": s, "steps": ds.n_test, "sets": 1}
                                  for ds in self.datasets]}

    def evaluate(self, call_seed: int):
        """One evaluation of every dataset, its rollout keys drawn from a
        CPU generator seeded with ``call_seed``: {name: {rmse, nll}} over
        each whole test half."""
        import torch
        return self.trainer.evaluate(
            self.state, self.datasets, self.lens,
            generator=torch.Generator().manual_seed(call_seed),
            horizon=self.horizon)


def expected(ref, members, trained: dict, call_seed: int, s: int, dtype,
             device):
    """The reference's scores from the leaves ``trained`` (path → one array
    a dataset) that the reference trained itself: per dataset, q(U) of its
    real trajectory, S rollouts over its whole test half under its key,
    RMSE and NLL over them."""
    import torch

    seeds = ref.keys_of(call_seed, len(members))
    out = []
    for i, (mem, seed) in enumerate(zip(members, seeds)):
        ser = mem["series"]
        n = ser["y_train"].shape[0]
        p = {k: torch.as_tensor(v[i], dtype=dtype, device=device)
             for k, v in trained.items()}
        p["x"] = p["x"][:n + 1]
        ctrl = torch.as_tensor(ser["control"], dtype=dtype, device=device)
        t_len = ser["y_test"].shape[0]
        controls = ctrl[n:n + t_len]
        d = p["x"].shape[1]
        noise = ref.philox_normals(ref.keys_of(seed)[0], (s, t_len, d),
                                   dtype, device)
        xs, vs = ref.rollout([p], [ref.rollout_inputs(p, ctrl, n)], controls,
                             noise[None])
        y_s, v_s, r2 = ref.emission_moments(p, xs[0], vs[0])
        y_test = torch.as_tensor(ser["y_test"], dtype=dtype, device=device)
        rmse, nll = ref.scores(y_test, y_s, v_s, r2, ser["y_train_std"],
                               horizon=t_len)
        out.append({"rmse": rmse, "nll": nll})
    return out


def compare(got, want) -> dict:
    """Widest relative gaps of the datasets' RMSE and NLL (the NLL's over
    max(|NLL|, 1)); ``got`` the program's {name: scores} or a list."""
    got = list(got.values()) if isinstance(got, dict) else got
    return {
        "rmse_gap": max(abs(g["rmse"] - w["rmse"]) / w["rmse"]
                        for g, w in zip(got, want)),
        "nll_gap": max(abs(g["nll"] - w["nll"]) / max(abs(w["nll"]), 1.0)
                       for g, w in zip(got, want))}
