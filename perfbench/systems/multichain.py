"""Seeds of one dataset side by side: one ``MultiChainTrainer`` of the port.

The configuration names one dataset and a number of chains.  Each chain
starts from the dataset's warm start with every leaf perturbed by
1e-3·N(0, 1); the benchmark draws those normals from the run's seed and
hands them to the port (``MultiChainTrainer.stack_params(normals=)``) and
to the reference alike.  Training is ``MultiChainTrainer.run``; an
evaluation is ``eval.ensemble.multichain_moments`` over the test half,
each chain's emission moments back on the host.
"""

from __future__ import annotations

import numpy as np

from perfbench.systems.base import TrainerSystem


def make_inputs(cfg: dict, rng: np.random.Generator, ref, data_dir):
    """The port's inputs: the chains' perturbations, drawn at the warm
    start's shapes, and the training generator's seed."""
    name = cfg["datasets"][0]
    base = ref.warm_start(data_dir, name, cfg["file_id"])
    c = cfg["chains"]
    normals = {k: rng.standard_normal((c,) + v.shape) for k, v in base.items()}
    return {"normals": normals, "train_seed": int(rng.integers(2 ** 62))}


def make_members(cfg: dict, inputs: dict, ref, data_dir) -> list:
    """One reference member a chain: its series and its starting leaves
    (float64), from the raw files and the same perturbations."""
    name = cfg["datasets"][0]
    base = ref.warm_start(data_dir, name, cfg["file_id"])
    series = ref.load_series(data_dir, name)
    normals = inputs["normals"]
    return [{"series": series,
             "leaves": {k: v + cfg["init_jitter"] * normals[k][i]
                        for k, v in base.items()}}
            for i in range(cfg["chains"])]


class System(TrainerSystem):
    def __init__(self, cfg: dict, inputs: dict, device, dtype):
        import torch

        from ffvd_tpu_torch.config import FFVDConfig
        from ffvd_tpu_torch.data import create_dataset, load_warmstart
        from ffvd_tpu_torch.model.params import (SSMData,
                                                 init_params_from_warmstart)
        from ffvd_tpu_torch.parallel import MultiChainTrainer

        name = cfg["datasets"][0]
        ds = create_dataset(name)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.cfg = FFVDConfig(**cfg["model"], dataset=name)
        self.trainer = MultiChainTrainer(
            self.cfg, SSMData(y=as_t(ds.y_train), control=as_t(ds.control)),
            cfg["chains"])
        start = init_params_from_warmstart(
            load_warmstart(name, cfg["file_id"]), device=device, dtype=dtype)
        self.state = self.trainer.init_state(self.trainer.stack_params(
            start, normals=inputs["normals"]))
        self.generator = torch.Generator(device=device).manual_seed(
            inputs["train_seed"])
        self.members = cfg["chains"]
        self.test_len = ds.n_test
        n, d = ds.n_train, self.cfg.x_dim
        s = self.cfg.num_posterior_samples
        self.work = {"n": [n] * self.members, "m": self.cfg.num_inducing,
                     "d": d, "din": d + ds.control.shape[1],
                     "cu": ds.control.shape[1],
                     "itemsize": torch.finfo(dtype).bits // 8,
                     "launches": [{"rows": self.members * s,
                                   "steps": self.test_len,
                                   "sets": self.members}]}

    def evaluate(self, call_seed: int):
        """One evaluation: every chain's S rollouts in one launch, with the
        rollout key drawn from a CPU generator seeded with ``call_seed``;
        per chain (y_s, v_s, r2) on the host."""
        import torch

        from ffvd_tpu_torch.eval.ensemble import multichain_moments
        chains, _ = multichain_moments(
            self.trainer, self.state, self.test_len,
            generator=torch.Generator().manual_seed(call_seed))
        return chains


def expected(ref, members, trained: dict, call_seed: int, s: int, dtype,
             device):
    """The reference's chain moments from the leaves ``trained`` (path →
    one array a chain) that the reference trained itself: q(U), the
    rollouts under the same key, the emission moments, per chain."""
    import torch

    sets, inputs = [], []
    for i, mem in enumerate(members):
        p = {k: torch.as_tensor(v[i], dtype=dtype, device=device)
             for k, v in trained.items()}
        ser = mem["series"]
        ctrl = torch.as_tensor(ser["control"], dtype=dtype, device=device)
        n = ser["y_train"].shape[0]
        sets.append(p)
        inputs.append(ref.rollout_inputs(p, ctrl, n))
    t_len = ser["y_test"].shape[0]
    controls = ctrl[n:n + t_len]
    d = sets[0]["x"].shape[1]
    key = ref.keys_of(call_seed)[0]
    noise = ref.philox_normals(key, (len(sets) * s, t_len, d), dtype, device)
    xs, vs = ref.rollout(sets, inputs, controls,
                         noise.reshape(len(sets), s, t_len, d))
    out = []
    for p, x, v in zip(sets, xs, vs):
        y_s, v_s, r2 = ref.emission_moments(p, x, v)
        out.append(tuple(t.double().cpu().numpy() for t in (y_s, v_s, r2)))
    return out


def compare(got, want) -> dict:
    """Widest gaps of the chains' emission means (over the spread of the
    reference's) and variances (over its median)."""
    y_p = np.stack([c[0] for c in got])
    y_r = np.stack([c[0] for c in want])
    v_p = np.stack([c[1] for c in got])
    v_r = np.stack([c[1] for c in want])
    return {"y_gap": float(np.max(np.abs(y_p - y_r)) / np.std(y_r)),
            "v_gap": float(np.max(np.abs(v_p - v_r)) / np.median(v_r))}
