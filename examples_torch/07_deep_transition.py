"""Deep (2-layer) GP transition versus the shallow one — the reference's
dead ``--n_layers`` path made live (model/deep.py; its ``propagate``,
dgp_model.py:362-379, has no call site upstream).

The hidden layer is a doubly-stochastic whitened sparse GP grafted between
the state and the head GP; at init (hidden U = 0) the model IS the shallow
one, so the comparison below starts from identical objectives.

Run:  python examples_torch/07_deep_transition.py  [--cpu] [--quick]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import dataclasses

import torch

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data.synthetic import generate_kink
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.params import (SSMData, init_hidden_layers,
                                         init_params_random)
from ffvd_tpu_torch.utils.device import default_dtype, resolve_device

DEVICE = resolve_device("cpu" if "--cpu" in sys.argv else "cuda")
DTYPE = default_dtype(DEVICE)
QUICK = "--quick" in sys.argv             # a few iterations, for the tests

ds = generate_kink(n=100, seed=0)
data = SSMData(y=torch.as_tensor(ds.y_train, dtype=DTYPE, device=DEVICE),
               control=torch.zeros((200, 0), dtype=DTYPE, device=DEVICE))
shallow = init_params_random(n=100, x_dim=2, m=16, control_dim=0, p=1,
                             generator=torch.Generator().manual_seed(0),
                             device=DEVICE, dtype=DTYPE)
deep = dataclasses.replace(shallow, hidden=init_hidden_layers(
    1, shallow, generator=torch.Generator().manual_seed(1)))

for name, n_layers, params in (("shallow", 1, shallow), ("deep-2", 2, deep)):
    cfg = FFVDConfig(case=1, num_inducing=16, x_dim=2, iterations=200,
                     n_layers=n_layers)
    tr = Trainer(cfg, data)
    state, nlls = tr.run(tr.init_state(params), 4 if QUICK else 400,
                         chunk_size=200,
                         generator=torch.Generator(DEVICE).manual_seed(2))
    print(f"{name}: nll {float(nlls[0]):+.4f} -> {float(nlls[-1]):+.4f}")
