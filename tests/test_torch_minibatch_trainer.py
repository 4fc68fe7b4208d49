"""Port parity, random-window minibatch training: the trainer's windowed
branches (``inference/trainer.py``) and the entry points, against the JAX
package.  The windowed objective itself is held in
tests/test_torch_minibatch.py, whose kink model this file shares.

- The trainer, windowed C4 and C5 and windowed deep C5, against the
  JAX ``Trainer`` over 3 iterations with JAX's window starts (and
  propagation normals) injected: trace and leaves at rtol 1e-9.
- Starts stay on the real prefix of masked data; a window as long as the
  data is full batch.
- ``FFVDModel`` and the CLI train with windows on the CPU.
"""

import numpy as np
import pytest
import torch

from ffvd_tpu_torch.api import FFVDModel
from ffvd_tpu_torch.cli import main as cli_main
from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import generate_kink
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.elbo import negative_elbo
from ffvd_tpu_torch.model.params import (SSMData, init_params_random,
                                         params_from_numpy)
from tests.test_torch_deep import assert_trainer_matches
from tests.test_torch_minibatch import W, kink_model

torch.set_num_threads(2)


@pytest.mark.parametrize("kw,deep", [
    (dict(case=4), False), (dict(case=5, window_size=2), False),
    (dict(case=5), True)],
    ids=["C4", "C5", "C5-deep"])
def test_windowed_trainer_matches_jax(kw, deep):
    leaves, y, control = kink_model(n_hidden=int(deep))
    kw = dict(dataset="kink", num_inducing=8, x_dim=2, minibatch_size=W,
              n_layers=1 + int(deep), **kw)
    tr, _ = assert_trainer_matches(kw, leaves, y, control)
    assert tr.window_n == W and tr.stochastic == deep
    assert tr.start_hi == y.shape[0] - W + 1


def test_full_length_window_is_full_batch():
    leaves, y, control = kink_model()
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control))
    for mb in (48, 1000, None):
        tr = Trainer(FFVDConfig(case=4, num_inducing=8, x_dim=2,
                                minibatch_size=mb), data)
        assert tr.window_n is None
        state = tr.init_state(params_from_numpy(leaves))
        assert tr.grad_draws(22, None, state.params.x) == {}
        nll = tr.outer_step(state)            # draws nothing
        assert float(nll) == float(negative_elbo(params_from_numpy(leaves),
                                                 data))


def test_window_starts_stay_on_the_real_prefix():
    leaves, y, control = kink_model()
    mask = torch.ones(48, dtype=torch.float64)
    mask[30:] = 0.0
    data = SSMData(y=torch.as_tensor(y), control=torch.as_tensor(control),
                   mask=mask)
    tr = Trainer(FFVDConfig(case=4, num_inducing=8, x_dim=2,
                            minibatch_size=W), data)
    assert tr.start_hi == 30 - W + 1
    x = params_from_numpy(leaves).x
    starts = tr.grad_draws(500, torch.Generator().manual_seed(0),
                           x)["starts"]
    assert int(starts.min()) == 0 and int(starts.max()) == 30 - W
    assert starts.dtype == torch.int64 and starts.device == x.device


def test_windowed_model_lowers_the_full_objective():
    """FFVDModel on kink data from a cold start, W=16 of N=60: the full
    objective falls, every window is random, evaluation is full batch."""
    ds = generate_kink(n=60, seed=1)
    p = init_params_random(60, 2, 8, 0,
                           generator=torch.Generator().manual_seed(1))
    m = FFVDModel(FFVDConfig("kink", case=4, minibatch_size=16,
                             num_inducing=8, x_dim=2,
                             num_posterior_samples=3),
                  device="cpu", dataset=ds, params=p)
    full = lambda: float(negative_elbo(m.params, m.data).detach())
    before = full()
    m.fit(60)
    after = full()
    assert after < before - 0.1
    assert torch.isfinite(m.nll_trace).all()
    res = m.evaluate()
    assert np.isfinite(res["rmse"]) and res["predict_y"].shape == (60, 1)


def test_cli_runs_windowed(tmp_path):
    out = cli_main(["--file_index", "5", "--case_val", "4",
                    "--minibatch_size", "100", "--x_dims", "2",
                    "--iterations", "2", "--samples", "2",
                    "--platform", "cpu", "--results_dir", str(tmp_path)])
    assert np.isfinite(out["rmse"]) and np.isfinite(out["final_elbo"])
    (path,) = tmp_path.glob("ballbeam/*.npz")
    with np.load(path, allow_pickle=True) as z:
        assert z["X_val"].shape == (500, 2)
