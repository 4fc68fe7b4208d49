"""High-level model API — counterpart of ``ffvd_tpu/api.py`` (the rebuild of
the reference's ``vfegpssm/models.py``).

``FFVDModel``: config → data → warm start → trainer → posterior predictions.
It runs on ``cuda`` unless the caller passes ``device="cpu"``, in fp32 on
the card and fp64 on the CPU unless ``dtype`` says otherwise.  Under
``collapse_precision="hybrid"`` a collapsed case trains native and runs the
last ``hybrid_tail_iters`` of each ``fit`` call, and every posterior
collection, on a second trainer with the float64 collapsed segment.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ffvd_tpu_torch.config import DATASETS, DEEP_UNDERFIT_DATASETS, FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.eval.results import save_results_npz
from ffvd_tpu_torch.eval.rollout import (collect_posterior, predict_summary,
                                         rmse_nll)
from ffvd_tpu_torch.inference.particle_gibbs import make_pg_fn
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.likelihoods import emission_mean, use_full_r
from ffvd_tpu_torch.model.params import (GPSSMParams, SSMData,
                                         adapt_warmstart_xdim,
                                         init_hidden_layers,
                                         init_params_from_warmstart)
from ffvd_tpu_torch.utils.device import default_dtype, resolve_device


def _warn_deep_usage(cfg: FFVDConfig) -> None:
    """Warn when ``n_layers > 1`` is asked for on a stock dataset where the
    JAX package's seeded study measured no win for deep transitions
    (PARITY §2b-deep: flutter and drive gain; actuator degrades 2-5x).  The
    same message as ``ffvd_tpu/api.py::_warn_deep_usage``."""
    if cfg.n_layers <= 1 or cfg.dataset not in DATASETS:
        return
    if cfg.dataset in DEEP_UNDERFIT_DATASETS:
        return
    detail = (
        "the measured regression is 2-5x (deep-2 RMSE 0.50-0.66 vs shallow "
        "0.13-0.27 over 3 seeds); a smaller deep_hidden_init_scale "
        "(e.g. 0.0625) recovers about half of it, but shallow remains best"
        if cfg.dataset == "actuator" else
        "deep-2 measured parity-to-slightly-worse within seed spread there")
    warnings.warn(
        f"n_layers={cfg.n_layers} on '{cfg.dataset}': the shallow model "
        f"already fits this dataset well and {detail}.  Deep transitions "
        "pay only where shallow underfits (measured: flutter, drive) — "
        "see PARITY.md §2b-deep / tests/golden/deep_study.json.",
        UserWarning, stacklevel=3)


class FFVDModel:
    """Config → data → warm start → trainer → posterior predictions."""

    def __init__(self, cfg: FFVDConfig, device=None, dtype=None, dataset=None,
                 params: Optional[GPSSMParams] = None,
                 capture: Optional[bool] = None):
        """``capture``: train, thin and run a LinearK or deep rollout by
        replaying CUDA graphs (``Trainer.run``, ``collect_posterior``); None
        captures on the card, False runs eagerly.
        ``dataset``/``params`` may be injected (e.g. synthetic data from
        ``data.synthetic`` and a cold start from ``init_params_random``); by
        default the named dataset and its Factnonlin warm start load.  A
        shallow start is adapted to ``cfg.x_dim``, its inducing set resized
        to ``cfg.num_inducing``, then, for
        ``cfg.n_layers > 1``, given near-identity hidden layers drawn from
        the host generator."""
        self.cfg = cfg
        self.capture = capture
        _warn_deep_usage(cfg)
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.dataset = (dataset if dataset is not None
                        else create_dataset(cfg.dataset))
        if params is None:
            params = init_params_from_warmstart(
                load_warmstart(cfg.dataset, cfg.file_id), device=self.device,
                dtype=self.dtype)
        else:
            params = GPSSMParams.from_leaves({
                k: v.detach().to(self.device, self.dtype)
                for k, v in params.leaves().items()})
        if cfg.x_dim != params.x_dim:
            params = adapt_warmstart_xdim(
                params, cfg.x_dim,
                control_dim=self.dataset.control.shape[1], seed=cfg.seed)
        if cfg.num_inducing != params.z.shape[0]:
            from ffvd_tpu_torch.parallel.multidataset import _resize_inducing
            params = _resize_inducing(params, cfg.num_inducing, cfg.seed)
        # Host generator: rollout noise seeds (and the hidden layers' start)
        # are drawn from it.  Training generator, on the device: SG-HMC
        # noise, window feeds and starts, inter-layer normals, the PG
        # sweep's draws, thinning and the emission noise of sample().
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.train_generator = torch.Generator(
            device=self.device).manual_seed(cfg.seed)
        if cfg.n_layers > 1 and not params.hidden:
            params = dataclasses.replace(params, hidden=init_hidden_layers(
                cfg.n_layers - 1, params, cfg.deep_hidden_init_scale,
                self.generator))
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        self.data = SSMData(y=as_t(self.dataset.y_train),
                            control=as_t(self.dataset.control))
        pg_fn = make_pg_fn(cfg) if cfg.case_config.x_pg else None
        self.trainer = Trainer(cfg, self.data, pg_fn=pg_fn)
        self.state = self.trainer.init_state(params)
        self.nll_trace = torch.zeros((0,), dtype=self.dtype,
                                     device=self.device)
        self.rmse_seq = []

    @property
    def params(self) -> GPSSMParams:
        return self.state.params

    @property
    def hybrid(self) -> bool:
        """collapse_precision="hybrid" on a collapsed case (C4/C5): native
        burn-in, then a float64-segment tail (the fp32 gradient bias is a
        near-optimum effect, DESIGN §12).  Only a collapsed case has the
        segment."""
        return (self.cfg.collapse_precision == "hybrid"
                and self.cfg.case_config.u_collapse)

    def _tail_trainer(self) -> Trainer:
        """The ds64 Trainer of the hybrid tail, built once.  It shares the
        ``TrainState``: the labels are the same and the state's Adam is
        bound to the same leaves, so Adam's moments carry across."""
        if getattr(self, "_ds64_trainer", None) is None:
            self._ds64_trainer = Trainer(
                dataclasses.replace(self.cfg, collapse_precision="ds64"),
                self.data, pg_fn=self.trainer.pg_fn)
        return self._ds64_trainer

    @property
    def eval_trainer(self) -> Trainer:
        """The trainer of posterior collection: the ds64 one under the
        hybrid schedule, since thinning runs at the sharply trained
        post-tail point where the fp32 gradient is biased."""
        return self._tail_trainer() if self.hybrid else self.trainer

    def fit(self, num_iterations: Optional[int] = None,
            chunk_size: int = 500,
            eval_every: Optional[int] = None,
            eval_samples: int = 3,
            tensorboard_dir: Optional[str] = None) -> "FFVDModel":
        """Train; with ``eval_every`` also record (iteration, RMSE, NLL)
        into ``self.rmse_seq``.  ``tensorboard_dir``: write the reference's
        gated-off summary set (models.py:94-131) after every chunk
        (``utils.metrics.TensorBoardSink``).

        Under the hybrid schedule the last ``cfg.hybrid_tail_iters``
        iterations OF THIS CALL run the ds64 bound, and no chunk crosses
        that boundary (per-call semantics, as ``ffvd_tpu/api.py::fit``)."""
        n = num_iterations or self.cfg.total_iterations
        tb = None
        if tensorboard_dir is not None:
            from ffvd_tpu_torch.utils.metrics import TensorBoardSink
            tb = TensorBoardSink(tensorboard_dir)
        tail = min(self.cfg.hybrid_tail_iters, n) if self.hybrid else 0
        done = 0
        step = min(chunk_size, eval_every or n)
        while done < n:
            m = min(step, n - done)
            trainer = self.trainer
            if done < n - tail:
                m = min(m, n - tail - done)   # don't cross the boundary
            elif tail:
                trainer = self._tail_trainer()
            self.state, nlls = trainer.run(
                self.state, m, chunk_size=chunk_size,
                generator=self.train_generator, capture=self.capture)
            self.nll_trace = torch.cat([self.nll_trace, nlls])
            done += m
            if tb is not None:
                tb.write(self.state.params, float(nlls[-1]), self.state.step)
            if eval_every and (done % eval_every == 0 or done == n):
                res = self.evaluate_quick(eval_samples)
                self.rmse_seq.append((self.state.step, res["rmse"],
                                      res["nll"]))
        if tb is not None:
            tb.close()
        return self

    def _y_test(self, test_len: Optional[int] = None) -> torch.Tensor:
        return torch.as_tensor(self.dataset.y_test[:test_len],
                               dtype=self.dtype, device=self.device)

    def _collect(self, test_len: int, num_samples: Optional[int] = None,
                 noise: Optional[torch.Tensor] = None, thin_noise=None):
        """Posterior rollouts through ``eval_trainer``; the thinned SG-HMC
        chain is kept."""
        xs, vs, self.state = collect_posterior(
            self.eval_trainer, self.state, test_len, num=num_samples,
            generator=self.generator, noise=noise, thin_noise=thin_noise,
            thin_generator=self.train_generator, capture=self.capture)
        return xs, vs

    @torch.no_grad()
    def evaluate_quick(self, num_samples: int = 3, horizon: int = 30,
                       noise: Optional[torch.Tensor] = None) -> dict:
        """Cheap mid-training eval (fewer posterior samples)."""
        test_len = min(self.dataset.n_test, max(horizon, 30))
        xs, vs = self._collect(test_len, num_samples, noise)
        py, pv, _ = predict_summary(self.params, xs, vs,
                                    self.cfg.emission_noise)
        rmse, nll = rmse_nll(self._y_test(test_len), py, pv,
                             self.dataset.y_train_std, horizon=horizon)
        return {"rmse": float(rmse), "nll": float(nll)}

    @torch.no_grad()
    def evaluate_per_sample(self, horizon: int = 30):
        """Per-posterior-sample RMSE/NLL lists (the reference's
        collect_samples_2023 output, base_model.py:619-635)."""
        xs, vs = self._collect(self.dataset.n_test)
        y_test = self._y_test()
        rmses, nlls = [], []
        for s in range(xs.shape[0]):
            py, pv, _ = predict_summary(self.params, xs[s:s + 1],
                                        vs[s:s + 1], self.cfg.emission_noise)
            r, n = rmse_nll(y_test, py, pv, self.dataset.y_train_std,
                            horizon=horizon)
            rmses.append(float(r))
            nlls.append(float(n))
        return rmses, nlls

    @torch.no_grad()
    def predict(self, test_len: Optional[int] = None,
                num_samples: Optional[int] = None, spread: bool = False,
                noise: Optional[torch.Tensor] = None, thin_noise=None):
        """Posterior-mean free-run prediction: (ŷ (T,P), v̂ (T,P)).

        ``spread=True`` adds the across-rollout variance of the per-sample
        predictive means to v̂ (the mixture total-variance term the
        reference's estimator drops, base_model.py:334-343).  ``noise``
        (S, T, D) replaces the rollout's drawn noise, ``thin_noise`` (path →
        (S, spacing, ...)) the SG-HMC thinning's."""
        test_len = test_len or self.dataset.n_test
        xs, vs = self._collect(test_len, num_samples, noise, thin_noise)
        self._last_rollout = (xs, vs)
        py, pv, fy = predict_summary(self.params, xs, vs,
                                     self.cfg.emission_noise)
        self._last_fit_y = fy
        if spread:
            ys = xs @ self.params.c + self.params.d      # (S, T, P)
            pv = pv + torch.var(ys, dim=0, unbiased=False)
        return py, pv

    @torch.no_grad()
    def evaluate(self, horizon: int = 30, num_samples: Optional[int] = None,
                 spread: bool = False,
                 noise: Optional[torch.Tensor] = None,
                 thin_noise=None) -> dict:
        """Train-free-run eval: RMSE/NLL on the first ``horizon`` test steps
        (base_model.py:345-349, :629).  See predict() for ``spread``,
        ``noise`` and ``thin_noise``."""
        py, pv = self.predict(num_samples=num_samples, spread=spread,
                              noise=noise, thin_noise=thin_noise)
        rmse, nll = rmse_nll(self._y_test(), py, pv,
                             self.dataset.y_train_std, horizon=horizon)
        return {"rmse": float(rmse), "nll": float(nll),
                "predict_y": py.cpu().numpy(),
                "predict_y_var": pv.cpu().numpy()}

    @torch.no_grad()
    def calculate_density(self, y: np.ndarray, ystd: float = 1.0):
        """Log predictive density of held-out observations under the
        free-run predictive (working version of models.py:330-333)."""
        py, pv = self.predict(test_len=len(y))
        yv = torch.as_tensor(np.asarray(y), dtype=self.dtype,
                             device=self.device).reshape(py.shape) * ystd
        mu = py * ystd
        var = pv * (ystd ** 2)
        return (-0.5 * torch.log(2 * math.pi * var)
                - 0.5 * (yv - mu) ** 2 / var).cpu().numpy()

    @torch.no_grad()
    def sample(self, test_len: Optional[int] = None, s: int = 1):
        """Draw S free-run observation trajectories (working version of
        models.py:335-337); the emission noise comes from the training
        generator."""
        test_len = test_len or self.dataset.n_test
        xs, _ = self._collect(test_len, s)
        ys = xs @ self.params.c + self.params.d
        z = torch.randn(ys.shape, generator=self.train_generator,
                        device=self.device, dtype=ys.dtype)
        if use_full_r(self.cfg.emission_noise, self.params.c.shape[1]):
            noise = z @ self.params.rchol.T      # ε = z·Lᵀ, R = L·Lᵀ
        else:
            noise = z * self.params.rchol_diag
        return (ys + noise).cpu().numpy()

    @torch.no_grad()
    def save_results(self, path, case: Optional[str] = None,
                     predictions: Optional[tuple] = None):
        """Write the reference-schema results npz.  ``predictions``
        overrides (predict_y, predict_y_var); by default the rollout of the
        last predict/evaluate is reused, so the saved predictions are the
        ones that were reported."""
        if predictions is not None:
            py, pv = predictions
        elif hasattr(self, "_last_rollout"):
            py, pv, _ = predict_summary(self.params, *self._last_rollout,
                                        emission_noise=self.cfg.emission_noise)
        else:
            py, pv = self.predict()
        fit_y = getattr(self, "_last_fit_y", None)
        if fit_y is None:
            fit_y = emission_mean(self.params.x[1:], self.params.c,
                                  self.params.d)
        return save_results_npz(
            path, params=self.params, fit_y=fit_y,
            predict_y=py, predict_y_var=pv,
            y_test=self.dataset.y_test, y_train=self.dataset.y_train,
            y_train_std=self.dataset.y_train_std,
            case=case or self.cfg.case_config.name,
            ll_seq=(-self.nll_trace.cpu().numpy()).tolist() or [0.0],
            pg_num=self.cfg.pg_particles)


class RegressionModel(FFVDModel):
    """Reference-shaped constructor: ``RegressionModel(prior_type)``
    (models.py:315-317) + keyword configuration."""

    def __init__(self, prior_type: str = "normal", device=None, dtype=None,
                 **cfg_kw):
        super().__init__(FFVDConfig(prior_type=prior_type, **cfg_kw),
                         device=device, dtype=dtype)
