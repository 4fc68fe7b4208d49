"""High-level model API — counterpart of ``ffvd_tpu/api.py`` (the rebuild of
the reference's ``vfegpssm/models.py``).

``FFVDModel``: config → data → warm start → trainer → posterior predictions.
It runs on ``cuda`` unless the caller passes ``device="cpu"``, in fp32 on
the card and fp64 on the CPU unless ``dtype`` says otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ffvd_tpu_torch.config import FFVDConfig
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.eval.results import save_results_npz
from ffvd_tpu_torch.eval.rollout import (collect_posterior, predict_summary,
                                         rmse_nll)
from ffvd_tpu_torch.inference.trainer import Trainer
from ffvd_tpu_torch.model.likelihoods import emission_mean
from ffvd_tpu_torch.model.params import (GPSSMParams, SSMData,
                                         init_params_from_warmstart)
from ffvd_tpu_torch.utils.device import default_dtype, resolve_device


class FFVDModel:
    """Config → data → warm start → trainer → posterior predictions."""

    def __init__(self, cfg: FFVDConfig, device=None, dtype=None, dataset=None,
                 params: Optional[GPSSMParams] = None):
        """``dataset``/``params`` may be injected; by default the named
        dataset and its Factnonlin warm start load."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        if cfg.n_layers > 1:
            raise NotImplementedError(
                "deep transitions are not ported yet (ROADMAP Queue 1, "
                "item 8: model/deep.py)")
        if cfg.collapse_precision != "native":
            raise NotImplementedError(
                "collapse_precision='ds64'/'hybrid' is not ported yet "
                "(ROADMAP Queue 1, item 9)")
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
            raise NotImplementedError(
                f"x_dim={cfg.x_dim} differs from the warm start's "
                f"{params.x_dim}; adapt_warmstart_xdim is not ported yet "
                "(ROADMAP Queue 1, item 8)")
        if cfg.num_inducing != params.z.shape[0]:
            raise NotImplementedError(
                f"num_inducing={cfg.num_inducing} differs from the warm "
                f"start's {params.z.shape[0]}; resizing the inducing set is "
                "not ported yet (ROADMAP Queue 1, item 11: "
                "parallel/multidataset.py::_resize_inducing)")
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        self.data = SSMData(y=as_t(self.dataset.y_train),
                            control=as_t(self.dataset.control))
        self.trainer = Trainer(cfg, self.data)
        self.state = self.trainer.init_state(params)
        # Host generator: rollout noise seeds are drawn from it.
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.nll_trace = torch.zeros((0,), dtype=self.dtype,
                                     device=self.device)
        self.rmse_seq = []

    @property
    def params(self) -> GPSSMParams:
        return self.state.params

    def fit(self, num_iterations: Optional[int] = None,
            chunk_size: int = 500,
            eval_every: Optional[int] = None,
            eval_samples: int = 3,
            tensorboard_dir: Optional[str] = None) -> "FFVDModel":
        """Train; with ``eval_every`` also record (iteration, RMSE, NLL)
        into ``self.rmse_seq``."""
        if tensorboard_dir is not None:
            raise NotImplementedError(
                "TensorBoard summaries are not ported yet (ROADMAP Queue 1, "
                "item 10: utils/metrics.py)")
        n = num_iterations or self.cfg.total_iterations
        done = 0
        step = min(chunk_size, eval_every or n)
        while done < n:
            m = min(step, n - done)
            self.state, nlls = self.trainer.run(self.state, m,
                                                chunk_size=chunk_size)
            self.nll_trace = torch.cat([self.nll_trace, nlls])
            done += m
            if eval_every and (done % eval_every == 0 or done == n):
                res = self.evaluate_quick(eval_samples)
                self.rmse_seq.append((self.state.step, res["rmse"],
                                      res["nll"]))
        return self

    def _y_test(self, test_len: Optional[int] = None) -> torch.Tensor:
        return torch.as_tensor(self.dataset.y_test[:test_len],
                               dtype=self.dtype, device=self.device)

    @torch.no_grad()
    def evaluate_quick(self, num_samples: int = 3, horizon: int = 30,
                       noise: Optional[torch.Tensor] = None) -> dict:
        """Cheap mid-training eval (fewer posterior samples)."""
        test_len = min(self.dataset.n_test, max(horizon, 30))
        xs, vs = collect_posterior(self.trainer, self.params, test_len,
                                   num=num_samples, generator=self.generator,
                                   noise=noise)
        py, pv, _ = predict_summary(self.params, xs, vs,
                                    self.cfg.emission_noise)
        rmse, nll = rmse_nll(self._y_test(test_len), py, pv,
                             self.dataset.y_train_std, horizon=horizon)
        return {"rmse": float(rmse), "nll": float(nll)}

    @torch.no_grad()
    def predict(self, test_len: Optional[int] = None,
                num_samples: Optional[int] = None, spread: bool = False,
                noise: Optional[torch.Tensor] = None):
        """Posterior-mean free-run prediction: (ŷ (T,P), v̂ (T,P)).

        ``spread=True`` adds the across-rollout variance of the per-sample
        predictive means to v̂ (the mixture total-variance term the
        reference's estimator drops, base_model.py:334-343).  ``noise``
        (S, T, D) replaces the rollout's drawn noise."""
        test_len = test_len or self.dataset.n_test
        xs, vs = collect_posterior(self.trainer, self.params, test_len,
                                   num=num_samples, generator=self.generator,
                                   noise=noise)
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
                 noise: Optional[torch.Tensor] = None) -> dict:
        """Train-free-run eval: RMSE/NLL on the first ``horizon`` test steps
        (base_model.py:345-349, :629).  See predict() for ``spread`` and
        ``noise``."""
        py, pv = self.predict(num_samples=num_samples, spread=spread,
                              noise=noise)
        rmse, nll = rmse_nll(self._y_test(), py, pv,
                             self.dataset.y_train_std, horizon=horizon)
        return {"rmse": float(rmse), "nll": float(nll),
                "predict_y": py.cpu().numpy(),
                "predict_y_var": pv.cpu().numpy()}

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
