"""Results checkpoint writer in the reference's key schema
(base_model.py:512-517); counterpart of ``ffvd_tpu/eval/results.py``."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ffvd_tpu_torch.model.params import GPSSMParams


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def save_results_npz(path, *, params: GPSSMParams, fit_y, predict_y,
                     predict_y_var, y_test, y_train, y_train_std: float,
                     case: str, ll_seq: Sequence[float] = (0.0,),
                     running_time_seq: Sequence[float] = (0.0,),
                     pg_num: Optional[int] = None,
                     mc_posterior_samples=()):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    p = params
    # Deep transitions (model/deep.py): the hidden layers have no reference
    # key, so they go under the JAX package's own prefix.
    hidden_kw = {}
    for i, layer in enumerate(p.hidden):
        hidden_kw[f"hidden{i}_U_val"] = _np(layer.u)
        hidden_kw[f"hidden{i}_Z_val"] = _np(layer.z)
        hidden_kw[f"hidden{i}_k_lengthscales"] = _np(
            layer.kernel.log_lengthscales)
        hidden_kw[f"hidden{i}_k_log_variances"] = _np(
            layer.kernel.log_variance)
    np.savez_compressed(
        path,
        **hidden_kw,
        y_train_vfe=_np(fit_y).reshape(-1),
        y_test_vfe=_np(predict_y).reshape(-1),
        v_test_vfe_var=_np(predict_y_var).reshape(-1),
        Y_test_data=np.asarray(y_test),
        Y_train_data=np.asarray(y_train),
        Y_train_std=y_train_std,
        CC_val=_np(p.c),
        DD_val=_np(p.d),
        log_R_cholesky=_np(p.log_rchol),
        log_QQ=_np(p.log_q),
        Z_val=_np(p.z),
        U_val=_np(p.u),
        X_val=_np(p.x[1:]),
        k_lengthscales=_np(p.kernel.log_lengthscales),
        k_log_variances=_np(p.kernel.log_variance),
        case=case,
        ll_seq=np.asarray(ll_seq),
        running_time_seq=np.asarray(running_time_seq),
        PG_num=pg_num if pg_num is not None else 0,
        mc_posterior_samples=np.asarray(mc_posterior_samples, dtype=object)
        if len(mc_posterior_samples) else np.zeros(0),
    )
    return path
