from ffvd_tpu_torch.eval.results import save_results_npz
from ffvd_tpu_torch.eval.rollout import (collect_posterior, predict_summary,
                                         rmse_nll)

__all__ = ["collect_posterior", "predict_summary", "rmse_nll",
           "save_results_npz"]
