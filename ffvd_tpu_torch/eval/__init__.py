from ffvd_tpu_torch.eval.ensemble import (chain_moments, ensemble_evaluate,
                                          fit_ensemble, multichain_moments,
                                          pool_moments)
from ffvd_tpu_torch.eval.results import save_results_npz
from ffvd_tpu_torch.eval.rollout import (collect_posterior, predict_summary,
                                         rmse_nll)

__all__ = ["collect_posterior", "predict_summary", "rmse_nll",
           "save_results_npz", "chain_moments", "ensemble_evaluate",
           "fit_ensemble", "multichain_moments", "pool_moments"]
