from ffvd_tpu_torch.ops.chol import (chol_logdet, chol_solve, psd_cholesky,
                                     tri_solve)
from ffvd_tpu_torch.ops.densities import (logdensity_norm,
                                          logdensity_norm_diag,
                                          logdensity_norm_diag_nonvec)
from ffvd_tpu_torch.ops.kernels import (KernelParams, cross, diag, gram,
                                        linear_cross, linear_diag,
                                        linear_gram, se_cross, se_diag,
                                        se_gram)

__all__ = [
    "KernelParams", "se_gram", "se_cross", "se_diag",
    "linear_gram", "linear_cross", "linear_diag", "gram", "cross", "diag",
    "logdensity_norm_diag", "logdensity_norm_diag_nonvec", "logdensity_norm",
    "psd_cholesky", "tri_solve", "chol_logdet", "chol_solve",
]
