from ffvd_tpu_torch.model.elbo import elbo_terms, negative_elbo
from ffvd_tpu_torch.model.params import (GPSSMParams, SSMData,
                                         init_params_from_warmstart)

__all__ = ["GPSSMParams", "SSMData", "init_params_from_warmstart",
           "negative_elbo", "elbo_terms"]
