from ffvd_tpu_torch.data.loaders import DATASET_FILES, create_dataset
from ffvd_tpu_torch.data.synthetic import (generate_kink, generate_linear,
                                           kink_fn)
from ffvd_tpu_torch.data.warmstart import list_warmstarts, load_warmstart

__all__ = ["create_dataset", "DATASET_FILES", "load_warmstart",
           "list_warmstarts", "generate_kink", "generate_linear", "kink_fn"]
