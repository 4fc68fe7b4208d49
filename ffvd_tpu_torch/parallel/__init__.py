"""Batched training axes on one device: chains (``sharding``) and stacked
datasets (``multidataset``)."""

from ffvd_tpu_torch.parallel.multidataset import (MultiDatasetTrainer,
                                                  pad_dataset, stack_datasets)
from ffvd_tpu_torch.parallel.sharding import (BatchedTrainer,
                                              MultiChainTrainer,
                                              stack_warmstarts)

__all__ = ["BatchedTrainer", "MultiChainTrainer", "MultiDatasetTrainer",
           "pad_dataset", "stack_datasets", "stack_warmstarts"]
