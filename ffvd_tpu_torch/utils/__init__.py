"""Checkpoints, metrics, timing and profiling.  ``TensorBoardSink`` imports
its writer only when one is constructed."""

from ffvd_tpu_torch.utils.checkpoint import CheckpointManager
from ffvd_tpu_torch.utils.metrics import (MetricsLogger, TensorBoardSink,
                                          elbo_report)

__all__ = ["CheckpointManager", "MetricsLogger", "TensorBoardSink",
           "elbo_report"]
