"""Batched training axes on one device (chains in ``sharding``, stacked
datasets in ``multidataset``) and their split over processes, one a device
(``distributed``): chains or datasets over 'dp', each model's latent dims
over 'ep', the time axis over 'sp' (``sequence``)."""

from ffvd_tpu_torch.parallel.distributed import (initialize_multihost,
                                                 multihost_mesh, spawn_local)
from ffvd_tpu_torch.parallel.multidataset import (MultiDatasetTrainer,
                                                  pad_dataset, stack_datasets)
from ffvd_tpu_torch.parallel.sequence import (SequenceShardedTrainer,
                                              make_seq_mesh, shard_sequence)
from ffvd_tpu_torch.parallel.sharding import (BatchedTrainer,
                                              MultiChainTrainer,
                                              gather_chain_state, make_mesh,
                                              mesh_shape, params_pspec,
                                              shard_chain_state, state_pspec,
                                              stack_warmstarts)

__all__ = ["BatchedTrainer", "MultiChainTrainer", "MultiDatasetTrainer",
           "SequenceShardedTrainer", "gather_chain_state",
           "initialize_multihost", "make_mesh", "make_seq_mesh", "mesh_shape",
           "multihost_mesh", "pad_dataset", "params_pspec",
           "shard_chain_state", "shard_sequence", "spawn_local",
           "stack_datasets", "stack_warmstarts", "state_pspec"]
