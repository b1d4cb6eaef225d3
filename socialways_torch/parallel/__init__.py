"""Data parallelism and agents-axis sharding on ``torch.distributed``
(counterpart of socialways_tpu/parallel/)."""

from socialways_torch.parallel.agents import (make_sharded_social_context,
                                              ring_social_context,
                                              sharded_social_context)
from socialways_torch.parallel.datafeed import (global_batch_from_local,
                                                host_chunk_feed,
                                                local_group_slice)
from socialways_torch.parallel.mesh import (DATA_AXIS, DCN_AXIS, Mesh,
                                            make_dp_epoch_fn,
                                            make_dp_epochs_fn,
                                            make_dp_eval_chunk,
                                            make_dp_train_step, make_mesh,
                                            make_mesh_2d, psum,
                                            shard_packed_for_mesh, spawn)

__all__ = ["DATA_AXIS", "DCN_AXIS", "Mesh", "make_dp_epoch_fn",
           "make_dp_epochs_fn", "make_dp_eval_chunk", "make_dp_train_step",
           "make_mesh", "make_mesh_2d", "psum", "shard_packed_for_mesh",
           "spawn", "make_sharded_social_context", "ring_social_context",
           "sharded_social_context", "global_batch_from_local",
           "host_chunk_feed", "local_group_slice"]
