"""Data parallelism over ``torch.distributed`` (counterpart of
``dyffusion_tpu/parallel``): the process group and its collectives
(:mod:`.distributed`), the row layout of batches and the replicated train
state (:mod:`.mesh`)."""
from dyffusion_tpu_torch.parallel.distributed import (  # noqa: F401
    active,
    all_reduce_gradients,
    barrier,
    effective_batch_size,
    init_distributed,
    rank,
    world_size,
)
from dyffusion_tpu_torch.parallel.mesh import process_local_rows, replicate_state, shard_batch  # noqa: F401
