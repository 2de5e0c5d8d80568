"""Data parallelism and spatial sharding over ``torch.distributed``
(counterpart of ``dyffusion_tpu/parallel``): the process group, its D x K
grid and its collectives (:mod:`.distributed`), the layout of batches and
the replicated train state (:mod:`.mesh`), the sharded network's halos,
norms and attention (:mod:`.spatial`)."""
from dyffusion_tpu_torch.parallel.distributed import (  # noqa: F401
    active,
    all_reduce_gradients,
    barrier,
    effective_batch_size,
    init_distributed,
    rank,
    world_size,
)
from dyffusion_tpu_torch.parallel.mesh import (  # noqa: F401
    process_local_box,
    process_local_rows,
    replicate_state,
    shard_batch,
)
