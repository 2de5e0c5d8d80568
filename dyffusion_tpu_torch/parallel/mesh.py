"""The data-parallel layout: the counterpart of the JAX package's 1-D
``'data'`` mesh (``dyffusion_tpu/parallel/mesh.py``) over the ranks of a
``torch.distributed`` process group.

Every rank builds the same GLOBAL host batch from the same seed (the
``DistributedSampler`` seed contract of the JAX package's
``process_local_box``) and keeps the contiguous rows
:func:`process_local_rows` gives it; the train state is the same on every
rank (:func:`replicate_state`), and the gradients are averaged across ranks
after each backward (``distributed.all_reduce_gradients``). Spatial sharding
(the JAX mesh's ``'model'`` axis) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dyffusion_tpu_torch.parallel import distributed


def process_local_rows(global_batch: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a ``global_batch``-row batch split into
    ``world`` equal contiguous blocks."""
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} rows does not split over {world} ranks")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Dict[str, Any], device: torch.device | str, rank: int = None, world: int = None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a GLOBAL host batch, as tensors on ``device``."""
    rank = distributed.rank() if rank is None else rank
    world = distributed.world_size() if world is None else world
    rows = process_local_rows(int(next(iter(batch.values())).shape[0]), rank, world)
    return {k: torch.as_tensor(np.asarray(v)[rows]).to(device) for k, v in batch.items()}


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@torch.no_grad()
def replicate_state(state) -> None:
    """Make every rank's train state rank 0's: the model's parameters and
    buffers, the EMA and the optimizer's state tensors, broadcast in place
    (the counterpart of ``shard_train_state``'s replication). The step
    generators stay each rank's own."""
    if not distributed.active():
        return
    tensors = list(state.model.state_dict().values())
    if state.ema is not None:
        tensors += list(state.ema.values())
    tensors += list(_tensors(state.optimizer.optimizer.state))
    for t in tensors:
        if distributed.backend() == "nccl" and t.device.type != "cuda":
            moved = t.to(distributed.collective_device())
            distributed.broadcast_(moved)
            t.copy_(moved)
        else:
            distributed.broadcast_(t)
