"""The batch layout: the counterpart of the JAX package's ``('data',
'model')`` mesh (``dyffusion_tpu/parallel/mesh.py``) over the ranks of a
``torch.distributed`` process group.

Every rank builds the same GLOBAL host batch from the same seed (the
``DistributedSampler`` seed contract of the JAX package's
``process_local_box``) and keeps the contiguous rows
:func:`process_local_rows` gives it; the train state is the same on every
rank (:func:`replicate_state`), and the gradients are averaged across ranks
after each backward (``distributed.all_reduce_gradients``).

Under spatial sharding (``distributed.set_model_axis``: a D x K grid of
ranks) a rank takes the rows of its data index and, of every value of rank
>= 4 in the host's channels-last layout ((B, H, W, C), (B, T, H, W, C)),
its model index's slab of H (axis ndim-3) or W (axis ndim-2), as the JAX
package's ``value_sharding`` places them; values of lower rank keep every
column (:func:`process_local_box`). The grid's extent must divide by K.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


def slab_axis(ndim: int, axis: str) -> Optional[int]:
    """The axis of a host value of rank ``ndim`` that ``axis`` ('h' or
    'w') shards: ndim-3 or ndim-2 for a grid value (ndim >= 4), None for
    the rest."""
    if axis not in ("h", "w"):
        raise ValueError(f"spatial axis must be 'h' or 'w', got {axis!r}")
    if ndim < 4:
        return None
    return ndim - 3 if axis == "h" else ndim - 2


def process_local_box(
    shape, rows: slice, axis: str = "h", model_rank: int = 0, model_size: int = 1
) -> Tuple[slice, ...]:
    """The box of a global host value of ``shape`` that a rank holds:
    ``rows`` of axis 0 and, for a grid value under ``model_size`` > 1,
    block ``model_rank`` of its H or W axis (``axis``) split into
    ``model_size`` equal blocks; the other axes whole."""
    box = [rows] + [slice(None)] * (len(shape) - 1)
    pos = slab_axis(len(shape), axis)
    if model_size > 1 and pos is not None:
        extent = int(shape[pos])
        if extent % model_size:
            raise ValueError(f"a grid axis of {extent} does not split over {model_size} ranks")
        per = extent // model_size
        box[pos] = slice(model_rank * per, (model_rank + 1) * per)
    return tuple(box)


def local_batch(batch: Dict[str, Any], rows: slice, axis: str = "h", model_rank: int = 0,
                model_size: int = 1) -> Dict[str, np.ndarray]:
    """Each value's :func:`process_local_box` of a GLOBAL host batch."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = v[process_local_box(v.shape, rows, axis, model_rank, model_size)]
    return out


def shard_batch(batch: Dict[str, Any], device: torch.device | str, rank: int = None, world: int = None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a GLOBAL host batch (those of its data index), as
    tensors on ``device``."""
    rank = distributed.data_rank() if rank is None else rank
    world = distributed.data_size() if world is None else world
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
