"""Loss functions (counterpart of ``dyffusion_tpu/utils/loss.py``).

Each loss takes an optional ``mask`` of shape (B,) over the leading (batch)
axis: masked rows contribute nothing and the mean runs over the unmasked
rows only, a static-shape form of ``criterion(pred[rows], target[rows])``.
Reductions run in f32 at least (f64 for f64 inputs), so bf16 predictions
under mixed-precision training keep their gradient signal. In a data-parallel train step
(``utils.rng.row_shard``) a masked mean counts the unmasked rows of the
GLOBAL batch, so that the mean of the ranks' losses is the global batch's.
Under spatial sharding (a D x K grid) a rank's mean runs over its slab of
its data index's rows, and the count is the same: the sum over the world
counts each row once on each of the K ranks of its model group, and the
world is D x K, so the quotient is the global batch's count over D, as
``parallel.distributed`` sets out for the whole gradient.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from dyffusion_tpu_torch.parallel import distributed
from dyffusion_tpu_torch.utils import rng

LossFn = Callable[..., torch.Tensor]


def _masked_mean(per_elem: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``per_elem``; with ``mask`` (B,), the per-row means averaged
    over the rows where the mask is nonzero (equal to
    ``per_elem[mask].mean()``: every row has the same number of elements)."""
    if mask is None:
        return per_elem.mean()
    mask = mask.to(per_elem.dtype)
    row_mean = per_elem.reshape(per_elem.shape[0], -1).mean(dim=-1)
    if rng.row_sharded():  # this rank's share of the global masked mean
        count = distributed.all_reduce_sum(mask.sum().detach().to(distributed.collective_device()))
        count = count.to(mask.device) / distributed.world_size()
        return (row_mean * mask).sum() / torch.clamp(count, min=1.0 / distributed.world_size())
    return (row_mean * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 at least (an f64 tensor stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32)) if x.is_floating_point() else x


def mse_loss(preds: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean((_f32(preds) - _f32(targets)) ** 2, mask)


def l1_loss(preds: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean((_f32(preds) - _f32(targets)).abs(), mask)


def smooth_l1_loss(
    preds: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None, beta: float = 1.0
) -> torch.Tensor:
    d = (_f32(preds) - _f32(targets)).abs()
    return _masked_mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta), mask)


_LOSSES = {
    "mse": mse_loss,
    "l2": mse_loss,
    "mean_squared_error": mse_loss,
    "l1": l1_loss,
    "mae": l1_loss,
    "mean_absolute_error": l1_loss,
    "smooth_l1": smooth_l1_loss,
    "huber": smooth_l1_loss,
}


def get_loss_fn(name: str) -> LossFn:
    key = name.lower().strip()
    if key not in _LOSSES:
        raise ValueError(f"Unknown loss function '{name}'. Available: {sorted(_LOSSES)}")
    return _LOSSES[key]
