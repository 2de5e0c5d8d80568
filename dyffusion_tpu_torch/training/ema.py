"""Exponential moving average of the weights (counterpart of
``dyffusion_tpu/training/ema.py``, the original reference's ``LitEma``).

The shadow is a dict of tensors beside the model, updated per step with the
warmup decay ``min(decay, (1 + n) / (10 + n))``; evaluating with the EMA is
passing the shadow as the weights. Unlike the JAX package's pure functions,
:func:`ema_update` updates the shadow in place (no second copy of the
weights per step).
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch


def init_ema(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A detached copy of the weights."""
    return {k: v.detach().clone() for k, v in params.items()}


def ema_decay(num_updates: int, decay: float = 0.9999):
    """(decay of the next update, update count after it), in f32 as the JAX
    package computes them; ``num_updates`` is the count BEFORE the update."""
    n = num_updates + 1
    return np.minimum(np.float32(decay), np.float32(1.0 + n) / np.float32(10.0 + n)), n


@torch.no_grad()
def ema_update(
    ema: Dict[str, torch.Tensor],
    params: Iterable[torch.Tensor],
    num_updates: int,
    decay: float = 0.9999,
) -> int:
    """One EMA step in place: e <- e - (1 - d) * (e - p), ``params`` in the
    order of ``ema``. Returns the new update count."""
    d, n = ema_decay(num_updates, decay)
    one_minus = float(np.float32(1.0) - d)
    shadow = list(ema.values())
    diff = torch._foreach_sub(shadow, [p.detach().to(e.dtype) for e, p in zip(shadow, params)])
    torch._foreach_mul_(diff, one_minus)
    torch._foreach_sub_(shadow, diff)
    return n
