"""Backbone protocol.

Counterpart of ``dyffusion_tpu/models/base.py``. A backbone is an
``nn.Module`` called as

    model(x, time=None, condition=None, generator=None) -> prediction

on NCHW tensors. ``generator=None`` is deterministic (dropout off); a live
``torch.Generator`` turns every dropout site on, which is how MC-dropout
ensembles and the stochastic interpolator are driven.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
from torch import nn


@dataclass(frozen=True)
class BackboneSpec:
    """Channel/shape metadata a backbone is built with."""

    num_input_channels: int
    num_output_channels: int
    num_conditional_channels: int = 0


def concat_condition(x: torch.Tensor, condition: Optional[torch.Tensor], num_conditional_channels: int) -> torch.Tensor:
    """Channel-concat the condition in front of x (NCHW: dim 1, condition first)."""
    if num_conditional_channels > 0:
        assert condition is not None, "model built with conditional channels but condition is None"
        return torch.cat([condition, x], dim=1)
    assert condition is None, "condition given but num_conditional_channels == 0"
    return x


def apply_model(
    module: nn.Module,
    params: Optional[Mapping[str, torch.Tensor]],
    x: torch.Tensor,
    time: Optional[torch.Tensor] = None,
    condition: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Call a backbone with its own weights, or with ``params`` substituted
    (the JAX package's ``apply_fn(params, ...)``; used for bf16 copies and
    EMA weights).

    Inputs and weights meet in their promoted dtype, as flax's layers
    promote them: bf16 inputs to an f32 network run in f32, and f32 inputs
    to bf16 weights run in f32 on the bf16-rounded weights (both happen in
    mixed-precision training). The time input is not cast: the time
    embedding runs in f32 either way."""
    if params:
        w_dtype = next(iter(params.values())).dtype
    else:
        w_dtype = next(module.parameters()).dtype
    dtype = w_dtype
    for a in (x, condition):
        if a is not None:
            dtype = torch.promote_types(dtype, a.dtype)
    x = x.to(dtype)
    condition = None if condition is None else condition.to(dtype)
    if dtype != w_dtype:
        source = params if params else dict(module.named_parameters())
        params = {k: v.to(dtype) if v.is_floating_point() else v for k, v in source.items()}
    if not params:
        return module(x, time, condition, generator)
    return torch.func.functional_call(module, dict(params), (x, time, condition, generator))
