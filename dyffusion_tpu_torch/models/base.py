"""Backbone protocol.

Counterpart of ``dyffusion_tpu/models/base.py``. A backbone is an
``nn.Module`` called as

    model(x, time=None, condition=None, generator=None) -> prediction

on NCHW tensors. ``generator=None`` is deterministic (dropout off); a live
``torch.Generator`` turns every dropout site on, which is how MC-dropout
ensembles and the stochastic interpolator are driven.

A backbone with BatchNorm (:class:`BatchNorm2d`) also takes
``batch_stats``: ``None`` normalizes with the running averages (every
inference call, MC-dropout included: dropout and BatchNorm have separate
switches, never ``module.train()``); a dict selects the batch statistics
and collects the updated running averages. :func:`apply_model` is the JAX
package's ``make_apply_fn``, :func:`apply_model_train` its
``make_train_apply_fn``: it returns the updates, which the train step
applies after its optimizer step (:func:`load_model_state_updates`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dyffusion_tpu_torch.parallel import distributed

# the loss functions' metrics key under which a train-mode loss hands its
# BatchNorm running-statistics updates to the train step (the JAX package's
# ``_model_state_updates`` aux key)
MODEL_STATE_UPDATES = "_model_state_updates"


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that also takes a rank's slab of no rows under spatial
    sharding (a level of fewer rows than ranks), which torch's conv
    refuses: its output slab of no rows is a view of the input, so that the
    rank's backward still reaches the collectives that made the input. Its
    parameters and state dict are ``nn.Conv2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2] and x.shape[-1]:
            return super().forward(x)
        size = [0 if n == 0 else (n + 2 * p - d * (k - 1) - 1) // s + 1 for n, p, d, k, s in
                zip(x.shape[-2:], self.padding, self.dilation, self.kernel_size, self.stride)]
        return x.reshape(x.shape[0], self.out_channels, *size)


@dataclass(frozen=True)
class BackboneSpec:
    """Channel/shape metadata a backbone is built with."""

    num_input_channels: int
    num_output_channels: int
    num_conditional_channels: int = 0
    spatial_shape: Tuple[int, int] = (16, 16)


def concat_condition(x: torch.Tensor, condition: Optional[torch.Tensor], num_conditional_channels: int) -> torch.Tensor:
    """Channel-concat the condition in front of x (NCHW: dim 1, condition first)."""
    if num_conditional_channels > 0:
        assert condition is not None, "model built with conditional channels but condition is None"
        return torch.cat([condition, x], dim=1)
    assert condition is None, "condition given but num_conditional_channels == 0"
    return x


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW with flax's running statistics and an explicit
    mode per call (the original reference's state-dict keys: ``weight``,
    ``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``).

    ``forward(x)`` normalizes with the running averages. ``forward(x,
    batch_stats)`` with a dict normalizes with the batch statistics (biased
    variance) and stores this layer's updated running averages in
    ``batch_stats[self]`` as flax computes them: ``0.9 * old + 0.1 * batch``
    with the BIASED batch variance, the statistics in f32. (torch's own
    update folds in the unbiased variance.) The buffers are left as they
    are: the second forecaster pass of the DYffusion loss must read the
    same running averages as before the first.

    Inside a process group (data parallelism) the batch statistics are the
    GLOBAL batch's, as flax's mean over a batch sharded on the JAX mesh's
    ``'data'`` axis is (and, under spatial sharding, over every slab of
    the grid): ``distributed.mean_var`` over the world, differentiable, so
    the gradient flows through the global statistics too; in f32, or f64
    for an f64 input. Its two sums (the mean, then the squares about it),
    where flax computes max(0, E[x^2] - E[x]^2) in one: that difference
    cancels in f32 where the mean is large against the spread, and a
    sharded NS stage 2 then drifted from one process (to 1.4e-4 of its
    loss in 6 steps on the CPU) where the centred sum stays on it.
    (``torch.nn.SyncBatchNorm`` refuses CPU tensors, and the CPU tests run
    two gloo ranks.)"""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__(num_features, eps=eps)
        self.decay = float(momentum)  # flax's momentum: the weight of the old average

    def forward(self, x: torch.Tensor, batch_stats: Optional[dict] = None) -> torch.Tensor:
        if batch_stats is None:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        if distributed.active():
            return self._global_batch_norm(x, batch_stats)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            m = self.decay
            batch_stats[self] = (
                m * self.running_mean.float() + (1.0 - m) * mean,
                m * self.running_var.float() + (1.0 - m) * var,
                self.num_batches_tracked + 1,
            )
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_batch_norm(self, x: torch.Tensor, batch_stats: dict) -> torch.Tensor:
        centred, mean, var = distributed.mean_var(x, (0, 2, 3), torch.distributed.group.WORLD)
        with torch.no_grad():
            m = self.decay
            batch_stats[self] = (
                m * self.running_mean.float() + (1.0 - m) * mean.detach().reshape(-1),
                m * self.running_var.float() + (1.0 - m) * var.detach().reshape(-1),
                self.num_batches_tracked + 1,
            )
        row = (1, -1, 1, 1)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(var.dtype).reshape(row)
        return (centred * scale + self.bias.to(var.dtype).reshape(row)).to(x.dtype)


def norm_call(norm: nn.Module, x: torch.Tensor, batch_stats: Optional[dict]) -> torch.Tensor:
    """Apply a normalization layer; only a :class:`BatchNorm2d` takes the
    ``batch_stats`` switch."""
    return norm(x, batch_stats) if isinstance(norm, BatchNorm2d) else norm(x)


def has_batch_norm(module: nn.Module) -> bool:
    return any(isinstance(m, BatchNorm2d) for m in module.modules())


def _first_float_dtype(tensors) -> Optional[torch.dtype]:
    return next((v.dtype for v in tensors if v.is_floating_point()), None)


def apply_model(
    module: nn.Module,
    params: Optional[Mapping[str, torch.Tensor]],
    x: torch.Tensor,
    time: Optional[torch.Tensor] = None,
    condition: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    batch_stats: Optional[dict] = None,
) -> torch.Tensor:
    """Call a backbone with its own weights, or with ``params`` substituted
    (the JAX package's ``apply_fn(variables, ...)``; used for bf16 copies
    and EMA weights). ``params`` may hold buffers too (BatchNorm running
    statistics); those it lacks are the module's own. ``batch_stats``: see
    :class:`BatchNorm2d` (only for a backbone that has one).

    Inputs and weights meet in their promoted dtype, as flax's layers
    promote them: bf16 inputs to an f32 network run in f32, and f32 inputs
    to bf16 weights run in f32 on the bf16-rounded weights (both happen in
    mixed-precision training). The time input is not cast: the time
    embedding runs in f32 either way."""
    if params:
        w_dtype = _first_float_dtype(params.values())
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
    args = (x, time, condition, generator) + (() if batch_stats is None else (batch_stats,))
    if not params:
        return module(*args)
    return torch.func.functional_call(module, dict(params), args)


def apply_model_train(
    module: nn.Module,
    params: Optional[Mapping[str, torch.Tensor]],
    x: torch.Tensor,
    time: Optional[torch.Tensor] = None,
    condition: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode call: :func:`apply_model` with BatchNorm on the batch
    statistics. Returns ``(prediction, updates)``, ``updates`` the new
    running statistics by buffer name (``{}`` for a backbone without
    BatchNorm), for :func:`load_model_state_updates`."""
    if not has_batch_norm(module):
        return apply_model(module, params, x, time, condition, generator), {}
    stats: dict = {}
    out = apply_model(module, params, x, time, condition, generator, batch_stats=stats)
    names = {m: n for n, m in module.named_modules()}
    updates = {}
    for m, (mean, var, count) in stats.items():
        updates[f"{names[m]}.running_mean"] = mean
        updates[f"{names[m]}.running_var"] = var
        updates[f"{names[m]}.num_batches_tracked"] = count
    return out, updates


@torch.no_grad()
def load_model_state_updates(module: nn.Module, updates: Mapping[str, torch.Tensor]) -> None:
    """Copy :func:`apply_model_train`'s updates into the module's buffers."""
    buffers = dict(module.named_buffers())
    for k, v in updates.items():
        buffers[k].copy_(v)
