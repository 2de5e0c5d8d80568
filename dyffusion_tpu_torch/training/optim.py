"""Optimizers, LR schedules, gradient clipping and accumulation.

Counterpart of ``dyffusion_tpu/training/optim.py``, which builds an optax
chain: ``MultiSteps(chain(clip_by_global_norm, adamw | adam | sgd))`` with
an LR schedule. Here the same update in torch: ``torch.optim`` for the
optimizer (torch's AdamW takes the decoupled decay lr * wd * p from the
weights before the update and corrects the moments' bias as optax's adamw
does), ``LambdaLR`` for the schedules, and clipping and accumulation written
out as optax does them.

The schedules are the original reference's LambdaLR multipliers
(``LambdaWarmUpCosineScheduler``, ``...Scheduler2``, ``LambdaLinearScheduler``),
computed in f32 as the JAX package computes them.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

f32 = np.float32


def warmup_cosine_schedule(warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float, max_decay_steps: int):
    """LambdaWarmUpCosineScheduler: step -> multiplier."""

    def schedule(n) -> float:
        n = f32(n)
        if n < warm_up_steps:
            return float(f32((lr_max - lr_start) / warm_up_steps) * n + f32(lr_start))
        t = min(f32((n - f32(warm_up_steps)) / f32(max(max_decay_steps - warm_up_steps, 1))), f32(1.0))
        return float(f32(lr_min) + f32(0.5 * (lr_max - lr_min)) * (f32(1) + np.cos(f32(t * f32(np.pi)))))

    return schedule


def _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths, linear: bool):
    """Shared core of the multi-cycle schedulers: cycle i holds the steps n
    with cum[i] < n <= cum[i+1]."""
    lists = [list(v) for v in (warm_up_steps, f_min, f_max, f_start, cycle_lengths)]
    assert len({len(v) for v in lists}) == 1, "schedule lists must have one length"
    wus, fmins, fmaxs, fstarts, cls = (np.asarray(v, np.float32) for v in lists)
    cum = np.cumsum([0] + lists[4]).astype(np.float32)

    def schedule(n) -> float:
        n = f32(n)
        cycle = min(int(np.sum(n > cum[1:])), len(cls) - 1)
        nn_ = n - cum[cycle]
        if nn_ < wus[cycle]:
            return float((fmaxs[cycle] - fstarts[cycle]) / wus[cycle] * nn_ + fstarts[cycle])
        if linear:
            return float(fmins[cycle] + (fmaxs[cycle] - fmins[cycle]) * (cls[cycle] - nn_) / cls[cycle])
        t = min((nn_ - wus[cycle]) / max(cls[cycle] - wus[cycle], f32(1.0)), f32(1.0))
        return float(fmins[cycle] + f32(0.5) * (fmaxs[cycle] - fmins[cycle]) * (f32(1) + np.cos(t * f32(np.pi))))

    return schedule


def warmup_cosine_schedule2(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """LambdaWarmUpCosineScheduler2 (multi-cycle)."""
    return _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths, linear=False)


def linear_schedule(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """LambdaLinearScheduler."""
    return _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths, linear=True)


_SCHEDULES = {
    "warmup_cosine": warmup_cosine_schedule,
    "warmup_cosine2": warmup_cosine_schedule2,
    "linear_warmup": linear_schedule,
}


def make_lr_multiplier(name: str, **kwargs) -> Callable[[int], float]:
    """The named schedule as step -> multiplier of the base lr."""
    if name not in _SCHEDULES:
        raise ValueError(f"Unknown LR schedule '{name}'. Available: {sorted(_SCHEDULES)}")
    return _SCHEDULES[name](**kwargs)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: when the global norm
    exceeds ``max_norm`` every gradient becomes g / norm * max_norm, else it
    is left as it is (``torch.nn.utils.clip_grad_norm_`` instead divides by
    norm + 1e-6 always). Decided on the device, with no host sync. Returns
    the norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class Optimizer:
    """The optimizer of a training run: the update rule (``torch.optim``),
    its LR schedule, global-norm clipping, and ``accumulate_grad_batches``
    (optax ``MultiSteps``: the running mean of k micro-batch gradients, one
    update every k calls; the schedule counts updates, not micro-batches).

    :meth:`step` consumes the parameters' ``.grad`` and clears it."""

    def __init__(
        self,
        named_params: Iterable[Tuple[str, nn.Parameter]],
        name: str = "adamw",
        lr: float = 1e-3,
        weight_decay: float = 1e-5,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
        gradient_clip_val: Optional[float] = None,
        scheduler: Optional[dict] = None,
        accumulate_grad_batches: int = 1,
    ):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.params = [p for _, p in named]
        name = name.lower()
        if name == "adamw":
            # the decay mask: a GaussianFourierProjection's fixed random
            # features ('fourier_emb') must not decay; the Unet has none
            decay = [p for n, p in named if "fourier_emb" not in n.split(".")]
            fixed = [p for n, p in named if "fourier_emb" in n.split(".")]
            groups = [{"params": decay}] + ([{"params": fixed, "weight_decay": 0.0}] if fixed else [])
            self.optimizer = torch.optim.AdamW(groups, lr=lr, betas=(beta1, beta2), eps=eps, weight_decay=weight_decay)
        elif name == "adam":
            self.optimizer = torch.optim.Adam(self.params, lr=lr, betas=(beta1, beta2), eps=eps)
        elif name == "sgd":
            self.optimizer = torch.optim.SGD(self.params, lr=lr)
        else:
            raise ValueError(f"Unknown optimizer: {name}")
        self.scheduler = None
        if scheduler:
            kw = dict(scheduler)
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, make_lr_multiplier(kw.pop("name"), **kw))
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = max(int(accumulate_grad_batches or 1), 1)
        self.mini_step = 0
        self._acc: Optional[List[torch.Tensor]] = None

    def _grads(self) -> List[torch.Tensor]:
        for p in self.params:
            if p.grad is None:  # a weight the loss does not reach: zero gradient
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        """Apply the gradients in ``.grad``: every call, or every
        ``accumulate_grad_batches``-th call when accumulating."""
        grads = self._grads()
        k = self.accumulate_grad_batches
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                self.zero_grad()
                return
            for a, g in zip(self._acc, grads):
                g.copy_(a)
                a.zero_()
            self.mini_step = 0
        if self.gradient_clip_val:
            clip_by_global_norm(grads, self.gradient_clip_val)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.zero_grad()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The canonical state: the ``torch.optim`` state and the schedule's,
        without the accumulation buffer and ``mini_step``. A checkpoint thus
        loads under any accumulation layout (accumulated or folded), as the
        JAX package's canonical optimizer state does."""
        return {
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict() if self.scheduler is not None else None,
        }

    def load_state_dict(self, state: dict) -> None:
        """Load a canonical state (onto the parameters' device) and start a
        fresh accumulation cycle."""
        self.optimizer.load_state_dict(state["optimizer"])
        if (self.scheduler is None) != (state["scheduler"] is None):
            raise ValueError("the checkpoint's LR schedule does not match the config's (one has none)")
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = 0
        self._acc = None


def build_optimizer(named_params: Iterable[Tuple[str, nn.Parameter]], name: str = "adamw", **kwargs) -> Optimizer:
    """Adam/AdamW/SGD with optional clipping, schedule and accumulation over
    the trainable ones of ``named_params`` (``module.named_parameters()``)."""
    return Optimizer(named_params, name=name, **kwargs)
