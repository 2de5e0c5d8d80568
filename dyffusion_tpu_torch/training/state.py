"""Train state: the model, its optimizer, the EMA shadow, the step generator
and the step count (counterpart of ``dyffusion_tpu/training/state.py``).

The JAX package keeps these in one immutable pytree that each step
replaces; here they are the live objects, updated in place by
:meth:`TrainState.apply_gradients`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from dyffusion_tpu_torch.models.base import load_model_state_updates
from dyffusion_tpu_torch.training.ema import ema_update, init_ema
from dyffusion_tpu_torch.training.optim import Optimizer


class TrainState:
    """``fold_factor`` (``trainer.fold_accumulation_into_batch``) is how many
    accumulation micro-batches one step stands for: an unfolded run updates
    the EMA once per micro-batch (k-1 updates against the unchanged weights,
    then one against the stepped weights) and counts ``step`` in
    micro-batches; a folded step replays exactly that, so folded and
    unfolded runs have the same EMA trajectory and step units."""

    def __init__(
        self,
        model: nn.Module,
        optimizer: Optimizer,
        generator: torch.Generator,
        use_ema: bool = True,
        ema_decay: float = 0.9999,
        fold_factor: int = 1,
        row_generator: Optional[torch.Generator] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator  # the dropout / time draws of every step, in order
        # data parallelism: the per-row draws of the global batch, seeded alike on every rank
        self.row_generator = row_generator
        self.params: Dict[str, nn.Parameter] = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.fold_factor = fold_factor
        self.ema = init_ema(self.params) if use_ema else None
        self.ema_num_updates = 0
        self.step = 0  # micro-batches

    def apply_gradients(self, model_state_updates: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """One optimizer step from the weights' ``.grad``, then the EMA
        (over the parameters only), then the model-state updates of the step
        (BatchNorm running statistics, :func:`~dyffusion_tpu_torch.models.
        base.apply_model_train`) into the model's buffers."""
        if self.use_ema:
            # folded: the k-1 micro-batch updates against the not-yet-stepped weights
            for _ in range(self.fold_factor - 1):
                self.ema_num_updates = ema_update(self.ema, self.params.values(), self.ema_num_updates, self.ema_decay)
        self.optimizer.step()
        if self.use_ema:
            self.ema_num_updates = ema_update(self.ema, self.params.values(), self.ema_num_updates, self.ema_decay)
        if model_state_updates:
            load_model_state_updates(self.model, model_state_updates)
        self.step += self.fold_factor

    def eval_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The weights to evaluate with: the EMA shadow if enabled, else
        ``None`` (the model's own). Either way the buffers (BatchNorm
        running statistics) are the model's live ones."""
        return self.ema if self.use_ema else None

    def state_dict(self) -> Dict[str, Any]:
        """The checkpoint: step, the model's parameters and buffers, the EMA
        and its update count, the canonical optimizer state and the step
        generator's state, as plain CPU copies. The trainer's shuffle
        generator is not part of it (nor is it in the JAX package's)."""
        return _cpu_copy({
            "step": int(self.step),
            "model": self.model.state_dict(),
            "ema": self.ema,
            "ema_num_updates": int(self.ema_num_updates),
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
        })

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a checkpoint into the live tensors (they keep their device)."""
        self.model.load_state_dict(state["model"])
        if self.use_ema:
            if state["ema"] is None:
                raise ValueError("module.use_ema is on, but the checkpoint holds no EMA weights")
            with torch.no_grad():
                for k, v in self.ema.items():
                    v.copy_(state["ema"][k])
        self.ema_num_updates = int(state["ema_num_updates"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])


def _cpu_copy(tree):
    """``tree`` with every tensor replaced by a detached CPU copy."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return tree
