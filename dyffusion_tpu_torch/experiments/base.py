"""Experiment layer: channel arithmetic, loss and eval functions.

Counterpart of ``dyffusion_tpu/experiments/base.py``. Batches are dicts of
arrays in the JAX package's layout: ``dynamics`` (B, T, H, W, C) and an
optional static ``condition`` (B, H, W, Cc); numpy arrays or tensors.

Experiments run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); where there is no CUDA device the default raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from dyffusion_tpu_torch.models.base import BackboneSpec


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where CUDA is not
    available raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested, but torch.cuda.is_available() is False: the port runs on the "
            "GPU by default; pass device='cpu' to run on the CPU"
        )
    return device


def stack_window(dynamics: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T, H, W, C) leading ``window`` frames -> (B, window*C, H, W), NCHW,
    time-major channels (the same channel order as the JAX package's
    (B, H, W, window*C))."""
    past = dynamics[:, :window]  # (B, w, H, W, C)
    B, w, H, W, C = past.shape
    return past.permute(0, 1, 4, 2, 3).reshape(B, w * C, H, W)


def cast_params(
    module: nn.Module, dtype: torch.dtype, params: Optional[Mapping[str, torch.Tensor]] = None
) -> Optional[Dict[str, torch.Tensor]]:
    """Weights for ``functional_call`` at ``dtype``: ``params`` (or the
    module's own parameters) with the module's buffers (BatchNorm running
    statistics), as ``dtype`` copies (the JAX package casts every floating
    variable); ``None`` (the module's own weights) when there is nothing to
    substitute or cast."""
    if params is None:
        if dtype == torch.float32:
            return None
        params = module.state_dict()
    else:
        params = {**dict(module.named_buffers()), **params}
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


@dataclass
class ExperimentConfig:
    """Shared experiment hyperparameters (the JAX ``ExperimentConfig``)."""

    window: int = 1
    horizon: int = 1
    prediction_horizon: Optional[int] = None
    num_predictions: int = 20  # ensemble members (val, predict)
    num_predictions_test: int = 50
    prediction_inputs_noise: float = 0.0
    enable_inference_dropout: bool = True
    loss_function: str = "mse"
    eval_dtype: Optional[str] = None  # None | 'bfloat16'
    # mixed-precision training: the compute runs in bf16 through a cast at
    # the loss boundary; master weights, optimizer state, EMA, gradients and
    # loss reductions stay f32
    train_dtype: Optional[str] = None  # None | 'bfloat16'
    fold_members_into_batch: bool = True  # the only eval layout ported so far
    use_ema: bool = False
    ema_decay: float = 0.9999
    optimizer: Dict[str, Any] = field(default_factory=lambda: {"name": "adamw", "lr": 3e-4})
    scheduler: Optional[Dict[str, Any]] = None
    monitor: Optional[str] = None


class Experiment:
    """Base experiment. Subclasses implement channel arithmetic, loss and eval."""

    def __init__(self, cfg: ExperimentConfig, dims: Dict[str, Any], device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.dims = dims  # {'input', 'output', 'conditional', 'spatial'}
        self.device = resolve_device(device)

    def actual_num_input_channels(self) -> int:
        return self.dims["input"]

    def actual_num_output_channels(self) -> int:
        return self.dims["output"]

    def num_conditional_channels(self) -> int:
        return self.dims.get("conditional", 0)

    def backbone_spec(self) -> BackboneSpec:
        return BackboneSpec(
            num_input_channels=self.actual_num_input_channels(),
            num_output_channels=self.actual_num_output_channels(),
            num_conditional_channels=self.num_conditional_channels(),
        )

    @property
    def default_monitor(self) -> str:
        # ensemble CRPS when ensembling, as the JAX package does
        return "val/crps" if self.cfg.num_predictions > 1 else "val/avg/mse"

    @property
    def monitor(self) -> str:
        return self.cfg.monitor or self.default_monitor

    def num_members(self, split: str) -> int:
        return self.cfg.num_predictions_test if split == "test" else self.cfg.num_predictions

    def eval_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.eval_dtype in ("bfloat16", "bf16") else torch.float32

    def to_device(self, x) -> Optional[torch.Tensor]:
        """A batch array (numpy or tensor) as a tensor on the device; float64
        becomes f32, other dtypes are kept (bf16 batches of mixed-precision
        training stay bf16)."""
        if x is None:
            return None
        t = torch.as_tensor(x, device=self.device)
        return t.float() if t.dtype == torch.float64 else t

    def static_condition(self, batch: Dict[str, Any]) -> Optional[torch.Tensor]:
        """The batch's static condition, NCHW on the device."""
        cond = self.to_device(batch.get("condition"))
        return None if cond is None else cond.permute(0, 3, 1, 2)
