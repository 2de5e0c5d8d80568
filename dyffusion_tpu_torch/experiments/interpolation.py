"""Stage-1 interpolation experiment: learn x_i = I(x_0, x_h, i) for i in
[1, h-1]. Counterpart of ``dyffusion_tpu/experiments/interpolation.py``.

Inputs are the window frames channel-stacked plus the LAST frame; training
draws a random i per row; evaluation runs an MC-dropout ensemble at EVERY i,
the N members folded into the batch (one (N*B)-batch forward per i).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from dyffusion_tpu_torch.experiments.base import Experiment, cast_params, stack_window
from dyffusion_tpu_torch.models.base import MODEL_STATE_UPDATES, apply_model, apply_model_train
from dyffusion_tpu_torch.utils.loss import get_loss_fn


class InterpolationExperiment(Experiment):
    def __init__(self, cfg, dims, model=None, device="cuda"):
        super().__init__(cfg, dims, device)
        assert cfg.horizon >= 2, "horizon must be >= 2 for interpolation"
        self.model = model
        self.criterion = get_loss_fn(cfg.loss_function)

    # inputs = window frames + last frame, channel-stacked
    def actual_num_input_channels(self) -> int:
        return self.dims["input"] * self.cfg.window + self.dims["input"]

    @property
    def horizon_range(self):
        return list(range(1, self.cfg.horizon))  # 1..h-1

    def get_inputs(self, dynamics: torch.Tensor) -> torch.Tensor:
        """(B, window+horizon, H, W, C) -> NCHW first ``window`` frames
        (stacked) + last frame: (B, (window+1)*C, H, W)."""
        assert dynamics.shape[1] == self.cfg.window + self.cfg.horizon
        past = stack_window(dynamics, self.cfg.window)
        last = dynamics[:, -1].permute(0, 3, 1, 2)
        return torch.cat([past, last], dim=1)

    def make_loss_fn(self) -> Callable:
        """``loss_fn(params, batch, generator) -> (loss, metrics)``: i ~
        U{1..h-1} per row from ``generator``, target ``dynamics[:, w+i-1]``.
        ``params`` replaces the model's weights (``None``: its own). The
        model runs in train mode: a BatchNorm backbone's running-statistics
        updates come back in the metrics under ``MODEL_STATE_UPDATES``."""
        w, h = self.cfg.window, self.cfg.horizon

        def loss_fn(params, batch: Dict[str, Any], generator: Optional[torch.Generator]):
            dynamics = self.to_device(batch["dynamics"])
            B = dynamics.shape[0]
            t = torch.randint(1, h, (B,), generator=generator, device=dynamics.device)
            targets = dynamics[torch.arange(B, device=dynamics.device), w + t - 1].permute(0, 3, 1, 2)
            preds, updates = apply_model_train(
                self.model, params, self.get_inputs(dynamics), t.float(), self.static_condition(batch), generator
            )
            loss = self.criterion(preds, targets)
            return loss, ({"loss": loss, MODEL_STATE_UPDATES: updates} if updates else {"loss": loss})

        return loss_fn

    def make_eval_fn(self, split: str = "val") -> Callable:
        """``eval_fn(batch, generator=None, params=None) -> {'t{i}_preds':
        (N, B, H, W, C), 't{i}_targets': (B, H, W, C)}`` (f32 tensors on the
        device): the N-member MC-dropout ensemble at every i, members folded
        into the batch, in ``eval_dtype``. ``params`` replaces the model's
        weights (e.g. the EMA)."""
        if not self.cfg.fold_members_into_batch:
            raise NotImplementedError("only the folded ensemble layout is ported (fold_members_into_batch=True)")
        w, h = self.cfg.window, self.cfg.horizon
        n_members = self.num_members(split)
        noise = self.cfg.prediction_inputs_noise
        use_dropout = self.cfg.enable_inference_dropout
        dtype = self.eval_dtype()

        def _tile(x):  # (B, ...) -> (N*B, ...), member-major
            return x.unsqueeze(0).expand((n_members,) + tuple(x.shape)).reshape((-1,) + tuple(x.shape[1:]))

        @torch.no_grad()
        def eval_fn(batch: Dict[str, Any], generator: Optional[torch.Generator] = None, params=None):
            dynamics = self.to_device(batch["dynamics"]).float()
            B = dynamics.shape[0]
            cond = self.static_condition(batch)
            p = cast_params(self.model, dtype, params)
            x = _tile(self.get_inputs(dynamics).to(dtype))
            c_flat = None if cond is None else _tile(cond.to(dtype))
            if noise > 0:
                x = x + noise * torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            out = {}
            for i in self.horizon_range:
                t_b = torch.full((x.shape[0],), float(i), dtype=torch.float32, device=x.device)
                pred = apply_model(self.model, p, x, t_b, c_flat, generator if use_dropout else None)
                pred = pred.float().reshape((n_members, B) + tuple(pred.shape[1:]))
                out[f"t{i}_preds"] = pred.permute(0, 1, 3, 4, 2)  # (N, B, H, W, C)
                out[f"t{i}_targets"] = dynamics[:, w + i - 1]
            return out

        return eval_fn
