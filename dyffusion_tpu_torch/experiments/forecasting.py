"""Multi-horizon DYffusion forecasting: the stage-2 loss and the ensemble
evaluation path.

Counterpart of ``dyffusion_tpu/experiments/forecasting.py`` for
``DyffusionForecastingExperiment``: the training loss (the engine's two-term
``p_losses`` on the stacked window and the last frame) and the eval function
in the FOLDED layout: the N ensemble members are folded into the batch and
run as one (N*B)-batch sampler call; ``eval_dtype=bfloat16`` runs the
sampler on bf16 copies of both networks' weights and bf16 inputs, and casts
predictions back to f32. Autoregressive windows chain
ceil(prediction_horizon / horizon) sampler calls, each member continuing its
own trajectory. The member-vmap layout and boundary conditions are not
ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from dyffusion_tpu_torch.experiments.base import Experiment, cast_params, stack_window


class ForecastingExperiment(Experiment):
    """Shared multi-horizon machinery."""

    def __init__(self, cfg, dims, model=None, device="cuda"):
        super().__init__(cfg, dims, device)
        self.model = model

    @property
    def horizon_range(self):
        return list(range(1, self.cfg.horizon + 1))

    @property
    def num_autoregressive_steps(self) -> int:
        """ceil(prediction_horizon / horizon) - 1."""
        ph = self.cfg.prediction_horizon
        if not ph:
            return 0
        return max(1, -(-ph // self.cfg.horizon)) - 1

    def record_window(self, out: Dict[str, torch.Tensor], preds: torch.Tensor, ar: int, dynamics: torch.Tensor) -> None:
        """Record one window's per-t predictions (N, B, H, W, C) and, where
        the batch has them, targets (B, H, W, C) into ``out``. (The JAX
        package also applies a datamodule's boundary conditions here; no
        datamodule of the port has any yet.)"""
        h, w = self.cfg.horizon, self.cfg.window
        for i in self.horizon_range:
            total = ar * h + i
            out[f"t{total}_preds"] = preds[:, :, i - 1]
            t_idx = w + total - 1
            if t_idx < dynamics.shape[1]:
                out[f"t{total}_targets"] = dynamics[:, t_idx]

    def next_window_inputs(self, preds: torch.Tensor) -> torch.Tensor:
        """Last ``window`` predictions -> next stacked inputs:
        (..., h, H, W, C) -> (..., window*C, H, W), time-major channels."""
        w = self.cfg.window
        tail = preds[..., -w:, :, :, :]  # (..., w, H, W, C)
        tail = tail.movedim(-1, -3)  # (..., w, C, H, W)
        return tail.reshape(tail.shape[:-4] + (w * tail.shape[-3],) + tail.shape[-2:])


class DyffusionForecastingExperiment(ForecastingExperiment):
    """Stage-2 DYffusion sampling."""

    def __init__(
        self, cfg, dims, model=None, engine=None, interpolator=None, forward_conditioning: str = "data",
        device="cuda",
    ):
        super().__init__(cfg, dims, model, device=device)
        self.engine = engine  # DyffusionEngine over forecaster + interpolator
        self.interpolator = interpolator  # frozen interpolator module
        self.forward_conditioning = forward_conditioning

    # the forecaster's input is one frame; the window conditions it
    def actual_num_input_channels(self) -> int:
        return self.dims["input"]

    def num_conditional_channels(self) -> int:
        base = self.dims.get("conditional", 0)
        if self.forward_conditioning == "none":
            return base
        return base + self.dims["input"] * self.cfg.window

    def make_loss_fn(self) -> Callable:
        """``loss_fn(params, batch, generator) -> (loss, metrics)``: the
        engine's two-term loss with the stacked window as the condition and
        the last frame as the target. ``params`` replaces the forecaster's
        weights (``None``: its own); the interpolator keeps its frozen ones."""
        engine = self.engine

        def loss_fn(params, batch: Dict[str, Any], generator: Optional[torch.Generator]):
            dynamics = self.to_device(batch["dynamics"])
            x_last = dynamics[:, -1].permute(0, 3, 1, 2)
            condition = stack_window(dynamics, self.cfg.window)
            return engine.loss(params, None, generator, x_last, condition, self.static_condition(batch))

        return loss_fn

    def make_eval_fn(self, split: str = "val", autoregressive: bool = False) -> Callable:
        """``eval_fn(batch, generator=None, params=None) -> {'t{i}_preds':
        (N, B, H, W, C), 't{i}_targets': (B, H, W, C)}`` (f32 tensors on the
        device): the full sampler over an N-member MC-dropout ensemble folded
        into the batch. ``params`` replaces the forecaster's weights (e.g.
        the EMA)."""
        if not self.cfg.fold_members_into_batch:
            raise NotImplementedError("only the folded ensemble layout is ported (fold_members_into_batch=True)")
        engine = self.engine
        n_members = self.num_members(split)
        noise = self.cfg.prediction_inputs_noise
        n_windows = (self.num_autoregressive_steps + 1) if autoregressive else 1
        dtype = self.eval_dtype()

        def _tile(x):  # (B, ...) -> (N*B, ...), member-major
            return x.unsqueeze(0).expand((n_members,) + tuple(x.shape)).reshape((n_members * x.shape[0],) + tuple(x.shape[1:]))

        def _unfold(preds, B):  # (N*B, h, C, H, W) -> (N, B, h, H, W, C) f32
            preds = preds.float().reshape((n_members, B) + tuple(preds.shape[1:]))
            return preds.permute(0, 1, 2, 4, 5, 3)

        @torch.no_grad()
        def eval_fn(
            batch: Dict[str, Any], generator: Optional[torch.Generator] = None, params=None
        ) -> Dict[str, torch.Tensor]:
            dynamics = self.to_device(batch["dynamics"]).float()
            B = dynamics.shape[0]
            static_cond = self.static_condition(batch)
            fc_params = cast_params(engine.forecaster, dtype, params)
            ip_params = cast_params(engine.interpolator, dtype)
            cond_flat = _tile(stack_window(dynamics, self.cfg.window).to(dtype))
            sc_flat = None if static_cond is None else _tile(static_cond.to(dtype))
            if noise > 0:
                cond_flat = cond_flat + noise * torch.randn(
                    cond_flat.shape, generator=generator, device=cond_flat.device, dtype=cond_flat.dtype
                )
            out: Dict[str, torch.Tensor] = {}
            preds = _unfold(engine.sample(fc_params, ip_params, generator, cond_flat, sc_flat), B)
            self.record_window(out, preds, 0, dynamics)
            for ar in range(1, n_windows):
                ar_inputs = self.next_window_inputs(preds)  # (N, B, w*C, H, W)
                ar_flat = ar_inputs.reshape((n_members * B,) + tuple(ar_inputs.shape[2:])).to(dtype)
                preds = _unfold(engine.sample(fc_params, ip_params, generator, ar_flat, sc_flat), B)
                self.record_window(out, preds, ar, dynamics)
            return out

        return eval_fn
