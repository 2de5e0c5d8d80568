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
own trajectory, from the boundary-adjusted predictions of the window
before: a datamodule with physics (``boundary_fn``, its
``boundary_conditions``) re-imposes its boundary conditions on every
predicted frame at that frame's simulation time. The member-vmap layout is
not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from dyffusion_tpu_torch.experiments.base import Experiment, cast_params, stack_window


class ForecastingExperiment(Experiment):
    """Shared multi-horizon machinery."""

    def __init__(self, cfg, dims, model=None, boundary_fn=None, device="cuda"):
        super().__init__(cfg, dims, device)
        self.model = model
        # the datamodule's hook re-imposing physics boundary conditions on
        # predictions: (preds, metadata=, time=) -> preds
        self.boundary_fn = boundary_fn

    def metadata(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's ``metadata_*`` arrays as tensors on the device, read
        once per batch by the boundary conditions."""
        return {k: self.to_device(v) for k, v in batch.items() if k.startswith("metadata_")}

    def apply_boundary(self, preds: torch.Tensor, meta: Dict[str, torch.Tensor], total_horizon: float) -> torch.Tensor:
        """``boundary_fn`` on predictions (..., B, H, W, C) of the frame
        ``total_horizon`` steps after the window, at simulation time
        ``t0 + dt * total_horizon``; without a hook, ``preds``."""
        if self.boundary_fn is None:
            return preds
        t0, dt = meta.get("metadata_t0"), meta.get("metadata_dt")
        time = None if t0 is None else t0 + (dt if dt is not None else 1.0) * total_horizon
        return self.boundary_fn(preds, metadata=meta, time=time)

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

    def record_window(
        self, out: Dict[str, torch.Tensor], preds: torch.Tensor, meta: Dict[str, torch.Tensor], ar: int,
        dynamics: torch.Tensor,
    ) -> torch.Tensor:
        """Record one window's per-t predictions (N, B, H, W, C), boundary
        conditions applied, and, where the batch has them, targets
        (B, H, W, C) into ``out``. Returns the adjusted (N, B, h, H, W, C)
        predictions: the next window continues from them."""
        h, w = self.cfg.horizon, self.cfg.window
        adjusted = []
        for i in self.horizon_range:
            total = ar * h + i
            p = self.apply_boundary(preds[:, :, i - 1], meta, float(total))
            adjusted.append(p)
            out[f"t{total}_preds"] = p
            t_idx = w + total - 1
            if t_idx < dynamics.shape[1]:
                out[f"t{total}_targets"] = dynamics[:, t_idx]
        return torch.stack(adjusted, dim=2)

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
        boundary_fn=None, device="cuda",
    ):
        super().__init__(cfg, dims, model, boundary_fn=boundary_fn, device=device)
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
            meta = self.metadata(batch) if self.boundary_fn is not None else {}
            preds = _unfold(engine.sample(fc_params, ip_params, generator, cond_flat, sc_flat), B)
            preds = self.record_window(out, preds, meta, 0, dynamics)
            for ar in range(1, n_windows):
                ar_inputs = self.next_window_inputs(preds)  # (N, B, w*C, H, W)
                ar_flat = ar_inputs.reshape((n_members * B,) + tuple(ar_inputs.shape[2:])).to(dtype)
                preds = _unfold(engine.sample(fc_params, ip_params, generator, ar_flat, sc_flat), B)
                preds = self.record_window(out, preds, meta, ar, dynamics)
            return out

        return eval_fn
