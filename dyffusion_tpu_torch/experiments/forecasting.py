"""Multi-horizon forecasting experiments: DYffusion's stage 2 and the
baselines.

Counterpart of ``dyffusion_tpu/experiments/forecasting.py``:

- ``DyffusionForecastingExperiment``: the training loss (the engine's
  two-term ``p_losses`` on the stacked window and the last frame) and the
  cold sampler's eval; ``eval_dtype=bfloat16`` runs the sampler on bf16
  copies of both networks' weights and bf16 inputs.
- ``TimeConditionedForecastingExperiment``: a direct forecaster given the
  lead time t ~ U{1..h} as its time input; its eval runs one forward per t.
- ``SimultaneousForecastingExperiment``: all h frames at once, stacked on
  the channels (time-major); with a diffusion engine (DDPM, LDM-DDPM, MCVD)
  the engine generates the stacked frames, conditioned on the window.

Two ensemble layouts (``module.fold_members_into_batch``): FOLDED (the
default), the N members folded into the batch, one (N*B)-row call per
forward, all members drawing from the request's generator; or UNFOLDED, one
B-row pass per member (DYffusion: ``DyffusionEngine.sample_ensemble``),
each member on a generator of its own (``utils.rng.split``) whose stream
runs on from window to window, at about 1/N of the folded layout's peak
activation memory. The baselines' evals cast
no input: under ``eval_dtype=bfloat16`` their networks compute in f32 on
bf16-rounded weights, as the JAX package's do (its trainer casts only the
weights, and flax promotes). Predictions come back in f32.
Autoregressive windows chain ceil(prediction_horizon / horizon) windows,
each member continuing its own trajectory, from the boundary-adjusted
predictions of the window before: a datamodule with physics
(``boundary_fn``, its ``boundary_conditions``) re-imposes its boundary
conditions on every predicted frame at that frame's simulation time.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from dyffusion_tpu_torch.experiments.base import Experiment, cast_params, stack_window
from dyffusion_tpu_torch.models.base import MODEL_STATE_UPDATES, apply_model, apply_model_train
from dyffusion_tpu_torch.utils import rng
from dyffusion_tpu_torch.utils.loss import get_loss_fn


class ForecastingExperiment(Experiment):
    """Shared multi-horizon machinery."""

    def __init__(self, cfg, dims, model=None, boundary_fn=None, device="cuda"):
        super().__init__(cfg, dims, device)
        self.model = model
        self.criterion = get_loss_fn(cfg.loss_function)  # the baselines' loss (DYffusion's engine has its own)
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

    def folded_rollout(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator],
        split: str,
        autoregressive: bool,
        window_fn: Callable[[torch.Tensor, Optional[torch.Tensor], Any], torch.Tensor],
    ) -> Dict[str, torch.Tensor]:
        """The baselines' ensemble eval in the folded layout: the window's
        stacked inputs tiled to N*B rows (member-major),
        ``prediction_inputs_noise`` added in every window,
        ``window_fn(inputs, static_condition, generator) -> (N*B, h, C, H,
        W)``, and the autoregressive chain. Returns {'t{i}_preds': (N, B, H, W, C),
        't{i}_targets': (B, H, W, C)}, f32 tensors on the device."""
        n_members = self.num_members(split)
        noise = self.cfg.prediction_inputs_noise
        n_windows = (self.num_autoregressive_steps + 1) if autoregressive else 1

        def tile(x):  # (B, ...) -> (N*B, ...)
            return x.unsqueeze(0).expand((n_members,) + tuple(x.shape)).reshape((-1,) + tuple(x.shape[1:]))

        dynamics = self.to_device(batch["dynamics"]).float()
        B = dynamics.shape[0]
        static = self.static_condition(batch)
        sc_flat = None if static is None else tile(static)
        meta = self.metadata(batch) if self.boundary_fn is not None else {}
        x = tile(stack_window(dynamics, self.cfg.window))
        out: Dict[str, torch.Tensor] = {}
        for ar in range(n_windows):
            if ar > 0:
                nxt = self.next_window_inputs(preds)  # (N, B, w*C, H, W)
                x = nxt.reshape((n_members * B,) + tuple(nxt.shape[2:]))
            if noise > 0:
                x = x + noise * rng.grid_randn(x.shape, generator, x.device, x.dtype)
            p = window_fn(x, sc_flat, generator).float()
            p = p.reshape((n_members, B) + tuple(p.shape[1:])).permute(0, 1, 2, 4, 5, 3)  # (N, B, h, H, W, C)
            preds = self.record_window(out, p, meta, ar, dynamics)
        return out

    def unfolded_rollout(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator],
        split: str,
        autoregressive: bool,
        window_fn: Callable[[torch.Tensor, Optional[torch.Tensor], Any], torch.Tensor],
    ) -> Dict[str, torch.Tensor]:
        """The baselines' ensemble eval in the unfolded layout: per member,
        on its own generator, ``prediction_inputs_noise`` added in every
        window and ``window_fn(inputs, static_condition, generator) ->
        (B, h, C, H, W)`` at batch B; the autoregressive chain continues
        each member's trajectory on its generator. Returns what
        :meth:`folded_rollout` returns."""
        generators = rng.split(generator, self.num_members(split))
        noise = self.cfg.prediction_inputs_noise
        n_windows = (self.num_autoregressive_steps + 1) if autoregressive else 1
        dynamics = self.to_device(batch["dynamics"]).float()
        static = self.static_condition(batch)
        meta = self.metadata(batch) if self.boundary_fn is not None else {}
        x0 = stack_window(dynamics, self.cfg.window)
        out: Dict[str, torch.Tensor] = {}
        for ar in range(n_windows):
            inputs = self.next_window_inputs(preds) if ar > 0 else None  # (N, B, w*C, H, W)
            ps = []
            for i, g in enumerate(generators):
                x = x0 if inputs is None else inputs[i]
                if noise > 0:
                    x = x + noise * rng.grid_randn(x.shape, g, x.device, x.dtype)
                ps.append(window_fn(x, static, g).float())
            p = torch.stack(ps).permute(0, 1, 2, 4, 5, 3)  # (N, B, h, H, W, C)
            preds = self.record_window(out, p, meta, ar, dynamics)
        return out

    def ensemble_rollout(self, batch, generator, split: str, autoregressive: bool, window_fn) -> Dict[str, torch.Tensor]:
        """:meth:`folded_rollout` or :meth:`unfolded_rollout`, as
        ``fold_members_into_batch`` says."""
        rollout = self.folded_rollout if self.cfg.fold_members_into_batch else self.unfolded_rollout
        return rollout(batch, generator, split, autoregressive, window_fn)


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
        device): the full sampler over an N-member MC-dropout ensemble,
        folded into the batch or, with ``fold_members_into_batch=False``,
        one ``sample_ensemble`` member after another, each member's
        generator running on through the autoregressive windows (the JAX
        package's ``fold_in(key, window)``). ``params`` replaces the
        forecaster's weights (e.g. the EMA)."""
        engine = self.engine
        fold = self.cfg.fold_members_into_batch
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
            out: Dict[str, torch.Tensor] = {}
            meta = self.metadata(batch) if self.boundary_fn is not None else {}
            if not fold:
                condition = stack_window(dynamics, self.cfg.window).to(dtype)
                sc = None if static_cond is None else static_cond.to(dtype)
                generators = rng.split(generator, n_members)
                for ar in range(n_windows):
                    if ar > 0:
                        condition = self.next_window_inputs(preds).to(dtype)  # (N, B, w*C, H, W)
                    preds = engine.sample_ensemble(
                        fc_params, ip_params, generators, condition, sc, inputs_noise=noise if ar == 0 else 0.0
                    )
                    preds = self.record_window(out, preds.float().permute(0, 1, 2, 4, 5, 3), meta, ar, dynamics)
                return out
            cond_flat = _tile(stack_window(dynamics, self.cfg.window).to(dtype))
            sc_flat = None if static_cond is None else _tile(static_cond.to(dtype))
            if noise > 0:
                cond_flat = cond_flat + noise * rng.grid_randn(
                    cond_flat.shape, generator, cond_flat.device, cond_flat.dtype)
            preds = _unfold(engine.sample(fc_params, ip_params, generator, cond_flat, sc_flat), B)
            preds = self.record_window(out, preds, meta, 0, dynamics)
            for ar in range(1, n_windows):
                ar_inputs = self.next_window_inputs(preds)  # (N, B, w*C, H, W)
                ar_flat = ar_inputs.reshape((n_members * B,) + tuple(ar_inputs.shape[2:])).to(dtype)
                preds = _unfold(engine.sample(fc_params, ip_params, generator, ar_flat, sc_flat), B)
                preds = self.record_window(out, preds, meta, ar, dynamics)
            return out

        return eval_fn


class TimeConditionedForecastingExperiment(ForecastingExperiment):
    """The time-conditioned direct forecaster: the stacked window in, the
    frame t steps ahead out, t the network's time input."""

    def actual_num_input_channels(self) -> int:
        return self.dims["input"] * self.cfg.window

    def p_losses(self, params, batch: Dict[str, Any], t: torch.Tensor, generator: Optional[torch.Generator]):
        """The loss at per-row lead times ``t`` in [1, h]: the network in
        train mode (dropout live with ``generator``; a BatchNorm backbone's
        running-statistics updates in the metrics under
        ``MODEL_STATE_UPDATES``)."""
        dynamics = self.to_device(batch["dynamics"])
        B = dynamics.shape[0]
        inputs = stack_window(dynamics, self.cfg.window)
        targets = dynamics[torch.arange(B, device=dynamics.device), self.cfg.window + t - 1].permute(0, 3, 1, 2)
        preds, updates = apply_model_train(
            self.model, params, inputs, t.float(), self.static_condition(batch), generator
        )
        loss = self.criterion(preds, targets)
        return loss, ({"loss": loss, MODEL_STATE_UPDATES: updates} if updates else {"loss": loss})

    def make_loss_fn(self) -> Callable:
        """``loss_fn(params, batch, generator) -> (loss, metrics)``: t ~
        U{1..h} per row from ``generator``, then :meth:`p_losses`."""
        h = self.cfg.horizon

        def loss_fn(params, batch: Dict[str, Any], generator: Optional[torch.Generator]):
            B = int(batch["dynamics"].shape[0])
            t = rng.row_randint(1, h + 1, B, generator, self.device)
            return self.p_losses(params, batch, t, generator)

        return loss_fn

    def make_eval_fn(self, split: str = "val", autoregressive: bool = False) -> Callable:
        """``eval_fn(batch, generator=None, params=None)``: one forward per
        lead time t = 1..h, at N*B rows (folded) or at B rows per member,
        MC dropout on under ``enable_inference_dropout`` (see
        :meth:`ensemble_rollout`)."""
        h = self.cfg.horizon
        use_dropout = self.cfg.enable_inference_dropout
        dtype = self.eval_dtype()

        @torch.no_grad()
        def eval_fn(batch: Dict[str, Any], generator: Optional[torch.Generator] = None, params=None):
            p = cast_params(self.model, dtype, params)

            def window(x, sc, g):
                preds = []
                for t in range(1, h + 1):
                    t_b = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
                    preds.append(apply_model(self.model, p, x, t_b, sc, g if use_dropout else None))
                return torch.stack(preds, dim=1)

            return self.ensemble_rollout(batch, generator, split, autoregressive, window)

        return eval_fn


class SimultaneousForecastingExperiment(ForecastingExperiment):
    """All h frames at once, stacked on the channels, time-major. With
    ``diffusion_engine`` it hosts the DDPM, LDM-DDPM and MCVD baselines: the
    engine generates the (h*C)-channel stack, conditioned on the window
    (and the static condition behind it). ``is_diffusion`` fixes the channel
    arithmetic before the engine exists (it needs the built backbone)."""

    def __init__(
        self, cfg, dims, model=None, diffusion_engine=None, boundary_fn=None, is_diffusion=None, device="cuda"
    ):
        super().__init__(cfg, dims, model, boundary_fn=boundary_fn, device=device)
        self.diffusion_engine = diffusion_engine
        self.is_diffusion = bool(is_diffusion) if is_diffusion is not None else diffusion_engine is not None

    def actual_num_input_channels(self) -> int:
        if self.is_diffusion:  # the denoiser's input is output-shaped
            return self.actual_num_output_channels()
        return self.dims["input"] * self.cfg.window

    def actual_num_output_channels(self) -> int:
        return self.dims["output"] * self.cfg.horizon

    def num_conditional_channels(self) -> int:
        base = self.dims.get("conditional", 0)
        return base + self.dims["input"] * self.cfg.window if self.is_diffusion else base

    def unstack(self, preds: torch.Tensor) -> torch.Tensor:
        """(..., h*C, H, W) -> (..., h, C, H, W), time-major channels."""
        h = self.cfg.horizon
        return preds.reshape(tuple(preds.shape[:-3]) + (h, preds.shape[-3] // h) + tuple(preds.shape[-2:]))

    def stacked_targets(self, dynamics: torch.Tensor) -> torch.Tensor:
        """Frames w..w+h-1 of (B, T, H, W, C) stacked: (B, h*C, H, W)."""
        return stack_window(dynamics[:, self.cfg.window:], self.cfg.horizon)

    def diffusion_condition(self, inputs: torch.Tensor, static: Optional[torch.Tensor]) -> torch.Tensor:
        """The denoiser's condition: the stacked window, then the static condition."""
        return inputs if static is None else torch.cat([inputs, static], dim=1)

    def logvar(self, params) -> Optional[torch.Tensor]:
        """The LDM engine's learned logvar (the model's ``_diffusion_logvar``
        parameter, or its entry in ``params``), else ``None``."""
        if not hasattr(self.model, "_diffusion_logvar"):
            return None
        return params["_diffusion_logvar"] if params is not None else self.model._diffusion_logvar

    def make_loss_fn(self) -> Callable:
        """``loss_fn(params, batch, generator) -> (loss, metrics)``. Without
        an engine: the network in train mode on the stacked window against
        the stacked targets (BatchNorm updates under ``MODEL_STATE_UPDATES``).
        With one: the engine's loss (t and noise drawn from ``generator``),
        the denoiser called as the engine calls it (BatchNorm on its running
        averages, no updates: kept from the JAX package)."""

        def loss_fn(params, batch: Dict[str, Any], generator: Optional[torch.Generator]):
            dynamics = self.to_device(batch["dynamics"])
            inputs = stack_window(dynamics, self.cfg.window)
            targets = self.stacked_targets(dynamics)
            static = self.static_condition(batch)
            engine = self.diffusion_engine
            if engine is not None:
                cond = self.diffusion_condition(inputs, static)
                logvar = self.logvar(params)
                if logvar is not None:
                    return engine.loss(params, generator, targets, cond, logvar=logvar)
                return engine.loss(params, generator, targets, cond)
            preds, updates = apply_model_train(self.model, params, inputs, None, static, generator)
            loss = self.criterion(preds, targets)
            return loss, ({"loss": loss, MODEL_STATE_UPDATES: updates} if updates else {"loss": loss})

        return loss_fn

    def make_eval_fn(self, split: str = "val", autoregressive: bool = False) -> Callable:
        """``eval_fn(batch, generator=None, params=None)``: one forward of
        the network (MC dropout on under ``enable_inference_dropout``), or
        the engine's sampler, whose denoiser runs without dropout: its
        members differ by their noise; at N*B rows (folded) or at B rows per
        member (see :meth:`ensemble_rollout`)."""
        use_dropout = self.cfg.enable_inference_dropout
        dtype = self.eval_dtype()

        @torch.no_grad()
        def eval_fn(batch: Dict[str, Any], generator: Optional[torch.Generator] = None, params=None):
            p = cast_params(self.model, dtype, params)

            def window(x, sc, g):
                if self.diffusion_engine is not None:
                    out = self.diffusion_engine.sample(p, g, self.diffusion_condition(x, sc))
                else:
                    out = apply_model(self.model, p, x, None, sc, g if use_dropout else None)
                return self.unstack(out)

            return self.ensemble_rollout(batch, generator, split, autoregressive, window)

        return eval_fn
