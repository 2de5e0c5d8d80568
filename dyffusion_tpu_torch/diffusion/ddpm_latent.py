"""LDM-style DDPM (the second DDPM variant, ``diffusion.name=ddpm_v2``).

Counterpart of ``dyffusion_tpu/diffusion/ddpm_latent.py``: the LDM schedule
factory (``linear_start``/``linear_end``/``cosine_s``, ``given_betas``,
``hardcode_betaN``), the ``v_posterior`` blend of the posterior variance,
the VLB weights (computed in f32 from the f32 buffers; index 0 copies index
1), the per-row l1 or l2 loss mixed as ``l_simple_weight * loss_simple +
original_elbo_weight * loss_vlb``, with an optional learned per-timestep
logvar (``loss_simple = mean(per_row / exp(logvar_t) + logvar_t)``), the
ancestral sampler with ``clip_denoised`` and ``return_intermediates``,
``log_images``, and :func:`make_conditioned_apply`.

With ``learn_logvar`` the logvar is a trainable (T,) parameter the caller
owns and passes to :meth:`LatentDDPMEngine.loss`; the port registers it on
the denoiser as the parameter ``_diffusion_logvar`` (state-dict key
``_diffusion_logvar``; see ``interface.build_experiment``), so the
optimizer, the EMA and the checkpoints carry it like any weight, and the
denoiser's forward never reads it.

The denoiser gets the step t in [0, T) as a float; in training its dropout
is live when a generator is given; the sampler calls it without one. Every
random tensor comes from :meth:`LatentDDPMEngine.draw`: the loss's noise;
the sampler's initial noise, then one per step but the last.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dyffusion_tpu_torch.diffusion.ddpm import BufferTable, initial_shape
from dyffusion_tpu_torch.diffusion.schedules import make_beta_schedule
from dyffusion_tpu_torch.models.base import apply_model
from dyffusion_tpu_torch.utils import rng
from dyffusion_tpu_torch.utils.loop import loop

Params = Optional[Mapping[str, torch.Tensor]]
f32 = np.float32


@dataclass(frozen=True)
class LatentDDPMConfig:
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 1e-4
    linear_end: float = 2e-2
    cosine_s: float = 8e-3
    parameterization: str = "pred_noise"  # 'pred_noise' | 'pred_x0'
    v_posterior: float = 0.0
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    learn_logvar: bool = False
    logvar_init: float = 0.0
    hardcode_betaN: bool = False
    clip_denoised: bool = False
    loss_function: str = "mse"  # 'l1'/'mae' or 'l2'/'mse' (the presets pass 'l1')

    def __post_init__(self):
        assert self.parameterization in ("pred_noise", "pred_x0")


class LatentDDPMEngine:
    """LDM-DDPM over a denoiser module; ``sample_shape`` is (C, H, W) of one
    sample, ``params`` arguments replace the denoiser's weights (``None``:
    its own). The buffers live on ``device`` (default: the denoiser's)."""

    def __init__(
        self,
        config: LatentDDPMConfig,
        denoiser: nn.Module,
        sample_shape: Sequence[int],
        given_betas: Optional[np.ndarray] = None,
        device: Optional[torch.device] = None,
    ):
        self.cfg = config
        self.denoiser = denoiser
        self.sample_shape = tuple(sample_shape)
        device = device if device is not None else next(denoiser.parameters()).device
        betas = (
            np.asarray(given_betas, np.float64)
            if given_betas is not None
            else make_beta_schedule(
                config.beta_schedule, config.timesteps, linear_start=config.linear_start,
                linear_end=config.linear_end, cosine_s=config.cosine_s,
            )
        )
        if config.hardcode_betaN:
            betas[-1] = 1.0
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        self.num_timesteps = len(betas)
        v = config.v_posterior
        post_var = (1 - v) * betas * (1.0 - ac_prev) / (1.0 - ac) + v * betas

        self.buffers = b = BufferTable(device)
        b.add("betas", betas)
        b.add("alphas_cumprod", ac)
        b.add("sqrt_alphas_cumprod", np.sqrt(ac))
        b.add("sqrt_one_minus_alphas_cumprod", np.sqrt(1.0 - ac))
        b.add("sqrt_recip_alphas_cumprod", np.sqrt(1.0 / ac))
        b.add("sqrt_recipm1_alphas_cumprod", np.sqrt(1.0 / ac - 1.0))
        b.add("posterior_variance", post_var)
        b.add("posterior_log_variance_clipped", np.log(np.maximum(post_var, 1e-20)))
        b.add("posterior_mean_coef1", betas * np.sqrt(ac_prev) / (1.0 - ac))
        b.add("posterior_mean_coef2", (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac))
        # the VLB weights in f32 from the f32-cast buffers; index 0 divides by
        # a zero posterior variance and is overwritten with index 1
        b32, pv32 = betas.astype(np.float32), post_var.astype(np.float32)
        a32, ac32 = alphas.astype(np.float32), ac.astype(np.float32)
        with np.errstate(divide="ignore"):
            if config.parameterization == "pred_noise":
                lvlb = b32**2 / (2 * pv32 * a32 * (1 - ac32))
            else:
                lvlb = 0.5 * np.sqrt(ac32) / (2.0 * 1 - ac32)
        lvlb[0] = lvlb[1]
        assert not np.isnan(lvlb).all()
        b.add("lvlb_weights", lvlb)
        lv = b.host["posterior_log_variance_clipped"]
        self._posterior_std = np.exp(f32(0.5) * lv).astype(np.float32)

    def init_logvar(self) -> torch.Tensor:
        """The learned logvar's initial value, (T,) f32 on the CPU."""
        return torch.full((self.num_timesteps,), float(self.cfg.logvar_init), dtype=torch.float32)

    def draw(self, shape: Sequence[int], generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
        """A standard-normal f32 tensor: every random tensor of the engine,
        each over the sample's grid (under a shard the rank's slab of the
        global draw, ``utils.rng.spatial_shard``)."""
        return rng.row_randn(shape, generator, device, grid=True)

    def draw_steps(self, n: int, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
        """The loss's per-row steps t ~ U{0..T-1}: the engine's only other random draw."""
        return rng.row_randint(0, self.num_timesteps, n, generator, device)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        c = self.buffers.coef
        return c("sqrt_alphas_cumprod", t, x_start.ndim) * x_start + c(
            "sqrt_one_minus_alphas_cumprod", t, x_start.ndim
        ) * noise

    # ---- training ----
    def p_losses(
        self,
        params: Params,
        generator: Optional[torch.Generator],
        x_start: torch.Tensor,
        condition: Optional[torch.Tensor],
        t: torch.Tensor,
        logvar: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss at per-row steps ``t``: {loss, loss_simple, loss_vlb}.
        ``logvar``: the learned (T,) logvar, or ``None`` (constant)."""
        cfg = self.cfg
        noise = self.draw(x_start.shape, generator, x_start.device).to(x_start.dtype)
        x_noisy = self.q_sample(x_start, t, noise)
        model_out = apply_model(self.denoiser, params, x_noisy, t.float(), condition, generator)
        target = noise if cfg.parameterization == "pred_noise" else x_start
        err = model_out - target
        per_elem = err.abs() if cfg.loss_function in ("l1", "mae") else err**2
        per_row = per_elem.mean(dim=tuple(range(1, x_start.ndim)))
        if logvar is not None:
            lv_t = logvar[t.long()]
            loss_simple = (per_row / torch.exp(lv_t) + lv_t).mean()
        else:
            loss_simple = per_row.mean()
        loss_vlb = (self.buffers.dev["lvlb_weights"][t.long()] * per_row).mean()
        loss = cfg.l_simple_weight * loss_simple + cfg.original_elbo_weight * loss_vlb
        return loss, {"loss": loss, "loss_simple": loss_simple, "loss_vlb": loss_vlb}

    def loss(self, params: Params, generator, x_start, condition, logvar: Optional[torch.Tensor] = None):
        """t ~ U{0..T-1} per row from ``generator``, then :meth:`p_losses`."""
        t = self.draw_steps(x_start.shape[0], generator, x_start.device)
        return self.p_losses(params, generator, x_start, condition, t, logvar)

    # ---- sampling ----
    def _step(self, params: Params, img: torch.Tensor, x, condition) -> torch.Tensor:
        """The posterior mean of one ancestral step, its values ``x`` (``t``
        and the step's coefficients) 0-dim CPU tensors."""
        t_in = torch.zeros((img.shape[0],), dtype=torch.float32, device=img.device) + x["t"]
        out = apply_model(self.denoiser, params, img, t_in, condition, None)
        if self.cfg.parameterization == "pred_noise":
            x0 = x["sqrt_recip_alphas_cumprod"] * img - x["sqrt_recipm1_alphas_cumprod"] * out
        else:
            x0 = out
        if self.cfg.clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        return x["posterior_mean_coef1"] * x0 + x["posterior_mean_coef2"] * img

    def sample(
        self,
        params: Params,
        generator: Optional[torch.Generator],
        condition: torch.Tensor,
        return_intermediates: bool = False,
        log_every_t: int = 100,
    ):
        """The ancestral sampler: (B, C, H, W); with ``return_intermediates``
        also the (K, B, C, H, W) stack of the initial noise and the image
        after each step t with ``t % log_every_t == 0`` or t = T-1.

        The steps T-1 .. 1, which add noise, run as one
        :func:`utils.loop.loop` (one loop op in an exported sampler), or as
        a Python loop over the same step where the intermediates are kept;
        the noise-free t = 0 is peeled."""
        T = self.num_timesteps
        img = self.draw(initial_shape(self.sample_shape, condition), generator, condition.device)
        names = ("sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1", "posterior_mean_coef2")
        h = self.buffers.host

        def values(ts):
            idx = np.asarray(ts, np.int64)
            return {"t": torch.from_numpy(idx.astype(np.float32)), **{n: torch.from_numpy(h[n][idx]) for n in names},
                    "std": torch.from_numpy(self._posterior_std[idx])}

        def step(carry, x, consts):
            (img,), (params, condition) = carry, consts
            mean = self._step(params, img, x, condition)
            return (mean + x["std"] * self.draw(img.shape, generator, img.device),)

        xs, consts = values(range(T - 1, 0, -1)), (params, condition)
        inter = None
        if return_intermediates:
            lg = max(int(log_every_t), 1)
            inter = [img]
            for j, t in enumerate(range(T - 1, 0, -1)):
                (img,) = step((img,), {k: v[j] for k, v in xs.items()}, consts)
                if t % lg == 0 or t == T - 1:
                    inter.append(img)
        else:
            (img,) = loop(step, (img,), xs, consts, (self.denoiser,))
        img = self._step(params, img, {k: v[0] for k, v in values([0]).items()}, condition)  # no noise at t = 0
        if return_intermediates:
            inter.append(img)
            return img, torch.stack(inter)
        return img

    def log_images(
        self,
        params: Params,
        generator: Optional[torch.Generator],
        x_start: torch.Tensor,
        condition: torch.Tensor,
        n_row: int = 4,
        sample: bool = True,
        log_every_t: int = 100,
    ) -> Dict[str, torch.Tensor]:
        """Visual diagnostics: the inputs, the forward diffusion row
        (``q_sample`` at up to 10 evenly spaced t, one noise draw), and with
        ``sample`` the ancestral samples and their denoising row."""
        n_row = min(n_row, x_start.shape[0])
        xs = x_start[:n_row]
        out = {"inputs": xs}
        noise = self.draw(xs.shape, generator, xs.device).to(xs.dtype)
        n_steps = min(10, self.num_timesteps)
        t_row = np.linspace(0, self.num_timesteps - 1, n_steps).astype(np.int32)
        out["diffusion_row"] = torch.stack(
            [self.q_sample(xs, torch.full((n_row,), int(t), device=xs.device), noise) for t in t_row]
        )
        if sample:
            samples, denoise_row = self.sample(
                params, generator, condition[:n_row], return_intermediates=True, log_every_t=log_every_t
            )
            out["samples"], out["denoise_row"] = samples, denoise_row
        return out


def make_conditioned_apply(apply_fn: Callable, conditioning_key: Optional[str]) -> Callable:
    """The LDM ``DiffusionWrapper``: route conditioning into a denoiser call
    by mode (no preset builds one). ``None``: ``apply_fn(x, t)``;
    ``'concat'``: ``c_concat`` channel-concatenated after ``x`` (NCHW dim
    1); ``'crossattn'``: ``c_crossattn`` concatenated on the last axis and
    passed as ``context=``; ``'hybrid'``: both; ``'adm'``: the first ``c_crossattn``
    passed as the class label ``y=``. ``c_concat``/``c_crossattn`` are
    lists of tensors."""
    assert conditioning_key in (None, "concat", "crossattn", "hybrid", "adm"), (
        f"unknown conditioning_key {conditioning_key!r}"
    )

    def wrapped(x: torch.Tensor, t: torch.Tensor, c_concat=None, c_crossattn=None) -> torch.Tensor:
        if conditioning_key is None:
            return apply_fn(x, t)
        if conditioning_key == "concat":
            return apply_fn(torch.cat([x, *c_concat], dim=1), t)
        if conditioning_key == "crossattn":
            return apply_fn(x, t, context=torch.cat(c_crossattn, dim=-1))
        if conditioning_key == "hybrid":
            return apply_fn(torch.cat([x, *c_concat], dim=1), t, context=torch.cat(c_crossattn, dim=-1))
        return apply_fn(x, t, y=c_crossattn[0])  # 'adm'

    return wrapped
