"""Gaussian-diffusion baseline: DDPM ancestral and DDIM sampling.

Counterpart of ``dyffusion_tpu/diffusion/ddpm.py``: linear or cosine beta
schedules with every cumprod buffer (``hardcode_betaN`` forces the last
step to pure noise; the p2 weights are kept but, as there, not applied),
the ``pred_noise`` and ``pred_x0`` objectives with optional clipping,
``q_sample``, the denoising loss at per-row steps t, the ancestral sampler
and DDIM with eta. The JAX ``lax.scan`` becomes :func:`utils.loop.loop`
over the steps (a Python loop when run, one loop op when exported); the
per-step coefficients are f32 scalars computed on the host in the JAX
package's order of f32 operations. Tensors are NCHW.

The denoiser is a backbone called as ``(x, time, condition, generator)``,
time the step t in [0, T) as a float. In training its dropout is live when
a generator is given, and BatchNorm reads its running averages (the JAX
package hands the engines the inference apply; the loss returns no
running-statistics updates). The samplers call it without a generator:
dropout is off and the ensemble members differ only by their noise.

Every random tensor comes from :meth:`GaussianDiffusionEngine.draw`, in the
JAX package's order: the loss draws its noise after t; a sampler draws its
initial noise, then one noise per step that adds any (none at the last).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from dyffusion_tpu_torch.diffusion.schedules import cosine_beta_schedule, linear_beta_schedule
from dyffusion_tpu_torch.models.base import apply_model
from dyffusion_tpu_torch.utils import rng
from dyffusion_tpu_torch.utils.loop import loop
from dyffusion_tpu_torch.utils.loss import mse_loss

Params = Optional[Mapping[str, torch.Tensor]]
f32 = np.float32


def _row(t: torch.Tensor, ndim: int) -> Tuple[int, ...]:
    return (t.shape[0],) + (1,) * (ndim - 1)


class BufferTable:
    """f32 schedule buffers, kept twice: numpy on the host (a sampler's
    per-step scalars) and tensors on the device (per-row gathers in the
    loss). ``coef(name, t, ndim)`` gives a Python float for an int ``t``, a
    (B, 1, 1, 1) gather for a tensor ``t``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}

    def add(self, name: str, values) -> np.ndarray:
        arr = np.ascontiguousarray(np.asarray(values, np.float32))
        self.host[name] = arr
        self.dev[name] = torch.as_tensor(arr, device=self.device)
        return arr

    def coef(self, name: str, t: Union[int, torch.Tensor], ndim: int) -> Union[float, torch.Tensor]:
        if isinstance(t, torch.Tensor):
            return self.dev[name][t.long()].reshape(_row(t, ndim))
        return float(self.host[name][t])


def initial_shape(sample_shape: Sequence[int], condition: torch.Tensor) -> Tuple[int, ...]:
    """The shape of a sampler's initial draw: one sample of ``sample_shape``
    (C, H, W) per row of ``condition``, on the condition's grid, which is
    the sample's (under a shard the rank's slab of it)."""
    return (condition.shape[0],) + tuple(sample_shape[:-2]) + tuple(condition.shape[-2:])


@dataclass(frozen=True)
class GaussianDiffusionConfig:
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None  # < timesteps: DDIM
    objective: str = "pred_noise"  # 'pred_noise' | 'pred_x0'
    beta_schedule: str = "cosine"  # 'linear' | 'cosine'
    ddim_sampling_eta: float = 1.0
    hardcode_betaN: bool = False
    p2_loss_weight_gamma: float = 0.0
    p2_loss_weight_k: float = 1.0
    clip_denoised: bool = False

    def __post_init__(self):
        assert self.objective in ("pred_noise", "pred_x0")


class GaussianDiffusionEngine:
    """DDPM/DDIM over a denoiser module. ``sample_shape`` is (C, H, W) of
    one sample (C: the h stacked frames' channels under the simultaneous
    experiment). ``params`` arguments replace the denoiser's weights for the
    call (``None``: its own). The buffers live on ``device`` (default: the
    denoiser's)."""

    def __init__(
        self,
        config: GaussianDiffusionConfig,
        denoiser: nn.Module,
        sample_shape: Sequence[int],
        criterion: Optional[Callable] = None,
        device: Optional[torch.device] = None,
    ):
        self.cfg = config
        self.denoiser = denoiser
        self.sample_shape = tuple(sample_shape)
        self.criterion = criterion or mse_loss
        device = device if device is not None else next(denoiser.parameters()).device

        T = config.timesteps
        if config.beta_schedule == "linear":
            betas = linear_beta_schedule(T)
        elif config.beta_schedule == "cosine":
            betas = cosine_beta_schedule(T)
        else:
            raise ValueError(f"unknown beta schedule {config.beta_schedule}")
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        self.num_timesteps = T
        self.sampling_timesteps = config.sampling_timesteps or T
        assert self.sampling_timesteps <= T
        self.is_ddim_sampling = self.sampling_timesteps < T

        sqrt_ac = np.sqrt(ac)
        sqrt_1m_ac = np.sqrt(1.0 - ac)
        if config.hardcode_betaN:  # the last step is pure noise
            sqrt_ac[-1] = 0.0
            sqrt_1m_ac[-1] = 1.0
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        self.buffers = b = BufferTable(device)
        b.add("betas", betas)
        b.add("alphas_cumprod", ac)
        b.add("sqrt_alphas_cumprod", sqrt_ac)
        b.add("sqrt_one_minus_alphas_cumprod", sqrt_1m_ac)
        b.add("sqrt_recip_alphas_cumprod", np.sqrt(1.0 / ac))
        b.add("sqrt_recipm1_alphas_cumprod", np.sqrt(1.0 / ac - 1.0))
        b.add("posterior_variance", post_var)
        b.add("posterior_log_variance_clipped", np.log(np.clip(post_var, 1e-20, None)))
        b.add("posterior_mean_coef1", betas * np.sqrt(ac_prev) / (1.0 - ac))
        b.add("posterior_mean_coef2", (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac))
        b.add("p2_loss_weight", (config.p2_loss_weight_k + ac / (1.0 - ac)) ** -config.p2_loss_weight_gamma)
        # exp(0.5 * log variance) of the ancestral step, in f32 as the JAX scan computes it
        lv = b.host["posterior_log_variance_clipped"]
        self._posterior_std = np.exp(f32(0.5) * lv).astype(np.float32)

    def draw(self, shape: Sequence[int], generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
        """A standard-normal f32 tensor: every random tensor of the engine,
        each over the sample's grid (under a shard the rank's slab of the
        global draw, ``utils.rng.spatial_shard``)."""
        return rng.row_randn(shape, generator, device, grid=True)

    def draw_steps(self, n: int, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
        """The loss's per-row steps t ~ U{0..T-1}: the engine's only other random draw."""
        return rng.row_randint(0, self.num_timesteps, n, generator, device)

    # ---- building blocks ----
    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Forward noising q(x_t | x_0) at per-row steps ``t``."""
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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The denoising loss at per-row steps ``t``; the denoiser's dropout
        is live when ``generator`` is given."""
        noise = self.draw(x_start.shape, generator, x_start.device).to(x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        preds = apply_model(self.denoiser, params, x_t, t.float(), condition, generator)
        target = noise if self.cfg.objective == "pred_noise" else x_start
        loss = self.criterion(preds, target)
        return loss, {"loss": loss}

    def loss(self, params: Params, generator: Optional[torch.Generator], x_start: torch.Tensor, condition):
        """t ~ U{0..T-1} per row from ``generator``, then :meth:`p_losses`."""
        t = self.draw_steps(x_start.shape[0], generator, x_start.device)
        return self.p_losses(params, generator, x_start, condition, t)

    # ---- sampling ----
    def _init(self, generator, condition) -> torch.Tensor:
        return self.draw(initial_shape(self.sample_shape, condition), generator, condition.device)

    def model_predictions(self, params: Params, img: torch.Tensor, x, condition) -> Tuple[torch.Tensor, torch.Tensor]:
        """(predicted noise, predicted x_0) at one sampler step under either
        objective, the denoiser called without a generator; ``x``: the
        step's values (``t`` and the two ``sqrt_recip*`` coefficients), 0-dim
        CPU tensors."""
        t_in = torch.zeros((img.shape[0],), dtype=torch.float32, device=img.device) + x["t"]
        out = apply_model(self.denoiser, params, img, t_in, condition, None)
        recip, recipm1 = x["sqrt_recip_alphas_cumprod"], x["sqrt_recipm1_alphas_cumprod"]
        if self.cfg.objective == "pred_noise":
            x_start = recip * img - recipm1 * out
            if self.cfg.clip_denoised:
                x_start = torch.clamp(x_start, -1.0, 1.0)
            return out, x_start
        x_start = torch.clamp(out, -1.0, 1.0) if self.cfg.clip_denoised else out
        return (recip * img - x_start) / recipm1, x_start

    def _step_values(self, ts: Sequence[int], names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Per-step f32 CPU vectors: ``t`` and the buffers ``names`` at the steps ``ts``."""
        idx = np.asarray(ts, np.int64)
        out = {"t": torch.from_numpy(idx.astype(np.float32))}
        out.update({n: torch.from_numpy(self.buffers.host[n][idx]) for n in names})
        return out

    def p_sample_loop(self, params: Params, generator: Optional[torch.Generator], condition: torch.Tensor) -> torch.Tensor:
        """The ancestral sampler over all T steps, T-1 down to 0: the steps
        that add noise as one :func:`utils.loop.loop` (one loop op in an
        exported sampler), the noise-free t = 0 peeled after it."""
        img = self._init(generator, condition)
        names = ("sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1", "posterior_mean_coef2")

        def step(carry, x, consts):
            (img,), (params, condition) = carry, consts
            _, x_start = self.model_predictions(params, img, x, condition)
            mean = x["posterior_mean_coef1"] * x_start + x["posterior_mean_coef2"] * img
            return (mean + x["std"] * self.draw(img.shape, generator, img.device),)

        T = self.num_timesteps
        xs = self._step_values(range(T - 1, 0, -1), names)
        xs["std"] = torch.from_numpy(self._posterior_std[T - 1:0:-1].copy())
        (img,) = loop(step, (img,), xs, (params, condition), (self.denoiser,))
        x = {k: v[0] for k, v in self._step_values([0], names).items()}  # no noise at t = 0
        _, x_start = self.model_predictions(params, img, x, condition)
        return x["posterior_mean_coef1"] * x_start + x["posterior_mean_coef2"] * img

    def ddim_steps(self):
        """The DDIM schedule: (t, t_next) pairs, t_next = -1 at the end."""
        times = np.linspace(-1, self.num_timesteps - 1, self.sampling_timesteps + 1).astype(int)
        times = list(reversed(times.tolist()))
        return list(zip(times[:-1], times[1:]))

    def ddim_sample(self, params: Params, generator: Optional[torch.Generator], condition: torch.Tensor) -> torch.Tensor:
        """DDIM with ``ddim_sampling_eta`` over the subsampled schedule: the
        steps to a t_next >= 0 as one :func:`utils.loop.loop`, the last
        (t_next = -1, which returns the predicted x_0) peeled after it."""
        ac = self.buffers.host["alphas_cumprod"]
        eta = f32(self.cfg.ddim_sampling_eta)
        one, zero = f32(1.0), f32(0.0)
        names = ("sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod")
        img = self._init(generator, condition)
        pairs = self.ddim_steps()
        body, (t_last, _) = pairs[:-1], pairs[-1]
        coefs = []
        for t, t_next in body:
            alpha, alpha_next = ac[t], ac[t_next]
            sigma = eta * np.sqrt(np.maximum((one - alpha / alpha_next) * (one - alpha_next) / (one - alpha), zero))
            c = np.sqrt(np.maximum(one - alpha_next - sigma * sigma, zero))
            coefs.append((np.sqrt(alpha_next), c, sigma))

        def step(carry, x, consts):
            (img,), (params, condition) = carry, consts
            pred_noise, x_start = self.model_predictions(params, img, x, condition)
            noise = self.draw(img.shape, generator, img.device)
            return (x_start * x["sqrt_alpha_next"] + x["c"] * pred_noise + x["sigma"] * noise,)

        xs = self._step_values([t for t, _ in body], names)
        for i, k in enumerate(("sqrt_alpha_next", "c", "sigma")):
            xs[k] = torch.tensor([v[i] for v in coefs], dtype=torch.float32)
        if body:
            (img,) = loop(step, (img,), xs, (params, condition), (self.denoiser,))
        x = {k: v[0] for k, v in self._step_values([t_last], names).items()}
        return self.model_predictions(params, img, x, condition)[1]

    def sample(self, params: Params, generator: Optional[torch.Generator], condition: torch.Tensor) -> torch.Tensor:
        """DDPM, or DDIM when ``sampling_timesteps`` < T: (B, C, H, W)."""
        if self.is_ddim_sampling:
            return self.ddim_sample(params, generator, condition)
        return self.p_sample_loop(params, generator, condition)
