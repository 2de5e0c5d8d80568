"""MCVD video-diffusion engine and its DDPM, DDIM and F-PNDM samplers.

Counterpart of ``dyffusion_tpu/diffusion/mcvd.py`` (``get_sigmas`` and
``McvdEngine``):

- the schedules run big-noise to small-noise (MCVD's index convention:
  step 0 is the noisiest); the buffers are computed in numpy f32, as the
  JAX package computes them, because the samplers' 1/(1 - alpha)
  coefficients amplify an f64 cumprod's difference to about 1e-3;
- optional Gamma noise (``k_cum``/``theta_t``) and noise in the condition;
- the noise-prediction loss at per-row steps t;
- the DDPM sampler with ``sampling_timesteps`` subsampling, ``frac_steps``,
  ``just_beta``, ``clip_before`` and the final denoise, which is conditioned
  on the step COUNT n-1, not on the last step's index (as the JAX package
  and its reference do); DDIM; F-PNDM, whose three Runge-Kutta warm-up
  steps and its 4th-order Adams-Bashforth steps are two loops;
- the annealed-Langevin (SMLD) sampler library, which no config reaches:
  :func:`anneal_langevin_dynamics`, its sparse, consistent and sparse
  consistent forms, inpainting and interpolation.

The samplers' steps run through :func:`utils.loop.loop` (a Python loop
when run, one loop op when exported) over f32 scalar coefficients computed
on the host in the JAX package's order of f32 operations. The score network is a
backbone called as ``(x, time, condition, generator)`` with time the step
index as a float; in training its dropout is live when a generator is
given and BatchNorm reads its running averages; the samplers call it
without a generator. Every random tensor comes from
:meth:`McvdEngine.draw`, in the JAX package's order: the loss draws its
noise, then the condition's; a sampler draws its initial sample, then one
noise per step but the last. The Langevin functions draw through their
``draw`` argument (default :func:`normal_draw`), in the order their
docstrings give.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from dyffusion_tpu_torch.diffusion.ddpm import BufferTable, initial_shape
from dyffusion_tpu_torch.models.base import apply_model
from dyffusion_tpu_torch.utils import rng
from dyffusion_tpu_torch.utils.loop import loop
from dyffusion_tpu_torch.utils.loss import mse_loss

Params = Optional[Mapping[str, torch.Tensor]]
f32 = np.float32


def get_sigmas(schedule: str, sigma_begin: float, sigma_end: float, timesteps: int) -> np.ndarray:
    """MCVD's noise schedules: 'geometric', 'linear' or 'cosine' (f64)."""
    T = timesteps
    if schedule == "geometric":
        return np.logspace(np.log10(sigma_begin), np.log10(sigma_end), T)
    if schedule == "linear":
        return np.linspace(sigma_begin, sigma_end, T)
    if schedule == "cosine":
        t = np.linspace(T, 0, T + 1) / T
        s = 0.008
        f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
        return f[:-1] / f[-1]
    raise NotImplementedError(f"sigma schedule {schedule} not supported")


@dataclass(frozen=True)
class McvdConfig:
    version: str = "DDPM"  # 'DDPM' | 'DDIM' | 'FPNDM'
    timesteps: int = 1000
    beta_schedule: str = "linear"
    sigma_begin: float = 0.02
    sigma_end: float = 0.0001
    gamma: bool = False
    noise_in_cond: bool = False
    sampling_timesteps: Optional[int] = None  # subsample the sampler's steps
    frac_steps: Optional[float] = None
    just_beta: bool = False
    sampling_denoise: bool = True
    clip_before: bool = False

    def __post_init__(self):
        assert self.version.upper() in ("DDPM", "DDIM", "FPNDM")


class McvdEngine:
    """MCVD over a score-network module. ``sample_shape`` is (C, H, W) of
    one sample; ``params`` arguments replace the network's weights for the
    call (``None``: its own). The buffers live on ``device`` (default: the
    network's)."""

    def __init__(
        self,
        config: McvdConfig,
        scorenet: nn.Module,
        sample_shape: Sequence[int],
        criterion: Optional[Callable] = None,
        device: Optional[torch.device] = None,
    ):
        self.cfg = config
        self.scorenet = scorenet
        self.sample_shape = tuple(sample_shape)
        self.criterion = criterion or mse_loss
        device = device if device is not None else next(scorenet.parameters()).device

        T = config.timesteps
        if config.beta_schedule == "linear":
            betas = get_sigmas("linear", config.sigma_begin, config.sigma_end, T).astype(np.float32)
            alphas = np.cumprod((1.0 - betas)[::-1])[::-1]
            alphas_prev = np.concatenate([alphas[1:], np.ones(1, np.float32)])
        elif config.beta_schedule == "cosine":
            alphas = get_sigmas("cosine", config.sigma_begin, config.sigma_end, T).astype(np.float32)
            alphas_prev = np.concatenate([alphas[1:], np.ones(1, np.float32)])
            betas = 1.0 - alphas / alphas_prev
        else:
            raise ValueError(f"beta_schedule {config.beta_schedule} not supported")
        self.num_timesteps = len(betas)
        self.buffers = b = BufferTable(device)
        b.add("betas", betas)
        b.add("alphas", alphas)
        b.add("alphas_prev", alphas_prev)
        if config.gamma:
            theta_0 = f32(0.001)
            k = betas / (alphas * theta_0**2)
            b.add("k_cum", np.cumsum(k[::-1])[::-1])
            b.add("theta_t", np.sqrt(alphas) * theta_0)

    def draw(
        self,
        shape: Sequence[int],
        generator: Optional[torch.Generator],
        device: torch.device,
        concentration: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Every random tensor of the engine, each over a grid: standard
        normal (f32), or, with ``concentration`` (a scalar or one per row),
        standard Gamma draws of that shape parameter (scale 1). Both are
        the global batch's in a data-parallel train step
        (``utils.rng.row_shard``) and the rank's slab of the global grid's
        under a shard (``utils.rng.spatial_shard``)."""
        if concentration is None:
            return rng.row_randn(shape, generator, device, grid=True)
        return rng.row_gamma(concentration, shape, generator, device, grid=True)

    def draw_steps(self, n: int, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
        """The loss's per-row steps t ~ U{0..T-1}: the engine's only other random draw."""
        return rng.row_randint(0, self.num_timesteps, n, generator, device)

    # ---- building blocks ----
    def _noise_like(self, shape, t: torch.Tensor, generator, device) -> torch.Tensor:
        """Standard normal noise, or Gamma noise normalized to mean 0 and
        variance 1 at the per-row steps ``t``."""
        if not self.cfg.gamma:
            return self.draw(shape, generator, device)
        c = self.buffers.coef
        return self._gamma_noise(shape, *(c(n, t, len(shape)) for n in ("k_cum", "theta_t", "alphas")),
                                 generator, device)

    def _gamma_noise(self, shape, k, theta, alpha, generator, device) -> torch.Tensor:
        """Gamma noise of concentration ``k`` and scale ``theta``, normalized
        to mean 0 and variance 1 by ``alpha``: device tensors, one value per
        row or one for every row (0-dim)."""
        z = self.draw(shape, generator, device, concentration=k) * theta
        return (z - k * theta) / torch.sqrt(1.0 - alpha)

    def _step_noise(self, shape, x, generator, device) -> torch.Tensor:
        """A sampler step's noise, the step's ``k_cum``, ``theta_t`` and
        ``alphas_t`` (0-dim CPU tensors) made 0-dim device tensors: the
        values and the draw of :meth:`_noise_like` at that step."""
        if not self.cfg.gamma:
            return self.draw(shape, generator, device)
        k, theta, alpha = (torch.zeros((), device=device) + x[n] for n in ("k_cum", "theta_t", "alphas_t"))
        return self._gamma_noise(shape, k, theta, alpha, generator, device)

    def _net(self, params: Params, x, t: Union[float, torch.Tensor], condition, generator=None) -> torch.Tensor:
        t_in = t.float() if isinstance(t, torch.Tensor) else torch.full((x.shape[0],), float(t), device=x.device)
        return apply_model(self.scorenet, params, x, t_in, condition, generator)

    # ---- training ----
    def p_losses(
        self,
        params: Params,
        generator: Optional[torch.Generator],
        x: torch.Tensor,
        condition: Optional[torch.Tensor],
        t: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The noise-prediction loss at per-row steps ``t``."""
        used = self.buffers.coef("alphas", t, x.ndim)
        z = self._noise_like(x.shape, t, generator, x.device)  # f32 whatever x's dtype, as in JAX
        perturbed = torch.sqrt(used) * x + torch.sqrt(1.0 - used) * z
        if self.cfg.noise_in_cond and condition is not None:
            ca = self.buffers.coef("alphas", t, condition.ndim)
            zc = self._noise_like(condition.shape, t, generator, condition.device)
            condition = torch.sqrt(ca) * condition + torch.sqrt(1.0 - ca) * zc
        z_pred = self._net(params, perturbed, t, condition, generator)
        loss = self.criterion(z_pred, z)
        return loss, {"loss": loss}

    def loss(self, params: Params, generator: Optional[torch.Generator], x: torch.Tensor, condition):
        """t ~ U{0..T-1} per row from ``generator``, then :meth:`p_losses`."""
        t = self.draw_steps(x.shape[0], generator, x.device)
        return self.p_losses(params, generator, x, condition, t)

    # ---- sampling ----
    def subsampled_schedule(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(steps, alphas, alphas_prev, betas) after ``sampling_timesteps``
        subsampling (recomputed in f32) and ``frac_steps``."""
        cfg = self.cfg
        h = self.buffers.host
        alphas, alphas_prev, betas = h["alphas"], h["alphas_prev"], h["betas"]
        steps = np.arange(len(betas))
        if cfg.sampling_timesteps is not None and cfg.sampling_timesteps < len(alphas):
            skip = len(alphas) // cfg.sampling_timesteps
            steps = np.arange(0, len(alphas), skip)
            alphas = alphas[steps]
            alphas_prev = np.concatenate([alphas[1:], np.ones(1, np.float32)])
            betas = (f32(1.0) - alphas / alphas_prev).astype(np.float32)
        else:
            alphas, alphas_prev, betas = alphas[steps], alphas_prev[steps], betas[steps]
        if cfg.frac_steps is not None:
            keep = slice(int((1 - cfg.frac_steps) * len(steps)), None)
            steps, alphas, alphas_prev, betas = steps[keep], alphas[keep], alphas_prev[keep], betas[keep]
        return steps, alphas, alphas_prev, betas

    def _init_sample(self, generator, condition) -> torch.Tensor:
        shape = initial_shape(self.sample_shape, condition)
        if self.cfg.gamma:  # shifted to mean 0, not scaled
            k0 = float(self.buffers.host["k_cum"][0])
            th0 = float(self.buffers.host["theta_t"][0])
            conc = torch.full((), k0, dtype=torch.float32, device=condition.device)
            z = self.draw(shape, generator, condition.device, concentration=conc) * th0
            return z - k0 * th0
        return self.draw(shape, generator, condition.device)

    def _x0(self, params: Params, xv: torch.Tensor, x, condition) -> Tuple[torch.Tensor, torch.Tensor]:
        """(score, x_0 estimate) at one DDPM/DDIM step, its values ``x``
        (``t``, ``sqrt_1m_a``, ``sqrt_a``) 0-dim CPU tensors or floats."""
        grad = self._net(params, xv, torch.zeros((xv.shape[0],), device=xv.device) + x["t"], condition)
        x0 = (xv - x["sqrt_1m_a"] * grad) / x["sqrt_a"]
        return grad, torch.clamp(x0, -1.0, 1.0) if self.cfg.clip_before else x0

    def _denoise(self, params: Params, xv: torch.Tensor, alphas: np.ndarray, n: int, condition) -> torch.Tensor:
        """The final denoise, conditioned on the step count n - 1."""
        if not self.cfg.sampling_denoise:
            return xv
        return xv - float(np.sqrt(f32(1.0) - alphas[-1])) * self._net(params, xv, float(n - 1), condition)

    def ddpm_sample(self, params: Params, generator: Optional[torch.Generator], condition: torch.Tensor) -> torch.Tensor:
        """The ancestral MCVD sampler, then the final denoise: the steps
        that add noise as one :func:`utils.loop.loop` (one loop op in an
        exported sampler), the noise-free last step peeled after it."""
        cfg = self.cfg
        steps, alphas, alphas_prev, betas = self.subsampled_schedule()
        n = len(steps)
        one = f32(1.0)
        xs = {
            "t": steps.astype(np.float32),
            "sqrt_1m_a": np.sqrt(one - alphas),
            "sqrt_a": np.sqrt(alphas),
            "c0": np.sqrt(alphas_prev) * betas / (one - alphas),
            "c1": np.sqrt(one - betas) * (one - alphas_prev) / (one - alphas),
            "sigma": np.sqrt(betas) if cfg.just_beta else np.sqrt((one - alphas_prev) / (one - alphas) * betas),
        }
        if cfg.gamma:  # the noise's coefficients at the step's index into the full schedule
            h = self.buffers.host
            xs.update(k_cum=h["k_cum"][steps], theta_t=h["theta_t"][steps], alphas_t=h["alphas"][steps])
        xs = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in xs.items()}

        def mean(params, xv, x, condition):
            _, x0 = self._x0(params, xv, x, condition)
            return x["c0"] * x0 + x["c1"] * xv

        def step(carry, x, consts):
            (xv,), (params, condition) = carry, consts
            new = mean(params, xv, x, condition)
            return (new + x["sigma"] * self._step_noise(xv.shape, x, generator, xv.device),)

        x = self._init_sample(generator, condition)
        (x,) = loop(step, (x,), {k: v[:-1] for k, v in xs.items()}, (params, condition), (self.scorenet,))
        x = mean(params, x, {k: v[-1] for k, v in xs.items()}, condition)  # no noise at the last step
        return self._denoise(params, x, alphas, n, condition)

    def ddim_sample(self, params: Params, generator: Optional[torch.Generator], condition: torch.Tensor) -> torch.Tensor:
        """The MCVD DDIM sampler, its steps one :func:`utils.loop.loop`,
        then the final denoise (conditioned on the step count - 1, as in
        :meth:`ddpm_sample`)."""
        steps, alphas, alphas_prev, _ = self.subsampled_schedule()
        one = f32(1.0)
        xs = {"t": steps.astype(np.float32), "sqrt_1m_a": np.sqrt(one - alphas), "sqrt_a": np.sqrt(alphas),
              "sqrt_a_prev": np.sqrt(alphas_prev), "sqrt_1m_a_prev": np.sqrt(one - alphas_prev)}

        def step(carry, x, consts):
            (xv,), (params, condition) = carry, consts
            grad, x0 = self._x0(params, xv, x, condition)
            return (x["sqrt_a_prev"] * x0 + x["sqrt_1m_a_prev"] * grad,)

        x = self._init_sample(generator, condition)
        xs = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in xs.items()}
        (x,) = loop(step, (x,), xs, (params, condition), (self.scorenet,))
        return self._denoise(params, x, alphas, len(steps), condition)

    def fpndm_steps(self) -> List[Tuple[float, float]]:
        """F-PNDM's (t, t_next) pairs."""
        sub = self.cfg.sampling_timesteps or self.num_timesteps
        skip = max(self.num_timesteps // sub, 1)
        steps = list(range(0, self.num_timesteps, skip))
        return list(zip(steps, [-1] + steps[:-1]))

    def fpndm_sample(self, params: Params, generator: Optional[torch.Generator], condition: torch.Tensor) -> torch.Tensor:
        """F-PNDM: Runge-Kutta for the first three steps, then 4th-order
        Adams-Bashforth on the noise history. The two kinds of step are two
        :func:`utils.loop.loop` s (each one loop op in an exported sampler,
        as the JAX scan's ``lax.cond`` has both branches), both carrying the
        sample and the last three noise estimates (zeros before the first)."""
        cfg = self.cfg
        # alphas indexed by t + 1 over the small-to-big order
        alphas_old = np.ascontiguousarray(self.buffers.host["alphas"][::-1])
        one = f32(1.0)
        last = len(alphas_old) - 1

        def coefs(t, t_next):
            # t truncates toward zero BEFORE the + 1 (a midpoint t = -0.5 reads
            # index 1); t = T-1 reads past the end, which JAX's gather clamps
            at, at_next = alphas_old[min(int(t) + 1, last)], alphas_old[min(int(t_next) + 1, last)]
            sa, sn = np.sqrt(at), np.sqrt(at_next)
            cx = one / (sa * (sa + sn))
            ce = one / (sa * (np.sqrt((one - at_next) * at) + np.sqrt((one - at) * at_next)))
            return at_next - at, cx, ce

        def transfer(xv, x, to, et):
            out = xv + x["d_" + to] * (x["cx_" + to] * xv - x["ce_" + to] * et)
            return torch.clamp(out, -1.0, 1.0) if cfg.clip_before else out

        def values(pairs, mid: bool):
            rows = []
            for t, t_next in pairs:
                t_mid = (t + t_next) / f32(2.0)
                rows.append([t, t_mid, t_next, *coefs(t, t_next), *(coefs(t, t_mid) if mid else ())])
            keys = ["t", "t_mid", "t_next", "d_next", "cx_next", "ce_next"] + (["d_mid", "cx_mid", "ce_mid"] if mid else [])
            table = np.asarray(rows, np.float32).reshape(len(rows), len(keys))
            return {k: torch.from_numpy(np.ascontiguousarray(table[:, i])) for i, k in enumerate(keys)}

        def net(params, xv, t, condition):
            return self._net(params, xv, torch.zeros((xv.shape[0],), device=xv.device) + t, condition)

        def runge_kutta(carry, x, consts):
            (xv, _, e2, e3), (params, condition) = carry, consts
            e1 = net(params, xv, x["t"], condition)
            k2 = net(params, transfer(xv, x, "mid", e1), x["t_mid"], condition)
            k3 = net(params, transfer(xv, x, "mid", k2), x["t_mid"], condition)
            k4 = net(params, transfer(xv, x, "next", k3), x["t_next"], condition)
            return transfer(xv, x, "next", (e1 + 2 * k2 + 2 * k3 + k4) / 6.0), e2, e3, e1

        def adams_bashforth(carry, x, consts):
            (xv, e1, e2, e3), (params, condition) = carry, consts
            e_new = net(params, xv, x["t"], condition)
            et = (55 * e_new - 59 * e3 + 37 * e2 - 9 * e1) / 24.0
            return transfer(xv, x, "next", et), e2, e3, e_new

        pairs = [(f32(t), f32(t_next)) for t, t_next in self.fpndm_steps()]
        x = self._init_sample(generator, condition)
        zero = torch.zeros_like(x)
        carry, consts = (x, zero, zero, zero), (params, condition)
        carry = loop(runge_kutta, carry, values(pairs[:3], True), consts, (self.scorenet,))
        if len(pairs) > 3:
            carry = loop(adams_bashforth, carry, values(pairs[3:], False), consts, (self.scorenet,))
        return carry[0]

    def sample(self, params: Params, generator: Optional[torch.Generator], condition: torch.Tensor) -> torch.Tensor:
        """The configured sampler: (B, C, H, W)."""
        v = self.cfg.version.upper()
        if v == "DDPM":
            return self.ddpm_sample(params, generator, condition)
        if v == "DDIM":
            return self.ddim_sample(params, generator, condition)
        return self.fpndm_sample(params, generator, condition)


# ---------------------------------------------------------------------------
# annealed Langevin dynamics (SMLD)
# ---------------------------------------------------------------------------
Draw = Callable[[Sequence[int], Optional[torch.Generator], torch.device], torch.Tensor]


def normal_draw(shape: Sequence[int], generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """The Langevin functions' default draw: standard normal f32 over a
    grid (under a shard the rank's slab of the global draw)."""
    return rng.grid_randn(shape, generator, device)


def _score(scorenet: nn.Module, params: Params, x: torch.Tensor, t, condition) -> torch.Tensor:
    """The score network at per-row conditioning ``t`` (a level index or
    a sigma, as f32)."""
    t_b = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
    return apply_model(scorenet, params, x, t_b, condition)


def _step_sizes(sigmas: np.ndarray, step_lr: float) -> Tuple[np.ndarray, np.ndarray]:
    """Per level: ``step_lr * (sigma / sigma_last)**2`` and its
    ``sqrt(2 * step)``, in f32 as the JAX package computes them."""
    sig = np.asarray(sigmas, np.float32)
    step = (f32(step_lr) * (sig / sig[-1]) ** 2).astype(np.float32)
    return step, np.sqrt(f32(2.0) * step)


def _draw(draw: Optional[Draw], shape, generator, device) -> torch.Tensor:
    return (draw or normal_draw)(tuple(shape), generator, device).to(device)


def anneal_langevin_dynamics(
    scorenet: nn.Module,
    params: Params,
    generator: Optional[torch.Generator],
    x_init: torch.Tensor,
    condition: Optional[torch.Tensor],
    sigmas,
    n_steps_each: int = 1,
    step_lr: float = 2e-5,
    denoise: bool = True,
    draw: Optional[Draw] = None,
) -> torch.Tensor:
    """Annealed Langevin dynamics: per level c and step,
    ``x += step * score + sqrt(2 step) * noise`` with ``score = -z / sigma_c``
    (the network predicts z, conditioned on the level index c); then the
    denoise ``x += sigma_last**2 * score``. Draws: one noise like x per step."""
    sig = np.asarray(sigmas, np.float32)
    steps, noise_scales = _step_sizes(sig, step_lr)
    x = x_init
    for c in range(len(sig)):
        for _ in range(n_steps_each):
            grad = -_score(scorenet, params, x, c, condition) / float(sig[c])
            noise = _draw(draw, x.shape, generator, x.device)
            x = x + float(steps[c]) * grad + float(noise_scales[c]) * noise
    if denoise:
        grad = -_score(scorenet, params, x, len(sig) - 1, condition) / float(sig[-1])
        x = x + float(sig[-1] ** 2) * grad
    return x


def sparse_anneal_langevin_dynamics(
    scorenet: nn.Module,
    params: Params,
    generator: Optional[torch.Generator],
    x_init: torch.Tensor,
    sparsity: torch.Tensor,
    condition: Optional[torch.Tensor],
    sigmas,
    n_steps_each: int = 1,
    step_lr: float = 8e-6,
    denoise: bool = True,
    frac_steps: Optional[float] = None,
    draw: Optional[Draw] = None,
) -> torch.Tensor:
    """Sparse annealed Langevin: a dense chain x drives the network
    (``x -= step / sigma * z``); the sparse chain takes ``z / sparsity``
    and ``sparsity * noise``; ``frac_steps`` keeps the last fraction of the
    levels; the denoise is ``x_sparse -= sigma_last * sparsity * z(x)``.
    Returns the sparse chain. Draws: one noise like x per step."""
    sig64 = np.asarray(sigmas, np.float64)
    if frac_steps is not None:
        sig64 = sig64[int((1 - frac_steps) * len(sig64)):]
    sig = sig64.astype(np.float32)
    steps, noise_scales = _step_sizes(sig, step_lr)
    sparsity = sparsity.float()
    x, x_sparse = x_init, x_init
    for c in range(len(sig)):
        k = float(steps[c] / sig[c])
        for _ in range(n_steps_each):
            grad = _score(scorenet, params, x, c, condition)
            noise = _draw(draw, x.shape, generator, x.device)
            x = x - k * grad + float(noise_scales[c]) * noise
            x_sparse = x_sparse - k * (grad / sparsity) + float(noise_scales[c]) * (sparsity * noise)
    if denoise:
        x_sparse = x_sparse - float(sig[-1]) * sparsity * _score(scorenet, params, x, len(sig) - 1, condition)
    return x_sparse


def _consistent_ladder(sigmas, n_steps_each: int, step_lr: float):
    """Consistent annealed sampling's geometric ladder of (L-1) * n_steps + 1
    levels: per level (sigma_c, sigma_next, beta) in f32, and eta; checks
    that ``step_lr`` lies in the range the method needs."""
    sig64 = np.asarray(sigmas, np.float64)
    L = len(sig64)
    ladder = np.geomspace(sig64[0], sig64[-1], (L - 1) * n_steps_each + 1)
    smallest_invgamma = ladder[-1] / ladder[-2]
    lowerbound = sig64[-1] ** 2 * (1 - smallest_invgamma)
    higherbound = sig64[-1] ** 2 * (1 + smallest_invgamma)
    assert lowerbound < step_lr < higherbound, (
        f"consistent sampling needs {lowerbound} < step_lr < {higherbound}, got {step_lr}"
    )
    eta = step_lr / float(sig64[-1] ** 2)
    sig_next = np.concatenate([ladder[1:], [ladder[-1]]])
    beta = np.sqrt(np.clip(1.0 - (ladder / sig_next * (1.0 - eta)) ** 2, 0.0, None))
    c32 = lambda a: np.asarray(a, np.float32)
    return c32(ladder), c32(sig_next), c32(beta), eta, float(sig64[-1]), L


def anneal_langevin_dynamics_consistent(
    scorenet: nn.Module,
    params: Params,
    generator: Optional[torch.Generator],
    x_init: torch.Tensor,
    condition: Optional[torch.Tensor],
    sigmas,
    n_steps_each: int = 1,
    step_lr: float = 8e-6,
    denoise: bool = True,
    draw: Optional[Draw] = None,
) -> torch.Tensor:
    """Consistent annealed sampling: per ladder level
    ``x -= eta * sigma_c * z(x, sigma_c)`` (the network conditioned on the
    continuous sigma), then ``x += beta * sigma_next * noise`` but at the
    last level; the denoise ``x -= sigma_last * z`` is conditioned on the
    level index L-1. Draws: one noise like x per level but the last."""
    ladder, sig_next, beta, eta, sig_last, L = _consistent_ladder(sigmas, n_steps_each, step_lr)
    x = x_init
    n = len(ladder)
    for i in range(n):
        grad = _score(scorenet, params, x, ladder[i], condition)
        x = x - float(f32(eta) * ladder[i]) * grad
        if i + 1 < n:
            x = x + float(beta[i] * sig_next[i]) * _draw(draw, x.shape, generator, x.device)
    if denoise:
        x = x - sig_last * _score(scorenet, params, x, L - 1, condition)
    return x


def sparse_anneal_langevin_dynamics_consistent(
    scorenet: nn.Module,
    params: Params,
    generator: Optional[torch.Generator],
    x_init: torch.Tensor,
    sparsity: torch.Tensor,
    condition: Optional[torch.Tensor],
    sigmas,
    n_steps_each: int = 1,
    step_lr: float = 8e-6,
    denoise: bool = True,
    draw: Optional[Draw] = None,
) -> torch.Tensor:
    """The sparse form of consistent sampling, as the JAX package and its
    reference define it: the dense chain takes ``x += eta * sigma_c**2 * z
    + beta * sigma_next * noise``; the sparse chain only
    ``beta * sigma_next * sparsity * noise``; the denoise runs the network
    twice, ``x_den = x + sigma_last * z(x)`` and then
    ``x_sparse += sigma_last / sparsity * z(x_den)``. Returns the sparse
    chain. Draws: one noise like x per level but the last."""
    ladder, sig_next, beta, eta, sig_last, L = _consistent_ladder(sigmas, n_steps_each, step_lr)
    sparsity = sparsity.float()
    x, x_sparse = x_init, x_init
    n = len(ladder)
    for i in range(n):
        grad = _score(scorenet, params, x, ladder[i], condition)
        x = x + float(f32(eta) * ladder[i] ** 2) * grad
        if i + 1 < n:
            noise = _draw(draw, x.shape, generator, x.device)
            b = float(sig_next[i] * beta[i])
            x = x + b * noise
            x_sparse = x_sparse + b * (sparsity * noise)
    if denoise:
        x_den = x + sig_last * _score(scorenet, params, x, L - 1, condition)
        x_sparse = x_sparse + sig_last / sparsity * _score(scorenet, params, x_den, L - 1, condition)
    return x_sparse


def anneal_langevin_dynamics_inpainting(
    scorenet: nn.Module,
    params: Params,
    generator: Optional[torch.Generator],
    x_init: torch.Tensor,
    refer_image: torch.Tensor,
    known_mask: torch.Tensor,
    condition: Optional[torch.Tensor],
    sigmas,
    n_steps_each: int = 1,
    step_lr: float = 8e-6,
    draw: Optional[Draw] = None,
) -> torch.Tensor:
    """Langevin inpainting: per step the known region (``known_mask`` 1) is
    replaced by ``refer_image`` re-noised to the level's sigma, then
    ``x += step * z + sqrt(2 step) * noise`` (the network output used as the
    score). Draws per step: the re-noising like ``refer_image``, then the
    noise like x."""
    sig = np.asarray(sigmas, np.float32)
    steps, noise_scales = _step_sizes(sig, step_lr)
    known_mask = known_mask.to(x_init.dtype)
    x = x_init
    for c in range(len(sig)):
        for _ in range(n_steps_each):
            corrupted = refer_image + _draw(draw, refer_image.shape, generator, x.device) * float(sig[c])
            x = known_mask * corrupted + (1.0 - known_mask) * x
            grad = _score(scorenet, params, x, c, condition)
            noise = _draw(draw, x.shape, generator, x.device) * float(noise_scales[c])
            x = x + float(steps[c]) * grad + noise
    return x


def anneal_langevin_dynamics_interpolation(
    scorenet: nn.Module,
    params: Params,
    generator: Optional[torch.Generator],
    x_init: torch.Tensor,
    n_interpolations: int,
    condition: Optional[torch.Tensor],
    sigmas,
    n_steps_each: int = 1,
    step_lr: float = 8e-6,
    draw: Optional[Draw] = None,
) -> torch.Tensor:
    """Langevin interpolation: each row runs ``n_interpolations`` chains
    whose noise per step is ``cos(a) * noise_p + sin(a) * noise_q`` for
    angles a from 0 to pi/2, two draws shared by a row's chains. The
    condition must hold B * n_interpolations rows. Returns
    (B * n_interpolations, ...), the chains of a row adjacent. Draws per
    step: noise_p, then noise_q, each like ``x_init``."""
    sig = np.asarray(sigmas, np.float32)
    steps, noise_scales = _step_sizes(sig, step_lr)
    x = torch.repeat_interleave(x_init, n_interpolations, dim=0)
    angles = torch.linspace(0.0, np.pi / 2.0, n_interpolations, dtype=torch.float32, device=x.device)
    shape = (1, n_interpolations) + (1,) * (x_init.dim() - 1)
    cos_a, sin_a = torch.cos(angles).reshape(shape), torch.sin(angles).reshape(shape)
    for c in range(len(sig)):
        for _ in range(n_steps_each):
            noise_p = _draw(draw, x_init.shape, generator, x.device)[:, None]
            noise_q = _draw(draw, x_init.shape, generator, x.device)[:, None]
            noise = (noise_p * cos_a + noise_q * sin_a).reshape(x.shape)
            grad = _score(scorenet, params, x, c, condition)
            x = x + float(steps[c]) * grad + noise * float(noise_scales[c])
    return x
