"""Beta schedules of the Gaussian-diffusion baselines (a numpy copy of
``dyffusion_tpu/diffusion/schedules.py``): linear, cosine, and the LDM-style
factory with sqrt_linear and sqrt, computed in f64 numpy; the engines cast
their buffers to f32.
"""
from __future__ import annotations

import math

import numpy as np


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """The scaled-linear schedule: 1e-4 to 0.02 at 1000 steps, scaled by
    1000 / timesteps (the end capped at 1)."""
    scale = 1000.0 / timesteps
    beta_start = scale * 0.0001
    beta_end = min(scale * 0.02, 1.0)
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal's cosine schedule, betas clipped to [0, 0.999]."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """The LDM schedule factory: 'linear' (linear in sqrt(beta)), 'cosine',
    'sqrt_linear' (linear in beta) or 'sqrt'."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = timesteps / (1 + cosine_s) * np.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0.0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return np.asarray(betas, dtype=np.float64)
