"""DYffusion's cold sampler, its two-term training loss and the
Navier-Stokes boundary conditions, in plain PyTorch (float32).

After Cachay et al., "DYffusion: A Dynamics-informed Diffusion Model for
Spatiotemporal Forecasting" (NeurIPS 2023, arXiv:2306.01984), Algorithm 2
and Eq. (4), as the original code (Rose-STL-Lab/dyffusion
``src/diffusion/dyffusion.py``) runs them with the ``before_t1_only``
schedule: N = horizon + k steps; step d maps to the interpolation time
d / (k + 1) for d <= k and to d - k after. The ensemble is folded into the
batch: row m * B + b is member m of input row b. The sampler's forecaster
runs without dropout and its interpolator with (MC dropout), both drawn
from the request's generator in the order of the calls; the interpolator's
two calls of a step run as one batch of 2B rows (i_next rows first).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Net = Callable[..., torch.Tensor]  # net(x, time, condition, g) -> prediction


def i_of(d: float, k: int) -> float:
    return float(d - k) if d >= k + 1 else d / (k + 1)


def i_of_tensor(d: torch.Tensor, k: int) -> torch.Tensor:
    d = d.float()
    return torch.where(d >= k + 1, d - k, d / (k + 1))


def sample(forecaster: Net, interpolator: Net, ic: torch.Tensor, static: Optional[torch.Tensor], *, horizon: int,
           k: int, conditioning: str, refine: bool, channels: int, g: Optional[torch.Generator],
           forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cold sampler over the N = horizon + k schedule, then (with
    ``refine``) each dynamical step re-interpolated from the last forecast.
    ``ic``: (R, C, H, W) the initial condition; returns (R, horizon, C, H, W).

    ``forced`` (R, horizon, C, H, W), the answer under test: after each
    dynamical output the sampler goes on from ``forced``'s frame there, so
    that every later output is one step from the answer's previous one
    (the first output still follows the k auxiliary steps from ``ic``)."""
    N = horizon + k
    R = ic.shape[0]
    dev = ic.device
    x_s = ic[:, -channels:]
    outs = [None] * horizon

    def full(v):
        return torch.full((R,), float(v), dtype=torch.float32, device=dev)

    def fcond():
        base = ic if conditioning == "data" else None
        if static is None:
            return base
        return static if base is None else torch.cat([base, static], dim=1)

    def interp(x_last, times, reps):
        ic_r = ic.repeat(reps, 1, 1, 1)
        st = None if static is None else static.repeat(reps, 1, 1, 1)
        return interpolator(torch.cat([ic_r, x_last], dim=1), times, st, g)

    sched = list(range(N))
    for s, sn in zip(sched[:-1], sched[1:]):
        x0 = forecaster(x_s, i_of_tensor(full(s), k), fcond(), None)
        i_next = i_of(sn, k)
        i_cur = max(i_of(s if s > 0 else 1, k), 1e-6)
        times = torch.cat([full(np.float32(i_next)), full(np.float32(i_cur))])
        pair = interp(torch.cat([x0, x0]), times, 2)
        nxt, cur = pair[:R], pair[R:]
        if s == 0:
            cur = x_s
        x_s = x_s - cur + nxt
        if float(i_next).is_integer():
            outs[int(i_next) - 1] = x_s
            if forced is not None:
                x_s = forced[:, int(i_next) - 1].float()
    x0 = forecaster(x_s, i_of_tensor(full(sched[-1]), k), fcond(), None)
    outs[horizon - 1] = x0
    if refine:
        for i in range(1, N):
            t = i_of(i, k)
            if float(t).is_integer() and t < horizon:
                outs[int(t) - 1] = interp(x0, full(t), 1)
    return torch.stack(outs, dim=1)


def ns_boundary(preds: torch.Tensor, batch: Dict[str, torch.Tensor], lead: int) -> torch.Tensor:
    """The Navier-Stokes boundary conditions on predictions (..., B, H, W, C)
    of the frame ``lead`` steps after the window: the fixed (obstacle and
    wall) cells are 0, and row 0 of channel 0 is the inflow profile
    4 v y (0.41 - y) / 0.41^2 (1 - exp(-5 t)) at t = t0 + dt * lead."""
    fixed = batch["metadata_fixed_mask"].bool()
    out = torch.where(fixed, torch.zeros((), dtype=preds.dtype, device=preds.device), preds)
    v, vy = batch["metadata_in_velocity"].float(), batch["metadata_vertex_y"].float()
    t = batch["metadata_t0"].float() + batch["metadata_dt"].float() * lead
    inflow = v[:, None] * 4.0 * vy * (0.41 - vy) / (0.41 * 0.41) * (1.0 - torch.exp(-5.0 * t))[:, None]
    out = out.clone()
    out[..., 0, :, 0] = inflow
    return out


def stage2_loss(forecaster: Net, interpolator: Net, x_last: torch.Tensor, cond: torch.Tensor,
                static: Optional[torch.Tensor], t: torch.Tensor, *, horizon: int, k: int, conditioning: str,
                lam1: float, lam2: float, g: Optional[torch.Generator], bn_stats: Optional[dict] = None
                ) -> torch.Tensor:
    """Eq. (4): lam1 |F(x_t, t) - x_h| + lam2 |F(I(F(x_t, t), t + 1), t + 1) - x_h|
    (L1, means), x_t = I(x_0, x_h, i(t)) for t > 0 and the condition at
    t = 0; the second term over the rows with t <= N - 2. Dropout is live
    in both networks; their draws come from ``g`` in the order of the calls.
    The forecaster's first pass is its training pass (``bn_stats``: its
    BatchNorm on the batch's statistics); its second reads the running
    averages."""
    N = horizon + k
    i_min = i_of(1, k) if i_of(1, k) > 0 else 1e-3
    i_max = float(i_of(N - 1, k))
    row = (-1, 1, 1, 1)

    def q_sample(x0, t_q):
        i_t = torch.clamp(i_of_tensor(t_q, k), i_min, i_max)
        x = torch.cat([cond, x0], dim=1)
        return interpolator(x, i_t, static, g)

    def fcond():
        base = cond if conditioning == "data" else None
        if static is None:
            return base
        return static if base is None else torch.cat([base, static], dim=1)

    t = t.float()
    x_int = q_sample(x_last, torch.clamp(t, min=1.0))
    x_t = torch.where((t > 0).reshape(row), x_int, cond)
    pred = forecaster(x_t, i_of_tensor(t, k), fcond(), g, bn_stats)
    loss1 = F.l1_loss(pred, x_last)
    t2 = torch.clamp(t + 1.0, max=float(N - 1))
    x_int2 = q_sample(pred, t2)
    pred2 = forecaster(x_int2, i_of_tensor(t2, k), fcond(), g)
    mask = (t <= N - 2).float().reshape(row)
    err = (pred2 - x_last).abs() * mask
    loss2 = err.sum() / (mask.sum() * float(np.prod(x_last.shape[1:]))).clamp_min(1.0)
    return lam1 * loss1 + lam2 * loss2
