"""The Navier-Stokes backbone 'unet_simple' in plain PyTorch (float32).

After the nn-benchmark UNet that DYffusion's Navier-Stokes experiments use
(Rose-STL-Lab/dyffusion ``src/models/unet_simple.py``): the input and the
condition (inputs first) resampled bilinearly (half-pixel centres, no
antialias) to a fixed working grid, a 1x1 input conv, six stride-2 conv
encoder blocks (conv -> BatchNorm, the last GroupNorm(8) -> FiLM ->
LeakyReLU(0.2) -> dropout) and six decoder blocks (bilinear x2 -> conv ->
BatchNorm -> FiLM -> ReLU -> dropout) with skip concatenations, a k4 s2
transposed-conv readout, and the bilinear resample back to the input grid.
BatchNorm reads its running averages (inference, every sampler call and
the loss's second forecaster pass), or in a training pass the batch's
statistics.

:func:`resample` counts into ``RESAMPLES`` when a list is installed there
(the byte count of ``model.flops_and_bytes``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import nn as rn

Spec = Dict[str, Tuple[Tuple[int, ...], str]]
# (encoder?, dim_in factor, dim_out factor, kernel, padding, BatchNorm?)
_ENC = [(1, 2, 4, 1, True), (2, 2, 4, 1, True), (2, 4, 4, 1, True), (4, 8, 4, 1, True),
        (8, 8, 2, 0, True), (8, 8, 2, 0, False)]
_DEC = [(8, 8, 2, 0), (16, 8, 2, 0), (16, 4, 4, 1), (8, 2, 4, 1), (4, 2, 4, 1), (4, 1, 4, 1)]
# (input + output elements, bytes per element) of each bilinear resample, when a list is installed
RESAMPLES: Optional[List[Tuple[int, int]]] = None


def param_spec(cfg: dict, c_in: int, c_out: int, c_cond: int) -> Spec:
    d = cfg["dim"]
    tdim = d * 2 if cfg.get("with_time_emb", True) else None
    s: Spec = {}

    def conv(name, o, i, k):
        s[name + ".weight"] = ((o, i, k, k), "weight")
        s[name + ".bias"] = ((o,), "zero")

    def norm(name, o, bn):
        s[name + ".weight"] = ((o,), "one")
        s[name + ".bias"] = ((o,), "zero")
        if bn:
            s[name + ".running_mean"] = ((o,), "zero")
            s[name + ".running_var"] = ((o,), "one")
            s[name + ".num_batches_tracked"] = ((), "count")

    def film(name, o):
        if tdim:
            s[name + ".time_mlp.1.weight"] = ((o * 2, tdim), "weight")
            s[name + ".time_mlp.1.bias"] = ((o * 2,), "bias")

    conv("init_conv", d, c_in + c_cond, 1)
    if tdim:
        s["time_emb_mlp.1.weight"] = ((tdim, d), "weight")
        s["time_emb_mlp.1.bias"] = ((tdim,), "bias")
        s["time_emb_mlp.3.weight"] = ((tdim, tdim), "weight")
        s["time_emb_mlp.3.bias"] = ((tdim,), "bias")
    for i, (fi, fo, k, _, bn) in enumerate(_ENC):
        conv(f"input_ops.{i}.ops.0", d * fo, d * fi, k)
        norm(f"input_ops.{i}.ops.1", d * fo, bn)
        film(f"input_ops.{i}", d * fo)
    for i, (fi, fo, k, _) in enumerate(_DEC):
        conv(f"output_ops.{i}.ops.1", d * fo, d * fi, k - 1)
        norm(f"output_ops.{i}.ops.2", d * fo, True)
        film(f"output_ops.{i}", d * fo)
    s["readout.0.weight"] = ((d, c_out, 4, 4), "weight")
    s["readout.0.bias"] = ((c_out,), "zero")
    return s


def resample(num: rn.Numerics, x: torch.Tensor, size) -> torch.Tensor:
    out = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=False)
    if RESAMPLES is not None:
        RESAMPLES.append((x.numel() + out.numel(), 2 if num.low_eps else 4))
    return out


def _batch_norm(P: rn.Params, pre: str, x: torch.Tensor, bn_stats: Optional[dict]) -> torch.Tensor:
    """On the running averages, or with ``bn_stats`` (a training pass) on
    the batch's statistics (biased variance), recording the running
    averages after the step, 0.9 old + 0.1 batch, under ``pre``."""
    if bn_stats is None:
        return rn.batch_norm_eval(P, pre, x)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        bn_stats[pre] = (0.9 * P[pre + ".running_mean"] + 0.1 * mean, 0.9 * P[pre + ".running_var"] + 0.1 * var)
    return F.batch_norm(x, None, None, P[pre + ".weight"], P[pre + ".bias"], True, 0.0, 1e-5)


def forward(num: rn.Numerics, P: rn.Params, cfg: dict, x: torch.Tensor, time: Optional[torch.Tensor],
            condition: Optional[torch.Tensor], g: Optional[torch.Generator], bn_stats: Optional[dict] = None
            ) -> torch.Tensor:
    """``bn_stats``: a dict for a training pass (BatchNorm on the batch's
    statistics, the new running averages recorded there), else None."""
    if condition is not None:
        x = torch.cat([x, condition], dim=1)
    t = rn.time_mlp(num, P, "time_emb_mlp", time, cfg["dim"]) if "time_emb_mlp.1.weight" in P else None
    orig = tuple(x.shape[-2:])
    x = resample(num, x, cfg["upsample_dims"])
    x = rn.dropout(rn.conv2d(num, x, P["init_conv.weight"], P["init_conv.bias"]), cfg.get("input_dropout", 0.0), g)
    p = cfg.get("dropout", 0.0)
    skips = []
    for i, (_, _, k, pad, bn) in enumerate(_ENC):
        pre = f"input_ops.{i}"
        x = rn.conv2d(num, x, P[pre + ".ops.0.weight"], P[pre + ".ops.0.bias"], stride=2, padding=pad)
        x = _batch_norm(P, pre + ".ops.1", x, bn_stats) if bn else rn.group_norm(P, pre + ".ops.1", x, 8)
        x = rn.dropout(F.leaky_relu(rn.film(num, P, pre + ".time_mlp", x, t), 0.2), p, g)
        skips.append(x)
    x = skips.pop()
    for i, (_, _, k, pad) in enumerate(_DEC):
        pre = f"output_ops.{i}"
        x = resample(num, x, (x.shape[-2] * 2, x.shape[-1] * 2))
        x = rn.conv2d(num, x, P[pre + ".ops.1.weight"], P[pre + ".ops.1.bias"], padding=pad)
        x = _batch_norm(P, pre + ".ops.2", x, bn_stats)
        x = rn.dropout(F.relu(rn.film(num, P, pre + ".time_mlp", x, t)), p, g)
        if skips:
            x = torch.cat([x, skips.pop()], dim=1)
    x = rn.conv_transpose2d(num, x, P["readout.0.weight"], P["readout.0.bias"], stride=2, padding=1)
    return resample(num, x, orig)
