"""The DYffusion 'unet_resnet' backbone in plain PyTorch (float32).

After the original reference (Rose-STL-Lab/dyffusion ``src/models/unet.py``,
itself lucidrains' denoising-diffusion UNet): weight-standardized 3x3 convs
with GroupNorm(8), FiLM from a sinusoidal time MLP, SiLU and dropout in
each ResNet block; per level two ResNet blocks and a pre-norm linear
attention ('qkv' rescale: q softmaxed over its channels and scaled, k over
the tokens, v / N); full softmax attention at the mid-block; stride-2 4x4
downsampling and nearest x2 + 3x3 conv upsampling; the condition
concatenated in front of the input. The linear attention is written out
here (B1's math), not called from the system under test.

:func:`param_spec` lists every weight with its shape and how the benchmark
draws it; :func:`forward` takes the flat state dict.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import nn as rn

Spec = Dict[str, Tuple[Tuple[int, ...], str]]
# (B, N, bytes per element) of each linear attention, when a list is installed
LINEAR_ATTENTION_CALLS: Optional[List[Tuple[int, int, int]]] = None


def _sizes(cfg: dict) -> Tuple[int, List[Tuple[int, int]], int]:
    dim = cfg["dim"]
    init_dim = cfg.get("init_dim") or dim
    dims = [init_dim] + [dim * m for m in cfg["dim_mults"]]
    return init_dim, list(zip(dims[:-1], dims[1:])), dims[-1]


def param_spec(cfg: dict, c_in: int, c_out: int, c_cond: int) -> Spec:
    """{name: (shape, kind)}; kind is 'weight' (fan-in scaled), 'bias',
    'one' or 'zero'. ``cfg``: dim, dim_mults, with_time_emb, heads,
    dim_head, init_kernel_size."""
    dim, heads, dh = cfg["dim"], cfg.get("attn_heads", 4), cfg.get("attn_dim_head", 32)
    hidden = heads * dh
    init_dim, in_out, mid = _sizes(cfg)
    tdim = dim * 2 if cfg.get("with_time_emb", True) else None
    k0 = cfg.get("init_kernel_size", 7)
    s: Spec = {}

    def conv(name, o, i, k, bias=True):
        s[name + ".weight"] = ((o, i, k, k), "weight")
        if bias:
            s[name + ".bias"] = ((o,), "bias")

    def lin(name, o, i):
        s[name + ".weight"] = ((o, i), "weight")
        s[name + ".bias"] = ((o,), "bias")

    def res(name, d_in, d_out):
        if tdim:
            lin(name + ".mlp.1", d_out * 2, tdim)
        for blk, di in (("block1", d_in), ("block2", d_out)):
            conv(f"{name}.{blk}.proj", d_out, di, 3)
            s[f"{name}.{blk}.norm.weight"] = ((d_out,), "one")
            s[f"{name}.{blk}.norm.bias"] = ((d_out,), "zero")
        if d_in != d_out:
            conv(name + ".residual_conv", d_out, d_in, 1)

    def attn(name, d, qkv_name):
        s[name + ".fn.norm.g"] = ((1, d, 1, 1), "one")
        conv(f"{name}.fn.fn.{qkv_name}", hidden * 3, d, 1, bias=False)
        conv(name + ".fn.fn.to_out", d, hidden, 1)

    conv("init_conv", init_dim, c_in + c_cond, k0)
    if tdim:
        lin("time_emb_mlp.1", tdim, dim)
        lin("time_emb_mlp.3", tdim, tdim)
    n = len(in_out)
    for i, (di, do) in enumerate(in_out):
        res(f"downs.{i}.0", di, di)
        res(f"downs.{i}.1", di, di)
        attn(f"downs.{i}.2", di, "to_qkv.1")
        conv(f"downs.{i}.3", do, di, 4 if i < n - 1 else 3)
    res("mid_block1", mid, mid)
    attn("mid_attn", mid, "to_qkv")
    res("mid_block2", mid, mid)
    for i, (di, do) in enumerate(reversed(in_out)):
        res(f"ups.{i}.0", do + di, do)
        res(f"ups.{i}.1", do + di, do)
        attn(f"ups.{i}.2", do, "to_qkv.1")
        conv(f"ups.{i}.3.1" if i < n - 1 else f"ups.{i}.3", di, do, 3)
    res("final_res_block", init_dim * 2, dim)
    conv("final_conv", c_out, dim, 1)
    return s


def resnet_block(num, P, pre, x, t, cfg, g):
    h = rn.group_norm(P, pre + ".block1.norm", rn.ws_conv(num, P, pre + ".block1.proj", x), 8)
    h = rn.film(num, P, pre + ".mlp", h, t)
    h = rn.dropout(F.silu(h), cfg.get("block_dropout1", 0.0), g)
    h = rn.group_norm(P, pre + ".block2.norm", rn.ws_conv(num, P, pre + ".block2.proj", h), 8)
    h = rn.dropout(F.silu(h), cfg.get("block_dropout", 0.0), g)
    if pre + ".residual_conv.weight" in P:
        x = rn.conv2d(num, x, P[pre + ".residual_conv.weight"], P[pre + ".residual_conv.bias"])
    return h + x


def linear_attention(num, P, pre, x, cfg, g):
    """x + LinearAttention(ChannelLayerNorm(x)), dropout on the normed input."""
    heads, dh = cfg.get("attn_heads", 4), cfg.get("attn_dim_head", 32)
    B, C, H, W = x.shape
    N = H * W
    if LINEAR_ATTENTION_CALLS is not None:
        LINEAR_ATTENTION_CALLS.append((B, N, 2 if num.low_eps else 4))
    h = rn.channel_layer_norm(num, P[pre + ".fn.norm.g"], x)
    h = rn.dropout(h, cfg.get("attn_dropout", 0.0), g)
    qkv = rn.conv2d(num, h, P[pre + ".fn.fn.to_qkv.1.weight"])
    q, k, v = qkv.reshape(B, 3, heads, dh, N).unbind(1)  # (B, h, d, N)
    q = torch.softmax(q, dim=2) * dh**-0.5
    k = torch.softmax(k, dim=3)
    v = v / N
    context = rn.einsum(num, "bhdn,bhen->bhde", k, v)
    out = rn.einsum(num, "bhde,bhdn->bhen", context, q)
    out = rn.conv2d(num, out.reshape(B, heads * dh, H, W), P[pre + ".fn.fn.to_out.weight"],
                    P[pre + ".fn.fn.to_out.bias"])
    return out + x


def attention(num, P, pre, x, cfg, g):
    """x + softmax attention of ChannelLayerNorm(x), dropout on the
    attention matrix."""
    heads, dh = cfg.get("attn_heads", 4), cfg.get("attn_dim_head", 32)
    B, C, H, W = x.shape
    h = rn.channel_layer_norm(num, P[pre + ".fn.norm.g"], x)
    q, k, v = rn.conv2d(num, h, P[pre + ".fn.fn.to_qkv.weight"]).reshape(B, 3, heads, dh, H * W).unbind(1)
    sim = rn.einsum(num, "bhdi,bhdj->bhij", q * dh**-0.5, k)
    a = rn.dropout(torch.softmax(sim, dim=-1), cfg.get("attn_dropout", 0.0), g)
    out = rn.einsum(num, "bhij,bhdj->bhdi", a, v)
    out = rn.conv2d(num, out.reshape(B, heads * dh, H, W), P[pre + ".fn.fn.to_out.weight"],
                    P[pre + ".fn.fn.to_out.bias"])
    return out + x


def forward(num: rn.Numerics, P: rn.Params, cfg: dict, x: torch.Tensor, time: Optional[torch.Tensor],
            condition: Optional[torch.Tensor], g: Optional[torch.Generator], bn_stats: Optional[dict] = None
            ) -> torch.Tensor:
    """The backbone on NCHW ``x``; ``condition`` goes in front of ``x``;
    ``g`` drives every dropout site (None: deterministic). It has no
    BatchNorm: ``bn_stats`` is not read."""
    _, in_out, _ = _sizes(cfg)
    n = len(in_out)
    if condition is not None:
        x = torch.cat([condition, x], dim=1)
    x = rn.conv2d(num, x, P["init_conv.weight"], P["init_conv.bias"], padding=P["init_conv.weight"].shape[-1] // 2)
    p_in = cfg.get("input_dropout", 0.0)
    r = rn.dropout(x, p_in, g)
    x = rn.dropout(x, p_in, g)
    t = rn.time_mlp(num, P, "time_emb_mlp", time, cfg["dim"]) if "time_emb_mlp.1.weight" in P else None
    hs = []
    for i in range(n):
        x = resnet_block(num, P, f"downs.{i}.0", x, t, cfg, g)
        hs.append(x)
        x = resnet_block(num, P, f"downs.{i}.1", x, t, cfg, g)
        x = linear_attention(num, P, f"downs.{i}.2", x, cfg, g)
        hs.append(x)
        w, b = P[f"downs.{i}.3.weight"], P[f"downs.{i}.3.bias"]
        x = rn.conv2d(num, x, w, b, stride=2, padding=1) if i < n - 1 else rn.conv2d(num, x, w, b, padding=1)
    x = resnet_block(num, P, "mid_block1", x, t, cfg, g)
    x = attention(num, P, "mid_attn", x, cfg, g)
    x = resnet_block(num, P, "mid_block2", x, t, cfg, g)
    for i in range(n):
        x = resnet_block(num, P, f"ups.{i}.0", torch.cat([x, hs.pop()], dim=1), t, cfg, g)
        x = resnet_block(num, P, f"ups.{i}.1", torch.cat([x, hs.pop()], dim=1), t, cfg, g)
        x = linear_attention(num, P, f"ups.{i}.2", x, cfg, g)
        if i < n - 1:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = rn.conv2d(num, x, P[f"ups.{i}.3.1.weight"], P[f"ups.{i}.3.1.bias"], padding=1)
        else:
            x = rn.conv2d(num, x, P[f"ups.{i}.3.weight"], P[f"ups.{i}.3.bias"], padding=1)
    x = resnet_block(num, P, "final_res_block", torch.cat([x, r], dim=1), t, cfg, g)
    return rn.conv2d(num, x, P["final_conv.weight"], P["final_conv.bias"])
