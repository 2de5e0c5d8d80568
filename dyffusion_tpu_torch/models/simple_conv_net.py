"""SimpleConvNet ('cnn_simple'), the spring-mesh backbone, in NCHW.

Counterpart of ``dyffusion_tpu/models/simple_conv_net.py``: k stacked conv
blocks (conv -> norm -> FiLM -> exact-erf GELU -> dropout -> residual) and
a 1x1 head, with the original reference's state-dict keys (``convs.{i}.
conv``, ``convs.{i}.norm``, ``convs.{i}.time_mlp.1``, ``head``,
``time_emb_mlp``). BatchNorm reads its running averages unless the call
passes ``batch_stats`` (see :mod:`dyffusion_tpu_torch.models.base`);
dropout follows the generator, so MC-dropout leaves BatchNorm in eval.

Inside ``parallel.spatial.sharded`` each block runs on this rank's slab of
the grid (``level``; ``None`` on one device): the "same" convs through
``spatial.conv2d`` (halos of (k - 1) / 2 rows), BatchNorm on the whole
world's batch statistics (``models/base.py``), GroupNorm and InstanceNorm
on moments summed over the model group, dropout on the slab of the global
mask; LayerNorm (per pixel), FiLM, GELU, the residual and the 1x1 head
stay local.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dyffusion_tpu_torch.models.modules import PromotingLinear, TimeEmbedder, dropout
from dyffusion_tpu_torch.models.base import BatchNorm2d, norm_call
from dyffusion_tpu_torch.parallel import spatial


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of each pixel (flax ``nn.LayerNorm`` on
    channels-last data), eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.movedim(1, -1), (x.shape[1],), self.weight, self.bias, self.eps)
        return y.movedim(-1, 1)


def get_norm(name: Optional[str], dim: int, num_groups: Optional[int] = None) -> nn.Module:
    """Normalization factory (eps 1e-5 throughout, the torch default):
    ``batch_norm``, ``layer_norm``, ``group*`` (``num_groups``, else the
    largest dim // n for n in 2..16 that divides dim), ``instance*`` (one
    group per channel) or ``none``."""
    name = (name or "none").lower()
    if name == "none":
        return nn.Identity()
    if name == "batch_norm":
        return BatchNorm2d(dim)
    if name == "layer_norm":
        return ChannelLayerNorm(dim)
    if "group" in name:
        groups = num_groups or max((dim // n for n in range(2, 17) if dim % n == 0), default=None)
        if groups is None:
            raise ValueError(f"group norm cannot infer groups for dim={dim}")
        return nn.GroupNorm(groups, dim, eps=1e-5)
    if "instance" in name:
        return nn.GroupNorm(dim, dim, eps=1e-5)
    raise ValueError(f"Unknown normalization: {name}")


class ConvBlock(nn.Module):
    """conv -> norm -> FiLM -> GELU -> dropout -> (+ residual)."""

    def __init__(
        self,
        dim_in: int,
        dim_out: int,
        kernel_size: int = 3,
        net_normalization: str = "batch_norm",
        residual: bool = True,
        dropout: float = 0.0,
        time_emb_dim: Optional[int] = None,
    ):
        super().__init__()
        self.conv = nn.Conv2d(dim_in, dim_out, kernel_size, padding=(kernel_size - 1) // 2)
        self.norm = get_norm(net_normalization, dim_out, num_groups=32)
        self.time_mlp = nn.Sequential(nn.SiLU(), PromotingLinear(time_emb_dim, dim_out * 2)) if time_emb_dim else None
        self.residual = residual
        self.dropout = float(dropout)

    def forward(
        self,
        x: torch.Tensor,
        time_emb: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        batch_stats: Optional[dict] = None,
        level: Optional[spatial.Level] = None,
    ) -> torch.Tensor:
        if level is None:
            h = norm_call(self.norm, self.conv(x), batch_stats)
        else:
            c, n = self.conv, self.norm
            h, _ = spatial.conv2d(x, c.weight, c.bias, level, c.stride[0], c.padding[0])
            if isinstance(n, nn.GroupNorm):
                h = spatial.group_norm(h, n.num_groups, n.weight, n.bias, n.eps, level)
            else:
                h = norm_call(n, h, batch_stats)
        if self.time_mlp is not None and time_emb is not None:
            scale, shift = self.time_mlp(time_emb)[:, :, None, None].chunk(2, dim=1)
            # keep h's dtype: the f32 time MLP must not upcast the conv path
            h = h * (scale.to(h.dtype) + 1.0) + shift.to(h.dtype)
        h = dropout(F.gelu(h), self.dropout, generator, None if level is None else level.slab)
        if self.residual and x.shape[1] == h.shape[1]:
            h = h + x
        return h


class SimpleConvNet(nn.Module):
    """The 'cnn_simple' backbone: conv blocks + 1x1 head. Called as
    ``model(x, time=None, condition=None, generator=None, batch_stats=None)``;
    the condition is concatenated after the inputs."""

    def __init__(
        self,
        dim: int,
        num_input_channels: int,
        num_output_channels: int,
        num_conditional_channels: int = 0,
        with_time_emb: bool = False,
        net_normalization: str = "batch_norm",
        kernel_sizes: Sequence[int] = (7, 3, 3),
        residual: bool = True,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.num_conditional_channels = num_conditional_channels
        self.time_emb_mlp = TimeEmbedder(dim * 2, dim) if with_time_emb else None
        time_dim = dim * 2 if with_time_emb else None
        dims_in = [num_input_channels + num_conditional_channels] + [dim] * (len(kernel_sizes) - 1)
        self.convs = nn.ModuleList([
            ConvBlock(d_in, dim, k, net_normalization, residual, dropout, time_dim)
            for d_in, k in zip(dims_in, kernel_sizes)
        ])
        self.head = nn.Conv2d(dim, num_output_channels, 1)

    def forward(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor] = None,
        condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        batch_stats: Optional[dict] = None,
    ) -> torch.Tensor:
        shard = spatial.current()
        level = None if shard is None else shard.top()
        if self.num_conditional_channels > 0:
            assert condition is not None, "model built with conditional channels but condition is None"
            x = torch.cat([x, condition], dim=1)  # inputs first
        else:
            assert condition is None, "condition given but num_conditional_channels == 0"
        t = self.time_emb_mlp(time) if self.time_emb_mlp is not None else None
        for block in self.convs:
            x = block(x, t, generator, batch_stats, level)
        return self.head(x)
