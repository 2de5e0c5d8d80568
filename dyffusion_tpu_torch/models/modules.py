"""Shared NN modules: time embedders, channel-norm, attention, dropout,
and the up-sampling blocks ``DoubleConv``/``UpSampler``.

Counterpart of ``dyffusion_tpu/models/modules.py`` in NCHW. Submodule names
follow the original reference's state-dict keys (``to_qkv.1`` for the
dropout-then-conv projection of ``LinearAttention``, ``fn.norm.g`` /
``fn.fn.*`` for ``PreNormResidual``), so its checkpoints and the JAX
package's converted params load unchanged.

Dropout takes an explicit ``torch.Generator`` (or
:data:`dyffusion_tpu_torch.utils.rng.DEVICE_DEFAULT`, the device's default
generator, as the exported sampler draws); ``generator=None`` means
deterministic, as ``dropout_rng=None`` does in the JAX package.

Under spatial sharding (``parallel/spatial.py``) the ``Unet``'s blocks take
the ``level`` of their input, this rank's slab of one resolution of the
grid: dropout draws the global mask and keeps the slab's rows, the linear
attention runs B1 split across the ranks ('qk': ``spatial
.linear_attention_qk``, a plain composition), the mid-block attention takes
this rank's queries against every rank's keys and values. ``level=None``
is the one-device path, unchanged.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dyffusion_tpu_torch.models.base import BatchNorm2d, Conv2d
from dyffusion_tpu_torch.ops.linear_attention import linear_attention_qkv
from dyffusion_tpu_torch.parallel import spatial
from dyffusion_tpu_torch.utils import rng
from dyffusion_tpu_torch.utils.profiling import span


def dropout(
    x: torch.Tensor, p: float, generator: Optional[torch.Generator], slab: Optional[rng.Slab] = None,
    channels_last: bool = False,
) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep each element with
    probability 1-p and scale it by 1/(1-p) (flax ``nn.Dropout``).
    ``generator=None`` or ``p == 0`` returns ``x``. With ``slab`` (spatial
    sharding), ``x`` is a rank's slab and its mask the slab of the global
    draw. The mask is drawn by ``x``'s logical shape; ``channels_last``
    keeps a channels-last ``x``'s layout (``torch.where`` takes the
    contiguous mask's) with the same values: the mask's complement filled
    with zeros."""
    if generator is None or p == 0.0:
        return x
    u = rng.rand(x.shape, generator, x.device, slab=slab)
    if channels_last:
        return (x / (1.0 - p)).masked_fill_(u >= 1.0 - p, 0.0)
    return torch.where(u < 1.0 - p, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """:func:`dropout` as a module (no parameters; it holds a state-dict slot
    such as ``to_qkv.0`` where the reference has an ``nn.Dropout``)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.p, generator)


class PromotingLinear(nn.Linear):
    """``nn.Linear`` that computes in the promoted dtype of input and weight,
    as flax ``nn.Dense`` does: an f32 input meets bf16 weights in f32 (the
    time-embedding and FiLM MLPs under bf16 eval run on bf16-rounded weights
    in f32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class SinusoidalPosEmb(nn.Module):
    """Transformer-style sinusoidal embedding, computed in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        emb = math.log(10000.0) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class LearnedSinusoidalPosEmb(nn.Module):
    """Sinusoidal embedding with learned frequencies ``weights`` (dim/2 of
    them, drawn from N(0, 1)), computed in f32: [t, sin(2 pi t w),
    cos(2 pi t w)], dim + 1 features."""

    def __init__(self, dim: int):
        super().__init__()
        if dim % 2:
            raise ValueError(f"LearnedSinusoidalPosEmb needs an even dim, got {dim}")
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()[:, None]
        freqs = t * self.weights.float()[None, :] * (2 * math.pi)
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class TimeEmbedder(nn.Sequential):
    """Sinusoidal embedding (fixed, or with ``learned_sinusoidal`` the
    learned-frequency one of ``learned_sinusoidal_dim``) + Linear -> exact
    GELU -> Linear. Indexed as the reference's ``time_emb_mlp`` (the learned
    frequencies at ``.0.weights``, the linears at ``.1`` and ``.3``)."""

    def __init__(self, time_dim: int, dim: int, learned_sinusoidal: bool = False, learned_sinusoidal_dim: int = 16):
        if learned_sinusoidal:
            emb, emb_dim = LearnedSinusoidalPosEmb(learned_sinusoidal_dim), learned_sinusoidal_dim + 1
        else:
            emb, emb_dim = SinusoidalPosEmb(dim), dim
        super().__init__(
            emb,
            PromotingLinear(emb_dim, time_dim),
            nn.GELU(approximate="none"),
            PromotingLinear(time_dim, time_dim),
        )


class ChannelLayerNorm(nn.Module):
    """Gain-only LayerNorm over the channel axis (biased variance); eps 1e-5
    in f32 and 1e-3 in any other dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + eps) * self.g


def weight_standardize(weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Standardize a conv weight (O, I, kh, kw) over all but O (biased var)."""
    mean = weight.mean(dim=(1, 2, 3), keepdim=True)
    var = weight.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (weight - mean) * torch.rsqrt(var + eps)


class WSConv(nn.Conv2d):
    """Weight-standardized conv, 'same' padding (eps 1e-5 in f32, else 1e-3)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3):
        super().__init__(dim_in, dim_out, kernel_size, padding=kernel_size // 2)

    def standardized(self, dtype: torch.dtype) -> torch.Tensor:
        """The standardized weight for an input of ``dtype``."""
        eps = 1e-5 if dtype == torch.float32 else 1e-3
        return weight_standardize(self.weight, eps).to(dtype)

    def forward(self, x: torch.Tensor, level: Optional[spatial.Level] = None) -> torch.Tensor:
        w, b = self.standardized(x.dtype), self.bias.to(x.dtype)
        if level is not None:
            return spatial.conv2d(x, w, b, level, padding=self.padding[0])[0]
        return F.conv2d(x, w, b, padding=self.padding)


class LinearAttention(nn.Module):
    """Linear attention over spatial tokens. Dropout acts on the input,
    before ``to_qkv``. The 'qkv' rescale runs in the B1 kernel
    (:func:`dyffusion_tpu_torch.ops.linear_attention_qkv`) on the NCHW
    projection viewed as (B, N, 3*h*d), with no copy."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dropout: float = 0.0, rescale: str = "qkv"):
        super().__init__()
        assert rescale in ("qk", "qkv"), rescale
        self.heads, self.dim_head, self.rescale = heads, dim_head, rescale
        hidden = heads * dim_head
        self.to_qkv = nn.ModuleList([Dropout(dropout), Conv2d(dim, hidden * 3, 1, bias=False)])
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                level: Optional[spatial.Level] = None) -> torch.Tensor:
        B, C, H, W = x.shape
        N = H * W
        scale = self.dim_head**-0.5
        hidden = self.heads * self.dim_head
        x = dropout(x, self.to_qkv[0].p, generator, None if level is None else level.slab)
        qkv = self.to_qkv[1](x)  # (B, 3*hidden, H, W)
        if level is not None:
            if self.rescale == "qk":
                out = spatial.linear_attention_qk(qkv.flatten(2), self.heads, self.dim_head, scale, level)
                return self.to_out(out.reshape(B, hidden, H, W))
            out = spatial.linear_attention(qkv.flatten(2).transpose(1, 2), self.heads, self.dim_head, scale, level)
            return self.to_out(out.transpose(1, 2).reshape(B, hidden, H, W))
        if self.rescale == "qkv":
            out = linear_attention_qkv(qkv.flatten(2).transpose(1, 2), self.heads, self.dim_head, scale)
            out = out.transpose(1, 2).reshape(B, hidden, H, W)
            return self.to_out(out)
        q, k, v = qkv.reshape(B, 3, self.heads, self.dim_head, N).unbind(1)  # (B, h, d, N)
        q = q * scale
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(B, hidden, H, W))


class Attention(nn.Module):
    """Full softmax attention over spatial tokens; dropout on the attention
    matrix. Plain einsum + softmax, as in the JAX package."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head, self.p = heads, dim_head, float(dropout)
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                level: Optional[spatial.Level] = None) -> torch.Tensor:
        B, C, H, W = x.shape
        scale = self.dim_head**-0.5
        if level is not None:  # this rank's queries against every rank's keys and values
            qkv = self.to_qkv(x).reshape(B, 3, self.heads, self.dim_head, H, W)
            q = qkv[:, 0].flatten(-2)
            k, v = spatial.gather(qkv[:, 1:], level).flatten(-2).unbind(1)
            sim = torch.einsum("bhdi,bhdj->bhij", q * scale, k)
            # the mask of this rank's query rows: the slab of the global (B, h, H, W, N) draw
            attn = torch.softmax(sim, dim=-1).reshape(B, self.heads, H, W, k.shape[-1])
            attn = dropout(attn, self.p, generator, level.slab._replace(dim=level.dim - 1)).flatten(2, 3)
            out = torch.einsum("bhij,bhdj->bhdi", attn, v)
            return self.to_out(out.reshape(B, self.heads * self.dim_head, H, W))
        q, k, v = self.to_qkv(x).reshape(B, 3, self.heads, self.dim_head, H * W).unbind(1)  # (B, h, d, N)
        sim = torch.einsum("bhdi,bhdj->bhij", q * scale, k)
        attn = dropout(torch.softmax(sim, dim=-1), self.p, generator)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v)
        return self.to_out(out.reshape(B, self.heads * self.dim_head, H, W))


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                level: Optional[spatial.Level] = None) -> torch.Tensor:
        with span("backbone.norm"):
            x = self.norm(x)
        if level is not None:
            return self.fn(x, generator, level=level)
        return self.fn(x, generator)


class PreNormResidual(nn.Module):
    """x + fn(ChannelLayerNorm(x)); keyed as the reference's
    ``Residual(PreNorm(dim, fn))``: ``fn.norm.g`` and ``fn.fn.*``."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = _PreNorm(dim, fn)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                level: Optional[spatial.Level] = None) -> torch.Tensor:
        return self.fn(x, generator, level) + x


class DoubleConv(nn.Module):
    """(bias-free 3x3 conv -> BatchNorm -> ReLU) x 2, keyed as the original
    reference's ``double_conv`` Sequential (convs at 0 and 3, norms at 1
    and 4). ``batch_stats``: see :class:`BatchNorm2d` (``None``: the
    running averages). No config of the JAX package reaches it."""

    def __init__(self, in_features: int, features: int, mid_features: Optional[int] = None):
        super().__init__()
        mid = mid_features or features
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_features, mid, 3, padding=1, bias=False), BatchNorm2d(mid), nn.ReLU(),
            nn.Conv2d(mid, features, 3, padding=1, bias=False), BatchNorm2d(features), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor, batch_stats: Optional[dict] = None) -> torch.Tensor:
        for m in self.double_conv:
            x = m(x, batch_stats) if isinstance(m, BatchNorm2d) else m(x)
        return x


class UpSampler(nn.Module):
    """Up-scale by ``scale_factor``, then :class:`DoubleConv` to
    ``features``. ``mode='conv'``: a kernel-2 stride-2 transposed conv to
    the halfway channel count ``(in + out) // 2``; 'nearest' or 'bilinear'
    (aligned corners): a resize, the DoubleConv passing through the halfway
    count. No config of the JAX package reaches it."""

    def __init__(self, in_features: int, features: int, mode: str = "conv", scale_factor: int = 2):
        super().__init__()
        h_feat = (in_features + features) // 2
        self.mode, self.scale_factor = mode, scale_factor
        if mode in ("conv", "convolution"):
            self.up = nn.ConvTranspose2d(in_features, h_feat, 2, stride=2)
            self.conv = DoubleConv(h_feat, features)
        else:
            self.up = None
            self.conv = DoubleConv(in_features, features, mid_features=h_feat)

    def forward(self, x: torch.Tensor, batch_stats: Optional[dict] = None) -> torch.Tensor:
        if self.up is not None:
            x = self.up(x)
        else:
            size = (x.shape[-2] * self.scale_factor, x.shape[-1] * self.scale_factor)
            if self.mode == "nearest":
                x = F.interpolate(x, size=size, mode="nearest-exact")
            else:
                x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self.conv(x, batch_stats)
