"""NCSN++, the MCVD score network, and its SPADE variant, in NCHW.

Counterpart of ``dyffusion_tpu/models/ncsnpp.py``: positional or
Gaussian-Fourier time embedding, BigGAN residual blocks with AdaGN
conditioning and FIR resampling of both the residual and the skip path, or
DDPM residual blocks with standalone fused conv + FIR resamplers;
multi-head attention with NIN projections at the configured resolutions;
the optional binary condition embedding (``cond_emb``); skip rescaling by
1/sqrt(2); the DDPM variance-scaling init with near-zero output convs.
:class:`SPADENCSNpp` feeds the condition into every normalization as
spatial gamma/beta maps instead of concatenating it to the input.

The modules sit in the original reference's flat ``all_modules`` list, in
its construction order, under its sub-names (``Conv_0``, ``Dense_0``,
``actnorm0``, ``NIN_0.W`` in (in, out) layout, ``Norm_0``, ...), so a
state dict of the port is one of the reference's; the Fourier features are
the exception, see :mod:`dyffusion_tpu_torch.models.convert`.
``remat=True`` checkpoints every residual and attention block
(:func:`dyffusion_tpu_torch.models.unet.remat_call`). The FIR resampling is
:mod:`dyffusion_tpu_torch.ops.upfirdn2d`; the attention is plain matmuls
and a softmax, as the JAX package computes it outside Pallas.

Inside ``parallel.spatial.sharded`` the same ladder runs on this rank's
slab of the grid, every block given the ``level`` of its input (``None``
on one device): the 3 x 3 convs through their halos, the GroupNorms'
moments over the model group, the FIR resampling (``spatial.fir_upsample``
and the fused ``upsample_conv_fir``, their downs) on the rows their output
block reads, the attention of this rank's queries against every rank's
keys and values, dropout on the slab of the global mask, and the SPADE
maps resized from this rank's slab of the global condition (taps from
global coordinates). The 1 x 1 convs, NINs, dense layers and SiLUs stay
local.
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dyffusion_tpu_torch.models.base import Conv2d
from dyffusion_tpu_torch.models.modules import PromotingLinear, dropout
from dyffusion_tpu_torch.models.unet import remat_call
from dyffusion_tpu_torch.parallel import spatial
from dyffusion_tpu_torch.ops.upfirdn2d import conv_downsample_2d, downsample_2d, upsample_2d, upsample_conv_2d

FIR_KERNEL = [1, 3, 3, 1]


@torch.no_grad()
def _init(w: torch.Tensor, scale: float, fan_in: int, fan_out: int) -> None:
    """DDPM init: variance scaling over fan_avg, uniform; scale 0 is 1e-10."""
    limit = math.sqrt(3.0 * max(scale, 1e-10) / ((fan_in + fan_out) / 2.0))
    w.uniform_(-limit, limit)


def ddpm_conv(c_in: int, c_out: int, kernel: int, init_scale: float = 1.0) -> nn.Conv2d:
    """A 'same' 3x3 or 1x1 conv with the DDPM init and zero bias."""
    conv = Conv2d(c_in, c_out, kernel, padding=kernel // 2)
    _init(conv.weight, init_scale, c_in * kernel * kernel, c_out * kernel * kernel)
    nn.init.zeros_(conv.bias)
    return conv


def ddpm_dense(c_in: int, c_out: int, init_scale: float = 1.0) -> PromotingLinear:
    dense = PromotingLinear(c_in, c_out)
    _init(dense.weight, init_scale, c_in, c_out)
    nn.init.zeros_(dense.bias)
    return dense


def _conv(conv: nn.Conv2d, x: torch.Tensor, level: Optional[spatial.Level]) -> torch.Tensor:
    """A square 'same' conv of ``x``: the module on one device (``level``
    None) or for a 1 x 1 conv, else through the level's halo."""
    if level is None or conv.kernel_size[0] == 1:
        return conv(x)
    return spatial.conv2d(x, conv.weight, conv.bias, level, padding=conv.padding[0])[0]


def _norm(norm: nn.GroupNorm, x: torch.Tensor, level: Optional[spatial.Level]) -> torch.Tensor:
    """A GroupNorm of ``x``: over the whole grid, the moments of a slab
    summed over the model group (``spatial.group_norm``)."""
    if level is None:
        return norm(x)
    return spatial.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps, level)


def _slab(level: Optional[spatial.Level]):
    return None if level is None else level.slab


def _fir_level(level: Optional[spatial.Level], up: bool) -> Optional[spatial.Level]:
    """The level after a x2 FIR resample of ``level`` (up or down; the
    fused conv resamplers give the same extents)."""
    if level is None:
        return None
    return spatial.upfirdn_level(level, len(FIR_KERNEL), 2 if up else 1, 1 if up else 2, (2, 1) if up else (1, 1))


def _groups(ch: int) -> int:
    """min(ch // 4, 32), reduced until it divides ch."""
    g = max(min(ch // 4, 32), 1)
    while ch % g != 0:
        g -= 1
    return g


def timestep_embedding(t: torch.Tensor, dim: int, max_positions: int = 10000) -> torch.Tensor:
    """DDPM positional embedding (f32); an odd ``dim`` is zero-padded."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_positions) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GaussianFourierProjection(nn.Module):
    """Random-feature time embedding. ``W`` is a parameter that never
    trains: its gradient is cut, and the optimizer does not decay it (its
    owner is named ``fourier_emb``)."""

    def __init__(self, embedding_size: int, scale: float = 16.0):
        super().__init__()
        self.W = nn.Parameter(torch.randn(embedding_size) * scale)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        args = t.float()[:, None] * self.W.detach().float()[None, :] * 2 * math.pi
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class NIN(nn.Module):
    """Network-in-network: a 1x1 projection over the channels with the
    weight in (in, out) layout."""

    def __init__(self, c_in: int, c_out: int, init_scale: float = 1.0):
        super().__init__()
        self.W = nn.Parameter(torch.empty(c_in, c_out))
        self.b = nn.Parameter(torch.zeros(c_out))
        _init(self.W, init_scale, c_in, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (x.shape[-2] and x.shape[-1]):  # a slab of no rows under a shard (see ``base.Conv2d``)
            return x.reshape(x.shape[0], self.W.shape[1], *x.shape[-2:])
        return F.conv2d(x, self.W.t()[:, :, None, None], self.b)


class ActNorm(nn.Module):
    """GroupNorm (eps 1e-5) -> AdaGN -> SiLU. Conditioned on the time
    embedding (``temb_dim``), the norm has no affine and the scale and
    shift come from ``Dense_0(silu(temb))``; otherwise the norm is affine."""

    def __init__(self, ch: int, temb_dim: Optional[int] = None):
        super().__init__()
        self.Norm_0 = nn.GroupNorm(_groups(ch), ch, eps=1e-5, affine=temb_dim is None)
        self.Dense_0 = ddpm_dense(temb_dim, 2 * ch) if temb_dim is not None else None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                level: Optional[spatial.Level] = None) -> torch.Tensor:
        h = _norm(self.Norm_0, x, level)
        if self.Dense_0 is not None:
            scale, shift = self.Dense_0(F.silu(temb))[:, :, None, None].chunk(2, dim=1)
            h = h * (1.0 + scale.to(h.dtype)) + shift.to(h.dtype)
        return F.silu(h)


class AttnBlockpp(nn.Module):
    """Multi-head self-attention over the spatial tokens with NIN
    projections: GroupNorm (eps 1e-6), ``max(C // n_head_channels, 1)``
    heads, a near-zero output projection."""

    def __init__(self, channels: int, n_head_channels: int = 64, skip_rescale: bool = True):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(_groups(channels), channels, eps=1e-6)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=0.0)
        self.n_heads = max(channels // n_head_channels, 1)
        self.skip_rescale = skip_rescale

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                level: Optional[spatial.Level] = None) -> torch.Tensor:
        B, C, H, W = x.shape
        nh = self.n_heads
        dh = C // nh
        h = _norm(self.GroupNorm_0, x, level)
        q = self.NIN_0(h).reshape(B, nh, dh, H * W)
        kv = torch.stack([self.NIN_1(h), self.NIN_2(h)], dim=1)
        if level is not None:  # this rank's queries against every rank's keys and values
            kv = spatial.gather(kv, level)
        k, v = kv.reshape(B, 2, nh, dh, -1).unbind(1)
        sim = torch.matmul(q.transpose(-1, -2), k) / math.sqrt(dh)
        attn = torch.softmax(sim, dim=-1)
        out = torch.matmul(attn, v.transpose(-1, -2))  # (B, nh, N, dh)
        out = self.NIN_3(out.transpose(-1, -2).reshape(B, C, H, W))
        return (x + out) / math.sqrt(2.0) if self.skip_rescale else x + out


class Resample(nn.Module):
    """Standalone FIR resampler of the DDPM blocks (``up`` or down): with
    ``with_conv`` the fused transpose-conv + FIR, or FIR + strided conv,
    with its 3x3 weight at ``Conv2d_0``; without, the plain FIR."""

    def __init__(self, c_in: int, c_out: int, up: bool, with_conv: bool = True):
        super().__init__()
        self.up = up
        self.Conv2d_0 = ddpm_conv(c_in, c_out, 3) if with_conv else None

    def forward(self, x: torch.Tensor, level: Optional[spatial.Level] = None) -> torch.Tensor:
        if self.Conv2d_0 is None:
            if level is not None:
                return (spatial.fir_upsample if self.up else spatial.fir_downsample)(x, FIR_KERNEL, level)[0]
            return upsample_2d(x, FIR_KERNEL) if self.up else downsample_2d(x, FIR_KERNEL)
        w, b = self.Conv2d_0.weight, self.Conv2d_0.bias[:, None, None]
        if level is not None:
            op = spatial.upsample_conv_fir if self.up else spatial.conv_downsample_fir
            return op(x, w, FIR_KERNEL, level)[0] + b
        if self.up:
            return upsample_conv_2d(x, w, FIR_KERNEL) + b
        return conv_downsample_2d(x, w, FIR_KERNEL) + b


def _skip_sum(x: torch.Tensor, h: torch.Tensor, skip_rescale: bool) -> torch.Tensor:
    return (x + h) / math.sqrt(2.0) if skip_rescale else x + h


def _resample_both(h, x, up: bool, down: bool, level: Optional[spatial.Level] = None):
    """FIR-resample the residual path and the skip path alike; the level
    after it."""
    if not (up or down):
        return h, x, level
    if level is not None:
        op = spatial.fir_upsample if up else spatial.fir_downsample
        return op(h, FIR_KERNEL, level)[0], op(x, FIR_KERNEL, level)[0], _fir_level(level, up)
    op = upsample_2d if up else downsample_2d
    return op(h, FIR_KERNEL), op(x, FIR_KERNEL), None


class ResnetBlockBigGAN(nn.Module):
    """actnorm0(x, temb) -> FIR-resample h and x -> Conv_0 -> actnorm1 ->
    dropout -> near-zero Conv_1; the 1x1 shortcut ``Conv_2`` where the
    channels or the resolution change; skip rescaling."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: Optional[int], up: bool = False, down: bool = False,
                 dropout: float = 0.0, skip_rescale: bool = True):
        super().__init__()
        self.actnorm0 = ActNorm(in_ch, temb_dim)
        self.Conv_0 = ddpm_conv(in_ch, out_ch, 3)
        self.actnorm1 = ActNorm(out_ch, temb_dim)
        self.Conv_1 = ddpm_conv(out_ch, out_ch, 3, init_scale=0.0)
        self.Conv_2 = ddpm_conv(in_ch, out_ch, 1) if in_ch != out_ch or up or down else None
        self.up, self.down, self.p, self.skip_rescale = up, down, float(dropout), skip_rescale

    def forward(self, x, temb=None, generator=None, level=None):
        h = self.actnorm0(x, temb, level)
        h, x, level = _resample_both(h, x, self.up, self.down, level)
        h = self.actnorm1(_conv(self.Conv_0, h, level), temb, level)
        h = _conv(self.Conv_1, dropout(h, self.p, generator, _slab(level)), level)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return _skip_sum(x, h, self.skip_rescale)


class ResnetBlockDDPM(nn.Module):
    """GroupNorm_0 (eps 1e-6) -> SiLU -> Conv_0 -> + Dense_0(silu(temb)) ->
    GroupNorm_1 -> SiLU -> dropout -> near-zero Conv_1; the NIN shortcut
    ``NIN_0`` where the channels change; skip rescaling."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: Optional[int], dropout: float = 0.0,
                 skip_rescale: bool = True):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(_groups(in_ch), in_ch, eps=1e-6)
        self.Conv_0 = ddpm_conv(in_ch, out_ch, 3)
        self.Dense_0 = ddpm_dense(temb_dim, out_ch) if temb_dim is not None else None
        self.GroupNorm_1 = nn.GroupNorm(_groups(out_ch), out_ch, eps=1e-6)
        self.Conv_1 = ddpm_conv(out_ch, out_ch, 3, init_scale=0.0)
        self.NIN_0 = NIN(in_ch, out_ch) if in_ch != out_ch else None
        self.p, self.skip_rescale = float(dropout), skip_rescale

    def forward(self, x, temb=None, generator=None, level=None):
        h = _conv(self.Conv_0, F.silu(_norm(self.GroupNorm_0, x, level)), level)
        if self.Dense_0 is not None and temb is not None:
            h = h + self.Dense_0(F.silu(temb))[:, :, None, None].to(h.dtype)
        h = F.silu(_norm(self.GroupNorm_1, h, level))
        h = _conv(self.Conv_1, dropout(h, self.p, generator, _slab(level)), level)
        if self.NIN_0 is not None:
            x = self.NIN_0(x)
        return _skip_sum(x, h, self.skip_rescale)


def torch_nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize picking source index floor(i * in / out) (torch's
    ``mode="nearest"``, not the half-pixel ``nearest-exact``)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")


class MySPADE(nn.Module):
    """Spatially adaptive GroupNorm (no affine, eps 1e-6): gamma and beta
    maps from the nearest-resized condition through a small conv MLP,
    ``norm(x) * (1 + gamma) + beta``."""

    def __init__(self, ch: int, cond_ch: int, spade_dim: int = 128):
        super().__init__()
        self.param_free_norm = nn.GroupNorm(_groups(ch), ch, eps=1e-6, affine=False)
        self.mlp_shared = nn.Sequential(ddpm_conv(cond_ch, spade_dim, 3), nn.SiLU())
        self.mlp_gamma = ddpm_conv(spade_dim, ch, 3)
        self.mlp_beta = ddpm_conv(spade_dim, ch, 3)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor, seg_level: Optional[spatial.Level] = None,
                level: Optional[spatial.Level] = None) -> torch.Tensor:
        """``segmap`` on one device; on a slab of ``level``, this rank's
        slab of the global condition, of ``seg_level``."""
        h = _norm(self.param_free_norm, x, level)
        if level is None:
            seg = torch_nearest_resize(segmap, x.shape[-2:])
        elif (seg_level.total, seg_level.other) == (level.total, level.other):
            seg = segmap
        else:
            size = (level.total, level.other) if level.dim == -2 else (level.other, level.total)
            seg = spatial.resize(segmap, seg_level, size, "nearest")[0]
        actv = self.mlp_shared[1](_conv(self.mlp_shared[0], seg.to(h.dtype), level))
        return h * (1.0 + _conv(self.mlp_gamma, actv, level)) + _conv(self.mlp_beta, actv, level)


class SPADEActNorm(nn.Module):
    """MySPADE (``Norm_0``) -> optional AdaGN from the time embedding
    (``Dense_0``) -> SiLU."""

    def __init__(self, ch: int, cond_ch: int, spade_dim: int, temb_dim: Optional[int]):
        super().__init__()
        self.Norm_0 = MySPADE(ch, cond_ch, spade_dim)
        self.Dense_0 = ddpm_dense(temb_dim, 2 * ch) if temb_dim is not None else None

    def forward(self, x, temb, cond, cond_level=None, level=None):
        h = self.Norm_0(x, cond, cond_level, level)
        if self.Dense_0 is not None and temb is not None:
            scale, shift = self.Dense_0(F.silu(temb))[:, :, None, None].chunk(2, dim=1)
            h = h * (1.0 + scale.to(h.dtype)) + shift.to(h.dtype)
        return F.silu(h)


class ResnetBlockBigGANSPADE(nn.Module):
    """:class:`ResnetBlockBigGAN` with SPADE act-norms: the condition enters
    only through the norms."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: Optional[int], cond_ch: int, spade_dim: int = 128,
                 up: bool = False, down: bool = False, dropout: float = 0.0, skip_rescale: bool = True):
        super().__init__()
        self.actnorm0 = SPADEActNorm(in_ch, cond_ch, spade_dim, temb_dim)
        self.Conv_0 = ddpm_conv(in_ch, out_ch, 3)
        self.actnorm1 = SPADEActNorm(out_ch, cond_ch, spade_dim, temb_dim)
        self.Conv_1 = ddpm_conv(out_ch, out_ch, 3, init_scale=0.0)
        self.Conv_2 = ddpm_conv(in_ch, out_ch, 1) if in_ch != out_ch or up or down else None
        self.up, self.down, self.p, self.skip_rescale = up, down, float(dropout), skip_rescale

    def forward(self, x, temb, cond, cond_level=None, generator=None, level=None):
        """``cond_level``: the level of ``cond`` under a shard (else None)."""
        h = self.actnorm0(x, temb, cond, cond_level, level)
        h, x, level = _resample_both(h, x, self.up, self.down, level)
        h = self.actnorm1(_conv(self.Conv_0, h, level), temb, cond, cond_level, level)
        h = _conv(self.Conv_1, dropout(h, self.p, generator, _slab(level)), level)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return _skip_sum(x, h, self.skip_rescale)


class _NCSNppBase(nn.Module):
    """The ladder both variants share: the time embedding, then
    ``conv_in``, the downs (``num_res_blocks`` blocks per level, attention
    where the level's resolution is in ``attn_resolutions``, a resampling
    block between levels), the middle (block, attention, block), the ups
    (``num_res_blocks + 1`` blocks on the skips, attention, a resampling
    block), the final act-norm and ``conv_out``, all in ``all_modules``."""

    def _build(self, nf, dim_mults, num_res_blocks, attn_resolutions, spatial_height, with_time_emb, cond_emb,
               c_in, make_block, make_down, make_up, make_attn, make_norm_out, embed_dim=None):
        n_res = len(dim_mults)
        all_res = [spatial_height // (2**i) for i in range(n_res)]
        temb_dim = None
        mods = []
        if with_time_emb:
            mods += [ddpm_dense(embed_dim or nf, nf * 4), ddpm_dense(nf * 4, nf * 4)]
            temb_dim = nf * 4
            if cond_emb:
                emb = nn.Embedding(2, nf // 2)
                nn.init.normal_(emb.weight, std=1.0 / math.sqrt(nf // 2))
                mods.append(emb)
                temb_dim += nf // 2
        mods.append(ddpm_conv(c_in, nf, 3))
        hs_c, in_ch = [nf], nf
        for i in range(n_res):
            for _ in range(num_res_blocks):
                out_ch = nf * dim_mults[i]
                mods.append(make_block(in_ch, out_ch, temb_dim))
                in_ch = out_ch
                if all_res[i] in attn_resolutions:
                    mods.append(make_attn(in_ch))
                hs_c.append(in_ch)
            if i != n_res - 1:
                mods.append(make_down(in_ch, temb_dim))
                hs_c.append(in_ch)
        mods += [make_block(in_ch, in_ch, temb_dim), make_attn(in_ch), make_block(in_ch, in_ch, temb_dim)]
        for i in reversed(range(n_res)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * dim_mults[i]
                mods.append(make_block(in_ch + hs_c.pop(), out_ch, temb_dim))
                in_ch = out_ch
            if all_res[i] in attn_resolutions:
                mods.append(make_attn(in_ch))
            if i != 0:
                mods.append(make_up(in_ch, temb_dim))
        assert not hs_c
        mods.append(make_norm_out(in_ch))
        mods.append(ddpm_conv(in_ch, self.num_output_channels, 3, init_scale=0.0))
        self.all_modules = nn.ModuleList(mods)
        self.n_res, self.all_res = n_res, all_res
        self.num_res_blocks, self.attn_resolutions = num_res_blocks, tuple(attn_resolutions)

    def _call(self, block: nn.Module, generator, level: Optional[spatial.Level], *args) -> torch.Tensor:
        """``block(*args, generator, level)``, checkpointed under remat when
        gradients are being recorded."""
        if self.remat and torch.is_grad_enabled():
            return remat_call(block, generator, *args, level=level)
        return block(*args, generator, level)

    def _temb(self, emb: Optional[torch.Tensor], x: torch.Tensor, cond_mask, modules: Iterator[nn.Module]):
        if emb is None:
            return None
        temb = next(modules)(emb)
        temb = next(modules)(F.silu(temb))
        if self.cond_emb:
            mask = torch.zeros(x.shape[0], dtype=torch.long, device=x.device) if cond_mask is None else cond_mask.long()
            cemb = next(modules)(mask)
            dt = torch.promote_types(temb.dtype, cemb.dtype)
            temb = torch.cat([temb.to(dt), cemb.to(dt)], dim=-1)
        return temb

    def _ladder(self, h, temb, modules: Iterator[nn.Module], block_args, generator, resample,
                level: Optional[spatial.Level]):
        """conv_in through the last up block, from the top ``level`` (None
        on one device) and back to it; ``block_args`` follow h and temb into
        every residual block, ``resample(module, h, level)`` runs a
        resampling entry. A skip comes back on the level it left."""
        g, lv = generator, level
        h = _conv(next(modules), h, lv)
        hs = [h]
        for i in range(self.n_res):
            for _ in range(self.num_res_blocks):
                h = self._call(next(modules), g, lv, h, temb, *block_args)
                if self.all_res[i] in self.attn_resolutions:
                    h = self._call(next(modules), g, lv, h)
                hs.append(h)
            if i != self.n_res - 1:
                h = resample(next(modules), h, lv)
                lv = _fir_level(lv, up=False)
                hs.append(h)
        h = self._call(next(modules), g, lv, h, temb, *block_args)
        h = self._call(next(modules), g, lv, h)
        h = self._call(next(modules), g, lv, h, temb, *block_args)
        for i in reversed(range(self.n_res)):
            for _ in range(self.num_res_blocks + 1):
                h = self._call(next(modules), g, lv, torch.cat([h, hs.pop()], dim=1), temb, *block_args)
            if self.all_res[i] in self.attn_resolutions:
                h = self._call(next(modules), g, lv, h)
            if i != 0:
                h = resample(next(modules), h, lv)
                lv = _fir_level(lv, up=True)
        assert not hs and lv == level
        return h


class NCSNpp(_NCSNppBase):
    """The 2-D NCSN++ score network ('ncsnpp'). Called as
    ``model(x, time, condition=None, generator=None)`` on NCHW tensors; the
    condition is concatenated AFTER x on the channels.

    ``resblock_type``: 'biggan' resamples inside the residual blocks; 'ddpm'
    uses :class:`ResnetBlockDDPM` with standalone fused conv + FIR
    resamplers. ``embedding_type``: 'positional' or 'fourier'.
    ``spatial_height`` sets the resolution ladder that ``attn_resolutions``
    is read against."""

    def __init__(
        self,
        dim: int,
        num_input_channels: int,
        num_output_channels: int,
        num_conditional_channels: int = 0,
        n_head_channels: int = 64,
        dim_mults: Sequence[int] = (1, 2, 3, 4),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (8, 16, 32),
        dropout: float = 0.0,
        with_time_emb: bool = True,
        cond_emb: bool = False,
        embedding_type: str = "positional",
        skip_rescale: bool = True,
        resblock_type: str = "biggan",
        spatial_height: int = 32,
        remat: bool = False,
    ):
        super().__init__()
        assert resblock_type in ("biggan", "ddpm"), resblock_type
        assert embedding_type in ("positional", "fourier"), embedding_type
        self.num_output_channels = num_output_channels
        self.num_conditional_channels = num_conditional_channels
        self.with_time_emb, self.cond_emb, self.remat = with_time_emb, cond_emb, bool(remat)
        self.embedding_type = embedding_type
        self.biggan = resblock_type == "biggan"
        self.nf = nf = dim
        if with_time_emb and embedding_type == "fourier":
            self.fourier_emb = GaussianFourierProjection(nf)
        kw = dict(dropout=dropout, skip_rescale=skip_rescale)

        def block(c_in, c_out, temb_dim):
            if self.biggan:
                return ResnetBlockBigGAN(c_in, c_out, temb_dim, **kw)
            return ResnetBlockDDPM(c_in, c_out, temb_dim, **kw)

        def resampler(up):
            def make(ch, temb_dim):
                if self.biggan:
                    return ResnetBlockBigGAN(ch, ch, temb_dim, up=up, down=not up, **kw)
                return Resample(ch, ch, up=up)
            return make

        self._build(
            nf, dim_mults, num_res_blocks, attn_resolutions, spatial_height, with_time_emb, cond_emb,
            num_input_channels + num_conditional_channels, block, resampler(False), resampler(True),
            lambda ch: AttnBlockpp(ch, n_head_channels, skip_rescale),
            lambda ch: ActNorm(ch), embed_dim=2 * nf if embedding_type == "fourier" else nf,
        )

    def forward(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor] = None,
        condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        cond_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        shard = spatial.current()
        top = None if shard is None else shard.top()
        if condition is not None:
            x = torch.cat([x, condition], dim=1)  # x first
        modules = iter(self.all_modules)
        emb = None
        if self.with_time_emb:
            emb = self.fourier_emb(time) if self.embedding_type == "fourier" else timestep_embedding(time, self.nf)
        temb = self._temb(emb, x, cond_mask, modules)

        def resample(m, h, level):
            return self._call(m, generator, level, h, temb) if self.biggan else m(h, level)

        h = self._ladder(x, temb, modules, (), generator, resample, top)
        h = next(modules)(h, None, top)  # the final act-norm: affine GroupNorm -> SiLU
        return _conv(next(modules), h, top)


class SPADENCSNpp(_NCSNppBase):
    """NCSN++ with SPADE norms ('ncsnpp_spade'): the same ladder of BigGAN
    blocks (positional time embedding, FIR resampling, skip rescaling), but
    the condition, which is required, drives gamma/beta maps inside every
    normalization and is not concatenated to the input."""

    def __init__(
        self,
        dim: int,
        num_input_channels: int,
        num_output_channels: int,
        num_conditional_channels: int,
        spade_dim: int = 128,
        n_head_channels: int = 64,
        dim_mults: Sequence[int] = (1, 2, 3, 4),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (8, 16, 32),
        dropout: float = 0.0,
        with_time_emb: bool = True,
        cond_emb: bool = False,
        skip_rescale: bool = True,
        spatial_height: int = 32,
        remat: bool = False,
    ):
        super().__init__()
        self.num_output_channels = num_output_channels
        self.num_conditional_channels = num_conditional_channels
        self.with_time_emb, self.cond_emb, self.remat = with_time_emb, cond_emb, bool(remat)
        self.nf, nf, cc = dim, dim, num_conditional_channels
        kw = dict(spade_dim=spade_dim, dropout=dropout, skip_rescale=skip_rescale)
        self._build(
            nf, dim_mults, num_res_blocks, attn_resolutions, spatial_height, with_time_emb, cond_emb,
            num_input_channels,
            lambda c_in, c_out, t: ResnetBlockBigGANSPADE(c_in, c_out, t, cc, **kw),
            lambda ch, t: ResnetBlockBigGANSPADE(ch, ch, t, cc, down=True, **kw),
            lambda ch, t: ResnetBlockBigGANSPADE(ch, ch, t, cc, up=True, **kw),
            lambda ch: AttnBlockpp(ch, n_head_channels, skip_rescale),
            lambda ch: SPADEActNorm(ch, cc, spade_dim, None),
        )

    def forward(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor] = None,
        condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        cond_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        assert condition is not None, "SPADENCSNpp requires conditioning frames"
        shard = spatial.current()
        top = None if shard is None else shard.top()
        modules = iter(self.all_modules)
        emb = timestep_embedding(time, self.nf) if self.with_time_emb else None
        temb = self._temb(emb, x, cond_mask, modules)

        def resample(m, h, level):
            return self._call(m, generator, level, h, temb, condition, top)

        h = self._ladder(x, temb, modules, (condition, top), generator, resample, top)
        h = next(modules)(h, None, condition, top, top)  # the final act-norm: SPADE, no time embedding
        return _conv(next(modules), h, top)
