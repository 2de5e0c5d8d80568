"""ResNet-attention UNet ('unet_resnet'), the DYffusion backbone, in NCHW.

Counterpart of ``dyffusion_tpu/models/unet.py``: weight-standardized 3x3
convs + GroupNorm (eps 1e-5) + FiLM time conditioning, a downs/ups ladder of
two ResNet blocks + pre-norm linear attention per level, full attention at
the mid-block, stride-2 4x4 downsampling and nearest-x2 + 3x3 conv
upsampling, four dropout sites (input / block1 / block2 / attention) and the
optional outer resample. Submodules carry the original reference's names
(``downs.{i}.{0..3}``, ``ups.{i}.3.1``, ``mid_attn``, ``time_emb_mlp``, ...).
``remat=True`` checkpoints every ResNet block and every pre-norm attention
block (the JAX ``nn.remat`` granularity) with ``torch.utils.checkpoint``.

Inside ``parallel.spatial.sharded`` the same traversal runs on this rank's
slab of the grid, each block given the ``level`` of its input (``None`` on
one device): halo-exchanged convs (``init_conv`` halo 3, the 3x3 convs halo
1, the stride-2 downsample, the upsample's source rows), GroupNorm moments
summed over the model group, B1 split across ranks, the mid-block attention
against gathered keys and values; 1x1 convs, FiLM, SiLU and the channel
norms stay local. It trains too: every transfer has its backward
(``parallel/spatial.py``), and remat replays a block's collectives in the
backward in the forward's order on every rank. ``outer_sample_mode``
resamples the slab through ``spatial.resize`` (taps from the global
coordinates).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from dyffusion_tpu_torch.models.base import Conv2d, concat_condition
from dyffusion_tpu_torch.parallel import spatial
from dyffusion_tpu_torch.utils.profiling import span
from dyffusion_tpu_torch.models.modules import (
    Attention,
    LinearAttention,
    PreNormResidual,
    PromotingLinear,
    TimeEmbedder,
    WSConv,
    dropout,
)


class Block(nn.Module):
    """WSConv -> GroupNorm (the reference's ``block1``/``block2``)."""

    def __init__(self, dim_in: int, dim_out: int, groups: int):
        super().__init__()
        self.proj = WSConv(dim_in, dim_out, 3)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x: torch.Tensor, level: Optional[spatial.Level] = None) -> torch.Tensor:
        if level is not None:
            n, x = self.norm, self.proj(x, level)
            with span("backbone.norm"):
                return spatial.group_norm(x, n.num_groups, n.weight, n.bias, n.eps, level)
        x = self.proj(x)
        with span("backbone.norm"):
            return self.norm(x)


class ResnetBlock(nn.Module):
    """Block1 -> FiLM -> SiLU -> Dropout, Block2 -> SiLU -> Dropout, + residual.

    The FiLM MLP runs in the promoted dtype of the f32 time embedding and
    the weights; its scale/shift are cast to the activation dtype, so a bf16
    network stays bf16 after the first FiLM."""

    def __init__(
        self,
        dim_in: int,
        dim_out: int,
        time_emb_dim: Optional[int] = None,
        groups: int = 8,
        dropout1: float = 0.0,
        dropout2: float = 0.0,
        double_conv_layer: bool = True,
    ):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), PromotingLinear(time_emb_dim, dim_out * 2)) if time_emb_dim else None
        self.block1 = Block(dim_in, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups) if double_conv_layer else None
        self.residual_conv = Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else nn.Identity()
        self.dropout1, self.dropout2 = float(dropout1), float(dropout2)

    def forward(
        self, x: torch.Tensor, time_emb: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
        level: Optional[spatial.Level] = None,
    ) -> torch.Tensor:
        slab = None if level is None else level.slab
        h = self.block1(x) if level is None else self.block1(x, level)
        if self.mlp is not None and time_emb is not None:
            scale, shift = self.mlp(time_emb)[:, :, None, None].chunk(2, dim=1)
            h = h * (scale.to(h.dtype) + 1.0) + shift.to(h.dtype)
        h = dropout(F.silu(h), self.dropout1, generator, slab)
        if self.block2 is not None:
            h2 = self.block2(h) if level is None else self.block2(h, level)
            h = dropout(F.silu(h2), self.dropout2, generator, slab)
        return h + self.residual_conv(x)


def remat_call(block: nn.Module, generator: Optional[torch.Generator], *args,
               level: Optional[spatial.Level] = None) -> torch.Tensor:
    """``block(*args, generator)`` (with ``level``: ``block(*args,
    generator, level)``) under ``torch.utils.checkpoint``: the backward
    recomputes the block's activations instead of keeping them.

    The recompute must see what the forward saw. ``checkpoint`` restores
    only the global RNG states, so the explicit generator's state is taken
    here and the recompute draws from a copy of it: the same dropout masks
    (with ``level``, the same slab of the same global mask), and the live
    generator is left as the forward left it. The recompute also runs after
    any ``functional_call`` that substituted the block's weights (and
    buffers) has returned, so it substitutes the tensors the forward used.
    Under a shard the recompute runs the whole block, without checkpoint's
    early stop: its collectives then run in full, in the forward's order,
    on every rank of the group."""
    params = {**dict(block.named_buffers()), **dict(block.named_parameters())}
    state = None if generator is None else generator.get_state()
    tail = () if level is None else (level,)
    calls = []

    def run(*inputs):
        calls.append(None)
        if len(calls) == 1:  # the forward
            return block(*inputs, generator, *tail)
        replay = None
        if state is not None:
            replay = torch.Generator(device=generator.device)
            replay.set_state(state)
        return torch.func.functional_call(block, params, (*inputs, replay, *tail))

    with contextlib.nullcontext() if level is None else set_checkpoint_early_stop(False):
        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class Upsample(nn.Sequential):
    """Nearest x2 + 3x3 conv (the conv at index 1, as in the reference)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"), nn.Conv2d(dim_in, dim_out, 3, padding=1))


class Unet(nn.Module):
    """The 'unet_resnet' backbone. Called as
    ``model(x, time=None, condition=None, generator=None)`` on NCHW tensors."""

    def __init__(
        self,
        dim: int,
        num_input_channels: int,
        num_output_channels: int,
        num_conditional_channels: int = 0,
        init_dim: Optional[int] = None,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        resnet_block_groups: int = 8,
        with_time_emb: bool = False,
        block_dropout: float = 0.0,
        block_dropout1: float = 0.0,
        attn_dropout: float = 0.0,
        input_dropout: float = 0.0,
        double_conv_layer: bool = True,
        learned_sinusoidal_cond: bool = False,
        learned_sinusoidal_dim: int = 16,
        outer_sample_mode: Optional[str] = None,
        upsample_dims: Optional[Tuple[int, int]] = None,
        keep_spatial_dims: bool = False,
        init_kernel_size: int = 7,
        attn_heads: int = 4,
        attn_dim_head: int = 32,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = bool(remat)
        self.num_conditional_channels = num_conditional_channels
        self.input_dropout = float(input_dropout)
        self.outer_sample_mode = outer_sample_mode
        self.upsample_dims = tuple(upsample_dims) if upsample_dims is not None else None
        if outer_sample_mode is not None:
            assert self.upsample_dims is not None, "outer_sample_mode needs upsample_dims"

        init_dim = init_dim or dim
        self.init_conv = nn.Conv2d(
            num_input_channels + num_conditional_channels, init_dim, init_kernel_size,
            padding=init_kernel_size // 2,
        )
        time_dim = dim * 2 if with_time_emb else None
        self.time_emb_mlp = (
            TimeEmbedder(time_dim, dim, learned_sinusoidal_cond, learned_sinusoidal_dim) if with_time_emb else None
        )

        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n_res = len(in_out)

        def res(d_in, d_out):
            return ResnetBlock(
                d_in, d_out, time_dim, groups=resnet_block_groups, dropout1=block_dropout1,
                dropout2=block_dropout, double_conv_layer=double_conv_layer,
            )

        def lin_attn(d):
            return PreNormResidual(d, LinearAttention(d, attn_heads, attn_dim_head, attn_dropout, rescale="qkv"))

        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            is_last = i >= n_res - 1
            resample = (
                nn.Conv2d(d_in, d_out, 4, stride=2, padding=1)
                if not is_last and not keep_spatial_dims
                else nn.Conv2d(d_in, d_out, 3, padding=1)
            )
            self.downs.append(nn.ModuleList([res(d_in, d_in), res(d_in, d_in), lin_attn(d_in), resample]))

        mid = dims[-1]
        self.mid_block1 = res(mid, mid)
        self.mid_attn = PreNormResidual(mid, Attention(mid, attn_heads, attn_dim_head, attn_dropout))
        self.mid_block2 = res(mid, mid)

        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            is_last = i == n_res - 1
            resample = (
                Upsample(d_out, d_in) if not is_last and not keep_spatial_dims else nn.Conv2d(d_out, d_in, 3, padding=1)
            )
            self.ups.append(
                nn.ModuleList([res(d_out + d_in, d_out), res(d_out + d_in, d_out), lin_attn(d_out), resample])
            )

        self.final_res_block = res(init_dim * 2, dim)
        self.final_conv = Conv2d(dim, num_output_channels, 1)

    def _resize(self, x: torch.Tensor, size, level: Optional[spatial.Level]):
        """The outer resample to ``size`` (H, W) and its level (None on one
        device): half-pixel centres and no antialias, as the JAX package's
        jax.image.resize(antialias=False); for 'nearest' that is torch's
        'nearest-exact'."""
        mode = "bilinear" if self.outer_sample_mode == "bilinear" else "nearest-exact"
        if level is not None:
            return spatial.resize(x, level, size, mode)
        kw = {"align_corners": False, "antialias": False} if mode == "bilinear" else {}
        return F.interpolate(x, size=size, mode=mode, **kw), None

    def _block(self, block: nn.Module, generator: Optional[torch.Generator], level: Optional[spatial.Level],
               *args) -> torch.Tensor:
        """A ResNet or pre-norm attention block on the level of its input,
        checkpointed under remat when gradients are being recorded."""
        if self.remat and torch.is_grad_enabled():
            return remat_call(block, generator, *args, level=level)
        return block(*args, generator, level)

    @staticmethod
    def _conv(conv: nn.Module, x: torch.Tensor, level: Optional[spatial.Level]):
        """``conv`` (a square ``nn.Conv2d`` or the ``Upsample``) on ``x``
        and the level of its output: on one device (``level`` None) the
        module itself; on a slab through the level's halo."""
        if level is None:
            return conv(x), None
        if isinstance(conv, Upsample):
            return spatial.upsample_conv(x, conv[1].weight, conv[1].bias, level)
        return spatial.conv2d(x, conv.weight, conv.bias, level, stride=conv.stride[0], padding=conv.padding[0])

    def forward(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor] = None,
        condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        shard = spatial.current()
        lv = None if shard is None else shard.top()
        g, blk = generator, self._block
        x = concat_condition(x, condition, self.num_conditional_channels)
        orig_shape = tuple(x.shape[-2:]) if shard is None else shard.spatial
        if self.outer_sample_mode is not None:
            x, lv = self._resize(x, self.upsample_dims, lv)
        x, lv = self._conv(self.init_conv, x, lv)
        # two independent input-dropout draws
        slab = None if lv is None else lv.slab
        r = dropout(x, self.input_dropout, g, slab)
        x = dropout(x, self.input_dropout, g, slab)
        t = self.time_emb_mlp(time) if self.time_emb_mlp is not None else None

        hs = []
        for block1, block2, attn, resample in self.downs:
            x = blk(block1, g, lv, x, t)
            hs.append(x)
            x = blk(block2, g, lv, x, t)
            x = blk(attn, g, lv, x)
            hs.append(x)
            x, lv = self._conv(resample, x, lv)

        x = blk(self.mid_block1, g, lv, x, t)
        x = blk(self.mid_attn, g, lv, x)
        x = blk(self.mid_block2, g, lv, x, t)

        for block1, block2, attn, resample in self.ups:
            x = blk(block1, g, lv, torch.cat([x, hs.pop()], dim=1), t)
            x = blk(block2, g, lv, torch.cat([x, hs.pop()], dim=1), t)
            x = blk(attn, g, lv, x)
            x, lv = self._conv(resample, x, lv)

        x = blk(self.final_res_block, g, lv, torch.cat([x, r], dim=1), t)
        x = self.final_conv(x)
        if self.outer_sample_mode is not None:
            x, _ = self._resize(x, orig_shape, lv)
        return x
