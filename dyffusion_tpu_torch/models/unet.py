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

Inside ``parallel.spatial.sharded`` the forward runs on this rank's slab of
the grid (:meth:`Unet._forward_sharded`): halo-exchanged convs (``init_conv``
halo 3, the 3x3 convs halo 1, the stride-2 downsample, the upsample's
source rows), GroupNorm moments summed over the model group, B1 split
across ranks, the mid-block attention against gathered keys and values;
1x1 convs, FiLM, SiLU and the channel norms stay local. Eval only: with
gradients enabled, or with ``outer_sample_mode``, it raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dyffusion_tpu_torch.models.base import concat_condition
from dyffusion_tpu_torch.parallel import spatial
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
            n = self.norm
            return spatial.group_norm(self.proj(x, level), n.num_groups, n.weight, n.bias, n.eps, level)
        return self.norm(self.proj(x))


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
        self.residual_conv = nn.Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else nn.Identity()
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


def remat_call(block: nn.Module, generator: Optional[torch.Generator], *args) -> torch.Tensor:
    """``block(*args, generator)`` under ``torch.utils.checkpoint``: the
    backward recomputes the block's activations instead of keeping them.

    The recompute must see what the forward saw. ``checkpoint`` restores
    only the global RNG states, so the explicit generator's state is taken
    here and the recompute draws from a copy of it: the same dropout masks,
    and the live generator is left as the forward left it. The recompute
    also runs after any ``functional_call`` that substituted the block's
    weights (and buffers) has returned, so it substitutes the tensors the
    forward used."""
    params = {**dict(block.named_buffers()), **dict(block.named_parameters())}
    state = None if generator is None else generator.get_state()
    calls = []

    def run(*inputs):
        calls.append(None)
        if len(calls) == 1:  # the forward
            return block(*inputs, generator)
        replay = None
        if state is not None:
            replay = torch.Generator(device=generator.device)
            replay.set_state(state)
        return torch.func.functional_call(block, params, (*inputs, replay))

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
        self.final_conv = nn.Conv2d(dim, num_output_channels, 1)

    def _resize(self, x: torch.Tensor, size) -> torch.Tensor:
        # half-pixel centres and no antialias, as the JAX package's
        # jax.image.resize(antialias=False): for 'nearest' that is torch's
        # 'nearest-exact'
        if self.outer_sample_mode == "bilinear":
            return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=False)
        return F.interpolate(x, size=size, mode="nearest-exact")

    def _block(self, block: nn.Module, generator: Optional[torch.Generator], *args) -> torch.Tensor:
        """A ResNet or pre-norm attention block, checkpointed under remat
        when gradients are being recorded."""
        if self.remat and torch.is_grad_enabled():
            return remat_call(block, generator, *args)
        return block(*args, generator)

    def forward(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor] = None,
        condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        shard = spatial.current()
        if shard is not None:
            return self._forward_sharded(x, time, condition, generator, shard)
        g, blk = generator, self._block
        x = concat_condition(x, condition, self.num_conditional_channels)
        orig_shape = tuple(x.shape[-2:])
        if self.outer_sample_mode is not None:
            x = self._resize(x, self.upsample_dims)
        x = self.init_conv(x)
        # two independent input-dropout draws
        r = dropout(x, self.input_dropout, generator)
        x = dropout(x, self.input_dropout, generator)
        t = self.time_emb_mlp(time) if self.time_emb_mlp is not None else None

        hs = []
        for block1, block2, attn, resample in self.downs:
            x = blk(block1, g, x, t)
            hs.append(x)
            x = blk(block2, g, x, t)
            x = blk(attn, g, x)
            hs.append(x)
            x = resample(x)

        x = blk(self.mid_block1, g, x, t)
        x = blk(self.mid_attn, g, x)
        x = blk(self.mid_block2, g, x, t)

        for block1, block2, attn, resample in self.ups:
            x = blk(block1, g, torch.cat([x, hs.pop()], dim=1), t)
            x = blk(block2, g, torch.cat([x, hs.pop()], dim=1), t)
            x = blk(attn, g, x)
            x = resample(x)

        x = blk(self.final_res_block, g, torch.cat([x, r], dim=1), t)
        x = self.final_conv(x)
        if self.outer_sample_mode is not None:
            x = self._resize(x, orig_shape)
        return x

    def _forward_sharded(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor],
        condition: Optional[torch.Tensor],
        generator: Optional[torch.Generator],
        shard: spatial.Shard,
    ) -> torch.Tensor:
        """:meth:`forward` on this rank's slab of the grid (see the module
        docstring): every block on the level of its input, each conv that
        reads across rows through the level's halo."""
        if self.outer_sample_mode is not None:
            raise NotImplementedError("the Unet's outer_sample_mode under spatial sharding is not ported "
                                      f"(ROADMAP {spatial.BACKBONES})")
        if torch.is_grad_enabled():
            raise NotImplementedError(f"the Unet's backward under spatial sharding is not ported: run it under "
                                      f"torch.no_grad() (ROADMAP {spatial.TRAINING})")
        g = generator
        x = concat_condition(x, condition, self.num_conditional_channels)
        lv = shard.top()
        c = self.init_conv
        x, lv = spatial.conv2d(x, c.weight, c.bias, lv, padding=c.padding[0])
        r = dropout(x, self.input_dropout, g, lv.slab)
        x = dropout(x, self.input_dropout, g, lv.slab)
        t = self.time_emb_mlp(time) if self.time_emb_mlp is not None else None

        def resample(conv, x, lv):
            if isinstance(conv, Upsample):
                return spatial.upsample_conv(x, conv[1].weight, conv[1].bias, lv)
            return spatial.conv2d(x, conv.weight, conv.bias, lv, stride=conv.stride[0], padding=conv.padding[0])

        hs = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t, g, lv)
            hs.append(x)
            x = block2(x, t, g, lv)
            x = attn(x, g, lv)
            hs.append(x)
            x, lv = resample(down, x, lv)

        x = self.mid_block1(x, t, g, lv)
        x = self.mid_attn(x, g, lv)
        x = self.mid_block2(x, t, g, lv)

        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), t, g, lv)
            x = block2(torch.cat([x, hs.pop()], dim=1), t, g, lv)
            x = attn(x, g, lv)
            x, lv = resample(up, x, lv)

        x = self.final_res_block(torch.cat([x, r], dim=1), t, g, lv)
        return self.final_conv(x)
