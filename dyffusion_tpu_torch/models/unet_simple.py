"""Simple encoder/decoder UNet ('unet_simple'), the Navier-Stokes backbone, in NCHW.

Counterpart of ``dyffusion_tpu/models/unet_simple.py`` (the nn-benchmark
UNet): an outer bilinear resample of the input to a fixed working grid
(256x256 for NS) and back at exit, a 1x1 input conv, 6 stride-2 conv
encoder blocks and 6 bilinear-x2 + conv decoder blocks with skip concats,
and a k4 s2 transposed-conv readout. Encoder block: conv -> BatchNorm (the
last: GroupNorm(8)) -> FiLM -> LeakyReLU(0.2) -> dropout; decoder block:
bilinear x2 -> conv -> BatchNorm -> FiLM -> ReLU -> dropout. Resizes use
half-pixel centres and no antialias (torch's ``F.interpolate`` with
``align_corners=False``, as ``jax.image.resize(antialias=False)``).

The JAX package computes each decoder's bilinear x2 + conv as one fused
dilated conv (``ops/upfirdn2d.py::bilinear_upsample_conv_2d``), exact to the
pair; here the pair runs as ``nn.Upsample`` + ``nn.Conv2d``. Submodules
carry the original reference's names (``input_ops.{i}.ops.{0,1}``,
``output_ops.{i}.ops.{1,2}``, ``.time_mlp.1``, ``init_conv``,
``readout.0``, ``time_emb_mlp``) and its DCGAN init: conv and transposed-
conv weights ~ N(0, 0.02), BatchNorm scales ~ N(1, 0.02), biases 0.
``remat=True`` checkpoints every block with ``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dyffusion_tpu_torch.models.base import BatchNorm2d, norm_call
from dyffusion_tpu_torch.models.modules import PromotingLinear, TimeEmbedder, dropout
from dyffusion_tpu_torch.models.unet import remat_call

RELU_LEAK = 0.2


class UNetBlock(nn.Module):
    """One encoder (stride-2 conv) or decoder (bilinear x2 + conv) block."""

    def __init__(
        self,
        dim_in: int,
        dim_out: int,
        transposed: bool = False,
        bn: bool = True,
        relu: bool = True,
        size: int = 4,
        pad: int = 1,
        dropout: float = 0.0,
        time_emb_dim: Optional[int] = None,
    ):
        super().__init__()
        if not transposed:
            ops = [nn.Conv2d(dim_in, dim_out, size, stride=2, padding=pad)]
        else:
            ops = [
                nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
                nn.Conv2d(dim_in, dim_out, size - 1, stride=1, padding=pad),
            ]
        ops.append(BatchNorm2d(dim_out) if bn else nn.GroupNorm(8, dim_out, eps=1e-5))
        self.ops = nn.ModuleList(ops)
        self.time_mlp = nn.Sequential(nn.SiLU(), PromotingLinear(time_emb_dim, dim_out * 2)) if time_emb_dim else None
        self.relu = relu
        self.dropout = float(dropout)

    def forward(
        self,
        x: torch.Tensor,
        time_emb: Optional[torch.Tensor] = None,
        batch_stats: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        for op in self.ops[:-1]:
            x = op(x)
        x = norm_call(self.ops[-1], x, batch_stats)
        if self.time_mlp is not None and time_emb is not None:
            scale, shift = self.time_mlp(time_emb)[:, :, None, None].chunk(2, dim=1)
            # keep x's dtype: the f32 time MLP must not upcast the conv path
            x = x * (scale.to(x.dtype) + 1.0) + shift.to(x.dtype)
        x = F.relu(x) if self.relu else F.leaky_relu(x, RELU_LEAK)
        return dropout(x, self.dropout, generator)


class UNetSimple(nn.Module):
    """The 'unet_simple' backbone. Called as ``model(x, time=None,
    condition=None, generator=None, batch_stats=None)``; the condition is
    concatenated after the inputs."""

    def __init__(
        self,
        dim: int,
        num_input_channels: int,
        num_output_channels: int,
        num_conditional_channels: int = 0,
        with_time_emb: bool = False,
        outer_sample_mode: str = "bilinear",
        upsample_dims: Optional[Tuple[int, int]] = (256, 256),
        dropout: float = 0.0,
        input_dropout: float = 0.0,
        remat: bool = False,
    ):
        super().__init__()
        self.num_conditional_channels = num_conditional_channels
        self.outer_sample_mode = outer_sample_mode
        self.upsample_dims = tuple(upsample_dims) if upsample_dims is not None else None
        self.input_dropout = float(input_dropout)
        self.remat = bool(remat)
        self.init_conv = nn.Conv2d(num_input_channels + num_conditional_channels, dim, 1)
        self.time_emb_mlp = TimeEmbedder(dim * 2, dim) if with_time_emb else None
        t_dim = dim * 2 if with_time_emb else None
        d = dim
        kw = dict(dropout=dropout, time_emb_dim=t_dim)
        self.input_ops = nn.ModuleList([
            UNetBlock(d, d * 2, bn=True, relu=False, **kw),
            UNetBlock(d * 2, d * 2, bn=True, relu=False, **kw),
            UNetBlock(d * 2, d * 4, bn=True, relu=False, **kw),
            UNetBlock(d * 4, d * 8, bn=True, relu=False, size=4, **kw),
            UNetBlock(d * 8, d * 8, bn=True, relu=False, size=2, pad=0, **kw),
            UNetBlock(d * 8, d * 8, bn=False, relu=False, size=2, pad=0, **kw),
        ])
        # decoder inputs: the previous block's output, then the skip concatenated to it
        self.output_ops = nn.ModuleList([
            UNetBlock(d * 8, d * 8, transposed=True, bn=True, relu=True, size=2, pad=0, **kw),
            UNetBlock(d * 16, d * 8, transposed=True, bn=True, relu=True, size=2, pad=0, **kw),
            UNetBlock(d * 16, d * 4, transposed=True, bn=True, relu=True, **kw),
            UNetBlock(d * 8, d * 2, transposed=True, bn=True, relu=True, **kw),
            UNetBlock(d * 4, d * 2, transposed=True, bn=True, relu=True, **kw),
            UNetBlock(d * 4, d, transposed=True, bn=True, relu=True, **kw),
        ])
        # k4 s2 p1 transposed conv: an exact x2 upsample (flax's padding "SAME")
        self.readout = nn.Sequential(nn.ConvTranspose2d(d, num_output_channels, 4, stride=2, padding=1))
        self._dcgan_init()

    @torch.no_grad()
    def _dcgan_init(self) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.normal_(0.0, 0.02)
                m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.normal_(1.0, 0.02)
                m.bias.zero_()

    def _resize(self, x: torch.Tensor, size) -> torch.Tensor:
        return F.interpolate(x, size=tuple(size), mode=self.outer_sample_mode, align_corners=False, antialias=False)

    def _block(self, block, x, t, batch_stats, generator) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return remat_call(block, generator, x, t, batch_stats)
        return block(x, t, batch_stats, generator)

    def forward(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor] = None,
        condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        batch_stats: Optional[dict] = None,
    ) -> torch.Tensor:
        if self.num_conditional_channels > 0:
            assert condition is not None, "model built with conditional channels but condition is None"
            x = torch.cat([x, condition], dim=1)  # inputs first
        else:
            assert condition is None, "condition given but num_conditional_channels == 0"
        t = self.time_emb_mlp(time) if self.time_emb_mlp is not None else None
        orig_shape = tuple(x.shape[-2:])
        if self.upsample_dims is not None:
            x = self._resize(x, self.upsample_dims)
        x = dropout(self.init_conv(x), self.input_dropout, generator)
        skips = []
        for block in self.input_ops:
            x = self._block(block, x, t, batch_stats, generator)
            skips.append(x)
        x = skips.pop()
        for block in self.output_ops:
            x = self._block(block, x, t, batch_stats, generator)
            if skips:
                x = torch.cat([x, skips.pop()], dim=1)
        x = self.readout(x)
        if self.upsample_dims is not None:
            x = self._resize(x, orig_shape)
        return x
