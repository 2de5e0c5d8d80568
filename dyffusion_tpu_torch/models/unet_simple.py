"""Simple encoder/decoder UNet ('unet_simple'), the Navier-Stokes backbone, in NCHW.

Counterpart of ``dyffusion_tpu/models/unet_simple.py`` (the nn-benchmark
UNet): an outer bilinear resample of the input to a fixed working grid
(256x256 for NS) and back at exit, a 1x1 input conv, 6 stride-2 conv
encoder blocks and 6 bilinear-x2 + conv decoder blocks with skip concats,
and a k4 s2 transposed-conv readout. Encoder block: conv -> BatchNorm (the
last: GroupNorm(8)) -> FiLM -> LeakyReLU(0.2) -> dropout; decoder block:
bilinear x2 -> conv -> BatchNorm -> FiLM -> ReLU -> dropout. Resizes use
half-pixel centres and no antialias (torch's ``F.interpolate`` with
``align_corners=False``, as ``jax.image.resize(antialias=False)``); the
outer resample takes any method of ``jax.image.resize`` as
``outer_sample_mode`` (``utils.resize``: 'bilinear', the default, and
'nearest' through ``F.interpolate``, the cubic and Lanczos kernels as two
contractions with their weight matrices).

The JAX package computes each decoder's bilinear x2 + conv as one fused
dilated conv (``ops/upfirdn2d.py::bilinear_upsample_conv_2d``), exact to the
pair; here the pair runs as ``nn.Upsample`` + ``nn.Conv2d``. Submodules
carry the original reference's names (``input_ops.{i}.ops.{0,1}``,
``output_ops.{i}.ops.{1,2}``, ``.time_mlp.1``, ``init_conv``,
``readout.0``, ``time_emb_mlp``) and its DCGAN init: conv and transposed-
conv weights ~ N(0, 0.02), BatchNorm scales ~ N(1, 0.02), biases 0.
``remat=True`` checkpoints every block with ``torch.utils.checkpoint``.

Inside ``parallel.spatial.sharded`` the same traversal runs on this rank's
slab of the grid, each block given the ``level`` of its input (``None`` on
one device): the outer resamples through ``spatial.resize`` (taps from
global coordinates), the encoder's strided convs through
``spatial.conv2d``, each decoder's bilinear x2 + conv through
``spatial.upsample_conv`` and the readout through
``spatial.conv_transpose2d``; BatchNorm's batch statistics are the whole
world's (``models/base.py``), the last encoder block's GroupNorm sums its
moments over the model group, dropout keeps the slab of the global mask;
the 1x1 ``init_conv``, FiLM and the activations stay local. Under remat a
block's collectives replay in the forward's order (``unet.remat_call``).

On one device, on CUDA tensors (:func:`channels_last_interior`) of a
concrete batch, the interior runs channels-last: the input, once resampled and concatenated
with the condition, turns ``torch.channels_last`` before ``init_conv``,
and the readout's output turns back to contiguous NCHW before the
resample to the original grid; the weights stay NCHW. The convs then run
natively NHWC in cuDNN, without its per-conv transposes, and each
decoder's bilinear x2 takes ATen's NHWC kernel (one thread per output
element, loads along C) instead of the NCHW one, whose one thread per
output pixel loops over every row and channel. ``forward`` decides the
layout once and hands it to each block; every op between keeps it
(dropout told so, GroupNorm repaired where a backend answers NCHW); the
values are the NCHW computation's up to the convs' order of summation.
The NHWC kernel refuses an output of 2**31 elements or more: such an
upsample, and its conv, run in chunks of rows. A symbolic batch
(``torch.export`` with a polymorphic batch) cannot be cut into a known
number of chunks, so it keeps the whole forward NCHW.
``upsample_channels_last`` and ``upsample_nchw`` count the decoder's
one-device upsamples whose input was channels-last, and the others.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dyffusion_tpu_torch.models.base import BatchNorm2d, Conv2d, norm_call
from dyffusion_tpu_torch.models.modules import PromotingLinear, TimeEmbedder, dropout
from dyffusion_tpu_torch.models.unet import remat_call
from dyffusion_tpu_torch.parallel import spatial
from dyffusion_tpu_torch.utils import resize as resize_ops
from dyffusion_tpu_torch.utils.profiling import span

RELU_LEAK = 0.2

# Decoder bilinear x2 upsamples on one device since the last reset: those
# run channels-last, and the others. The fused upsample + conv of a shard
# counts in neither.
upsample_channels_last = 0
upsample_nchw = 0


def reset_upsamples() -> None:
    global upsample_channels_last, upsample_nchw
    upsample_channels_last = upsample_nchw = 0


# ATen's NHWC bilinear kernel indexes its output with 32-bit ints: it
# refuses an output of this many elements or more
NHWC_UPSAMPLE_LIMIT = 2**31 - 1


def channels_last_interior(x: torch.Tensor) -> bool:
    """Whether a one-device forward on ``x`` of a concrete batch runs its
    interior channels-last: on CUDA tensors. On the CPU oneDNN's channels-last convs sum in another
    order than its NCHW ones, and over three Adam steps that moves an NS
    run on one process past its tolerance against the same run on two
    ranks (``tests/test_torch_port_spatial_physical.py``)."""
    return x.is_cuda


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

    def out_level(self, level: spatial.Level) -> spatial.Level:
        """The level of this block's output for an input of ``level``."""
        if isinstance(self.ops[0], nn.Upsample):
            return level.doubled()
        conv = self.ops[0]
        return level.conv(conv.kernel_size[0], conv.stride[0], conv.padding[0])

    def _upsample_conv(self, x: torch.Tensor, channels_last: bool) -> torch.Tensor:
        """The decoder's bilinear x2 and conv on one device. A channels-last
        input whose upsample would reach :data:`NHWC_UPSAMPLE_LIMIT`
        elements runs in even chunks of rows below it, each upsampled and
        convolved, the conv outputs concatenated (they have fewer channels
        than the upsamples)."""
        up, conv = self.ops[0], self.ops[1]
        n, rows = x.shape[0], max(1, (NHWC_UPSAMPLE_LIMIT - 1) // (4 * math.prod(x.shape[1:])))
        chunked = channels_last and n > rows
        outs = []
        for part in x.tensor_split(-(-n // rows)) if chunked else (x,):
            with span("backbone.upsample"):
                part = up(part)
            outs.append(conv(part))
        return torch.cat(outs) if chunked else outs[0]

    def forward(
        self,
        x: torch.Tensor,
        time_emb: Optional[torch.Tensor] = None,
        batch_stats: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        level: Optional[spatial.Level] = None,
        channels_last: bool = False,
    ) -> torch.Tensor:
        """``channels_last`` (one device only): the interior's layout, as
        ``UNetSimple.forward`` decided it."""
        global upsample_channels_last, upsample_nchw
        conv, norm = self.ops[-2], self.ops[-1]
        if level is None:
            if isinstance(self.ops[0], nn.Upsample):
                if x.is_contiguous(memory_format=torch.channels_last):
                    upsample_channels_last += 1
                else:
                    upsample_nchw += 1
                x = self._upsample_conv(x, channels_last)
            else:
                x = conv(x)
            x = norm_call(norm, x, batch_stats)
            if channels_last:  # CUDA's GroupNorm answers contiguous NCHW
                x = x.contiguous(memory_format=torch.channels_last)
        else:
            out = self.out_level(level)  # what ``UNetSimple._block`` hands the next block
            if isinstance(self.ops[0], nn.Upsample):
                x, level = spatial.upsample_conv(x, conv.weight, conv.bias, level, conv.padding[0], "bilinear")
            else:
                x, level = spatial.conv2d(x, conv.weight, conv.bias, level, conv.stride[0], conv.padding[0])
            assert level == out, f"the block's output is {level}, its out_level {out}"
            if isinstance(norm, nn.GroupNorm):
                with span("backbone.norm"):
                    x = spatial.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps, level)
            else:
                x = norm_call(norm, x, batch_stats)
        if self.time_mlp is not None and time_emb is not None:
            scale, shift = self.time_mlp(time_emb)[:, :, None, None].chunk(2, dim=1)
            # keep x's dtype: the f32 time MLP must not upcast the conv path
            x = x * (scale.to(x.dtype) + 1.0) + shift.to(x.dtype)
        x = F.relu(x) if self.relu else F.leaky_relu(x, RELU_LEAK)
        return dropout(x, self.dropout, generator, None if level is None else level.slab, channels_last)


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
        self.init_conv = Conv2d(num_input_channels + num_conditional_channels, dim, 1)
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

    def _resize(self, x: torch.Tensor, size, level: Optional[spatial.Level]):
        """The outer resample to ``size`` (H, W) by ``outer_sample_mode``,
        ``jax.image.resize``'s method (``utils.resize``), and its level
        (None on one device)."""
        with span("backbone.resize"):
            if level is not None:
                return spatial.resize(x, level, size, resize_ops.mode(self.outer_sample_mode))
            return resize_ops.resize(x, size, self.outer_sample_mode), None

    def _block(self, block, x, t, batch_stats, generator, level: Optional[spatial.Level], channels_last: bool):
        """A block on the level of its input, checkpointed under remat when
        gradients are being recorded; its output and the output's level."""
        if self.remat and torch.is_grad_enabled():
            x = remat_call(block, generator, x, t, batch_stats, level=level, channels_last=channels_last)
        else:
            x = block(x, t, batch_stats, generator, level, channels_last)
        return x, None if level is None else block.out_level(level)

    def forward(
        self,
        x: torch.Tensor,
        time: Optional[torch.Tensor] = None,
        condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        batch_stats: Optional[dict] = None,
    ) -> torch.Tensor:
        shard = spatial.current()
        lv = None if shard is None else shard.top()
        if self.num_conditional_channels > 0:
            assert condition is not None, "model built with conditional channels but condition is None"
            x = torch.cat([x, condition], dim=1)  # inputs first
        else:
            assert condition is None, "condition given but num_conditional_channels == 0"
        t = self.time_emb_mlp(time) if self.time_emb_mlp is not None else None
        orig_shape = tuple(x.shape[-2:]) if shard is None else shard.spatial
        if self.upsample_dims is not None:
            x, lv = self._resize(x, self.upsample_dims, lv)
        # under export a polymorphic batch is symbolic: no chunks can be counted for it
        channels_last = lv is None and isinstance(x.shape[0], int) and channels_last_interior(x)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        # a 1x1 conv: local on a slab
        x = dropout(self.init_conv(x), self.input_dropout, generator, None if lv is None else lv.slab, channels_last)
        skips = []
        for block in self.input_ops:
            x, lv = self._block(block, x, t, batch_stats, generator, lv, channels_last)
            skips.append((x, lv))
        x, lv = skips.pop()
        for block in self.output_ops:
            x, lv = self._block(block, x, t, batch_stats, generator, lv, channels_last)
            if skips:
                x = torch.cat([x, skips.pop()[0]], dim=1)
        readout = self.readout[0]
        if lv is None:
            x = readout(x)
            if channels_last:
                x = x.contiguous()
        else:
            x, lv = spatial.conv_transpose2d(x, readout.weight, readout.bias, lv, readout.stride[0],
                                             readout.padding[0])
        if self.upsample_dims is not None:
            x, _ = self._resize(x, orig_shape, lv)
        return x
