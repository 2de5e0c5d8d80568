"""The RefineNet block zoo of NCSN, in NCHW: chained residual pooling
(``CRPBlock``), residual conv units (``RCUBlock``), multi-scale fusion
(``MSFBlock``), the ``RefineBlock`` that composes them, and their
class-conditional ``Cond*`` variants, which put a conditional normalizer
of :mod:`dyffusion_tpu_torch.models.normalization` before each conv.

Counterpart of ``dyffusion_tpu/models/refinenet.py``, with the original
reference's submodule names (``convs.{i}``, ``norms.{i}``,
``{i}_{j}_conv``, ``adapt_convs``, ``msf``, ``crp``, ``output_convs``).
Torch needs the input channels up front, so the blocks take them as the
reference's constructors do (``in_planes``). The 5x5 stride-1 average pool
counts the zero padding (torch's default, as the JAX package computes it);
the fusion's resize is bilinear with aligned corners
(:func:`resize_bilinear_align_corners`). No config of the JAX package
reaches the zoo.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def ncsn_conv3x3(c_in: int, c_out: int, bias: bool) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, padding=1, bias=bias)


def resize_bilinear_align_corners(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to ``shape`` with aligned corners."""
    return F.interpolate(x, size=tuple(shape), mode="bilinear", align_corners=True)


def _pool5(x: torch.Tensor, maxpool: bool) -> torch.Tensor:
    if maxpool:
        return F.max_pool2d(x, 5, stride=1, padding=2)
    return F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)


class CRPBlock(nn.Module):
    """Chained residual pooling: ``n_stages`` of pool -> conv, each added
    to the activated input."""

    def __init__(self, features: int, n_stages: int = 2, act: Callable = F.relu, maxpool: bool = True):
        super().__init__()
        self.convs = nn.ModuleList(ncsn_conv3x3(features, features, False) for _ in range(n_stages))
        self.act, self.maxpool = act, maxpool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(_pool5(path, self.maxpool))
            x = path + x
        return x


class CondCRPBlock(nn.Module):
    """Conditional CRP: the normalizer before each (average) pool."""

    def __init__(self, features: int, n_stages: int, num_classes: int, normalizer, act: Callable = F.relu):
        super().__init__()
        self.convs = nn.ModuleList(ncsn_conv3x3(features, features, False) for _ in range(n_stages))
        self.norms = nn.ModuleList(normalizer(features, num_classes, bias=True) for _ in range(n_stages))
        self.act = act

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for norm, conv in zip(self.norms, self.convs):
            path = conv(_pool5(norm(path, y), maxpool=False))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units: ``n_blocks`` of (act -> conv) x ``n_stages`` + skip."""

    def __init__(self, features: int, n_blocks: int = 2, n_stages: int = 2, act: Callable = F.relu):
        super().__init__()
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_conv", ncsn_conv3x3(features, features, False))
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class CondRCUBlock(nn.Module):
    """Conditional RCU: (norm -> act -> conv) x ``n_stages`` + skip."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, num_classes: int, normalizer,
                 act: Callable = F.relu):
        super().__init__()
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_norm", normalizer(features, num_classes, bias=True))
                setattr(self, f"{i + 1}_{j + 1}_conv", ncsn_conv3x3(features, features, False))
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_norm")(x, y)
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: a biased 3x3 conv per input, each resized to
    ``shape``, summed."""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.convs = nn.ModuleList(ncsn_conv3x3(c, features, True) for c in in_planes)

    def forward(self, xs: Sequence[torch.Tensor], shape: Tuple[int, int]) -> torch.Tensor:
        return sum(resize_bilinear_align_corners(conv(x), shape) for conv, x in zip(self.convs, xs))


class CondMSFBlock(nn.Module):
    """Conditional MSF: the normalizer before each input's conv."""

    def __init__(self, in_planes: Sequence[int], features: int, num_classes: int, normalizer):
        super().__init__()
        self.convs = nn.ModuleList(ncsn_conv3x3(c, features, True) for c in in_planes)
        self.norms = nn.ModuleList(normalizer(c, num_classes, bias=True) for c in in_planes)

    def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
        return sum(resize_bilinear_align_corners(conv(norm(x, y)), shape)
                   for norm, conv, x in zip(self.norms, self.convs, xs))


class RefineBlock(nn.Module):
    """RCU adaptation per input -> multi-scale fusion (several inputs) ->
    CRP -> output RCU (3 blocks at the ``end``, else 1)."""

    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu, start: bool = False,
                 end: bool = False, maxpool: bool = True):
        super().__init__()
        self.adapt_convs = nn.ModuleList(RCUBlock(c, 2, 2, act) for c in in_planes)
        self.msf = MSFBlock(in_planes, features) if len(in_planes) > 1 else None
        self.crp = CRPBlock(features, 2, act, maxpool)
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act)

    def forward(self, xs: Sequence[torch.Tensor], output_shape: Tuple[int, int]) -> torch.Tensor:
        hs = [adapt(x) for adapt, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, output_shape) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h))


class CondRefineBlock(nn.Module):
    """:class:`RefineBlock` with the conditional blocks."""

    def __init__(self, in_planes: Sequence[int], features: int, num_classes: int, normalizer,
                 act: Callable = F.relu, start: bool = False, end: bool = False):
        super().__init__()
        self.adapt_convs = nn.ModuleList(CondRCUBlock(c, 2, 2, num_classes, normalizer, act) for c in in_planes)
        self.msf = CondMSFBlock(in_planes, features, num_classes, normalizer) if len(in_planes) > 1 else None
        self.crp = CondCRPBlock(features, 2, num_classes, normalizer, act)
        self.output_convs = CondRCUBlock(features, 3 if end else 1, 2, num_classes, normalizer, act)

    def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor, output_shape: Tuple[int, int]) -> torch.Tensor:
        hs = [adapt(x, y) for adapt, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, y, output_shape) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h, y), y)
