"""The NCSN normalization zoo, in NCHW: conditional and unconditional
InstanceNorm++, InstanceNorm, VarianceNorm, NoneNorm, and the
``get_normalization`` dispatcher.

Counterpart of ``dyffusion_tpu/models/normalization.py``, with the
original reference's parameter names (``alpha``/``gamma``/``beta``, the
conditional variants' ``embed`` table). Instance statistics are per (row,
channel) over the spatial dims with the BIASED variance, eps 1e-5; the "++"
variants standardize the per-channel means across the channels with the
UNBIASED variance; ``VarianceNorm`` divides by the unbiased spatial
standard deviation without subtracting the mean. Scale entries start at
N(1, 0.02), or U[0, 1) in the (conditional) InstanceNorm and NoneNorm
tables; biases at zero. No config of the JAX package reaches the zoo.
"""
from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + EPS)


def _standardized_means(x: torch.Tensor) -> torch.Tensor:
    """The per-channel spatial means, standardized across the channels
    (unbiased variance): (B, C, 1, 1)."""
    means = x.mean(dim=(2, 3))
    v, m = torch.var_mean(means, dim=-1, keepdim=True, unbiased=True)
    return ((means - m) * torch.rsqrt(v + EPS))[:, :, None, None]


def _var_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.var(x, dim=(2, 3), keepdim=True, unbiased=True) + EPS)


def _normal_1_002(*shape) -> torch.Tensor:
    return 1.0 + 0.02 * torch.randn(*shape)


def _table(num_classes: int, num_features: int, n_scale: int, bias: bool, uniform: bool) -> nn.Embedding:
    """An embedding table of ``n_scale`` scale chunks (N(1, 0.02) or
    U[0, 1)) and, with ``bias``, a zero bias chunk."""
    embed = nn.Embedding(num_classes, (n_scale + int(bias)) * num_features)
    with torch.no_grad():
        scales = torch.rand(num_classes, n_scale * num_features) if uniform else _normal_1_002(
            num_classes, n_scale * num_features)
        embed.weight.zero_()
        embed.weight[:, : n_scale * num_features] = scales
    return embed


def _cols(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++: instance norm plus the re-injected, standardized
    channel means: ``gamma * (norm(x) + alpha * means) + beta``."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(_normal_1_002(num_features))
        self.gamma = nn.Parameter(_normal_1_002(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _instance_norm(x) + _standardized_means(x) * self.alpha[:, None, None]
        out = self.gamma[:, None, None] * h
        return out if self.beta is None else out + self.beta[:, None, None]


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Class-conditional InstanceNorm++: (gamma, alpha[, beta]) per class
    from ``embed``."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.bias = bias
        self.embed = _table(num_classes, num_features, 2, bias, uniform=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        parts = self.embed(y.long()).chunk(3 if self.bias else 2, dim=-1)
        h = _instance_norm(x) + _standardized_means(x) * _cols(parts[1])
        out = _cols(parts[0]) * h
        return out + _cols(parts[2]) if self.bias else out


class VarianceNorm2d(nn.Module):
    """Scale-only spatial normalization: ``alpha * x / std(x)``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.alpha = nn.Parameter(_normal_1_002(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha[:, None, None] * _var_norm(x)


class ConditionalVarianceNorm2d(nn.Module):
    """Class-conditional VarianceNorm: the scale per class from ``embed``."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = False):
        super().__init__()
        self.embed = _table(num_classes, num_features, 1, False, uniform=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _cols(self.embed(y.long())) * _var_norm(x)


class ConditionalInstanceNorm2d(nn.Module):
    """Class-conditional instance norm: (gamma[, beta]) per class."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.bias = bias
        self.embed = _table(num_classes, num_features, 1, bias, uniform=True)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _conditional_affine(self.embed(y.long()), _instance_norm(x), self.bias)


class ConditionalNoneNorm2d(nn.Module):
    """Class-conditional affine without normalization."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.bias = bias
        self.embed = _table(num_classes, num_features, 1, bias, uniform=True)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _conditional_affine(self.embed(y.long()), x, self.bias)


def _conditional_affine(emb: torch.Tensor, h: torch.Tensor, bias: bool) -> torch.Tensor:
    if bias:
        gamma, beta = emb.chunk(2, dim=-1)
        return _cols(gamma) * h + _cols(beta)
    return _cols(emb) * h


class NoneNorm2d(nn.Module):
    """Identity."""

    def __init__(self, num_features: int = 0, bias: bool = True):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class InstanceNorm2d(nn.Module):
    """Instance norm without affine parameters."""

    def __init__(self, num_features: int = 0):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _instance_norm(x)


class GroupNorm(nn.GroupNorm):
    """The zoo's GroupNorm: ``min(C // 4, 32)`` groups (at least 1), eps 1e-5."""

    def __init__(self, num_features: int):
        super().__init__(min(num_features // 4, 32) or 1, num_features, eps=1e-5)


def get_normalization(name: str, conditional: bool = False):
    """The normalization class ``name`` ('InstanceNorm', 'InstanceNorm++',
    'VarianceNorm', 'NoneNorm'; unconditionally also 'GroupNorm')."""
    table = {
        "InstanceNorm++": ConditionalInstanceNorm2dPlus,
        "InstanceNorm": ConditionalInstanceNorm2d,
        "VarianceNorm": ConditionalVarianceNorm2d,
        "NoneNorm": ConditionalNoneNorm2d,
    } if conditional else {
        "InstanceNorm": InstanceNorm2d,
        "InstanceNorm++": InstanceNorm2dPlus,
        "VarianceNorm": VarianceNorm2d,
        "NoneNorm": NoneNorm2d,
        "GroupNorm": GroupNorm,
    }
    if name not in table:
        if conditional:
            raise NotImplementedError(f"conditional {name} not implemented")
        raise ValueError(f"Unknown normalization: {name}")
    return table[name]


__all__ = [
    "ConditionalInstanceNorm2d",
    "ConditionalInstanceNorm2dPlus",
    "ConditionalNoneNorm2d",
    "ConditionalVarianceNorm2d",
    "GroupNorm",
    "InstanceNorm2d",
    "InstanceNorm2dPlus",
    "NoneNorm2d",
    "VarianceNorm2d",
    "get_normalization",
]
