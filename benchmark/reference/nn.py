"""Plain building blocks of the reference networks: convs, norms, dropout.

Everything is functional over a flat state dict ``P`` keyed by the original
DYffusion reference's parameter names, in float32 with TF32 off (the caller
sets the backends). A :class:`Numerics` says which precision the
configuration states (the eps of the weight-standardized convs and the
channel LayerNorm follow the dtype the network runs in, as in the original
code: 1e-5 in float32, 1e-3 otherwise) and whether the operands of every
conv and matmul are rounded to fp8 (e4m3, one scale per tensor), and in a
backward their output gradients (e5m2): the precision control, the
nearest step below bfloat16.

Dropout draws ``torch.rand(x.shape, generator=g)`` in the network's order,
so a generator seeded as the system under test seeds its own draws the
same masks: the ensemble members are part of the result.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
E4M3_MAX, E5M2_MAX = 448.0, 57344.0  # the largest finite float8_e4m3fn and float8_e5m2


def _fp8(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` with one scale for the tensor (its largest
    magnitude maps to ``largest``), back in ``x``'s dtype."""
    scale = largest / x.abs().amax().clamp_min(1e-12)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _GradToE5M2(torch.autograd.Function):
    """Identity forward; the gradient rounded to fp8 e5m2 backward, as an
    fp8 training step's backward GEMMs take their output gradients."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


@dataclass(frozen=True)
class Numerics:
    """``low_eps``: the network runs in a 16-bit dtype (eps 1e-3 in the
    weight standardization and the channel LayerNorm); ``fp8``: every conv
    and matmul computed on fp8 operands, forward and backward."""

    low_eps: bool = False
    fp8: bool = False

    @property
    def eps(self) -> float:
        return 1e-3 if self.low_eps else 1e-5

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A GEMM operand as an fp8 e4m3 tensor would hold it, or ``x``
        itself; the gradient passes the rounding straight through."""
        if not self.fp8:
            return x
        return x + (_fp8(x.detach(), torch.float8_e4m3fn, E4M3_MAX) - x.detach())

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A GEMM's output, whose gradient the backward GEMMs take rounded
        to fp8 e5m2, or ``y`` itself."""
        return _GradToE5M2.apply(y) if self.fp8 and y.requires_grad else y


def conv2d(num: Numerics, x, w, b=None, stride=1, padding=0):
    return num.out(F.conv2d(num.q(x), num.q(w), b, stride=stride, padding=padding))


def conv_transpose2d(num: Numerics, x, w, b=None, stride=1, padding=0):
    return num.out(F.conv_transpose2d(num.q(x), num.q(w), b, stride=stride, padding=padding))


def linear(num: Numerics, x, w, b=None):
    return num.out(F.linear(num.q(x), num.q(w), b))


def einsum(num: Numerics, eq: str, a, b):
    return num.out(torch.einsum(eq, num.q(a), num.q(b)))


def dropout(x: torch.Tensor, p: float, g: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - p, scale by 1 / (1 - p).
    No generator or p = 0: no draw."""
    if g is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def ws_conv(num: Numerics, P: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    """Weight-standardized 3x3 conv ('same' padding)."""
    w = P[pre + ".weight"]
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    w = (w - mean) * torch.rsqrt(var + num.eps)
    return conv2d(num, x, w, P[pre + ".bias"], padding=w.shape[-1] // 2)


def group_norm(P: Params, pre: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    return F.group_norm(x, groups, P[pre + ".weight"], P[pre + ".bias"], eps=1e-5)


def channel_layer_norm(num: Numerics, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + num.eps) * g


def batch_norm_eval(P: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm on its running averages (every inference call)."""
    return F.batch_norm(x, P[pre + ".running_mean"], P[pre + ".running_var"], P[pre + ".weight"],
                        P[pre + ".bias"], False, 0.0, 1e-5)


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def time_mlp(num: Numerics, P: Params, pre: str, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding -> Linear -> exact GELU -> Linear."""
    h = linear(num, sinusoidal_embedding(t, dim), P[pre + ".1.weight"], P[pre + ".1.bias"])
    h = F.gelu(h)
    return linear(num, h, P[pre + ".3.weight"], P[pre + ".3.bias"])


def film(num: Numerics, P: Params, pre: str, h: torch.Tensor, t: Optional[torch.Tensor]) -> torch.Tensor:
    """h * (scale + 1) + shift from SiLU -> Linear of the time embedding."""
    if t is None or pre + ".1.weight" not in P:
        return h
    ss = linear(num, F.silu(t), P[pre + ".1.weight"], P[pre + ".1.bias"])[:, :, None, None]
    scale, shift = ss.chunk(2, dim=1)
    return h * (scale + 1.0) + shift
