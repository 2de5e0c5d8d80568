"""upfirdn2d (upsample, FIR filter, downsample) and the FIR resampling
helpers of NCSN++, in NCHW.

Counterpart of ``dyffusion_tpu/ops/upfirdn2d.py`` (``setup_fir_kernel``,
``upfirdn2d``, ``upsample_2d``, ``downsample_2d``, ``upsample_conv_2d``,
``conv_downsample_2d``). The JAX package computes these as XLA convs, not
as a Pallas kernel, so here they are library convs too: a depthwise
``F.conv2d`` (``groups=C``) for the FIR, ``F.conv_transpose2d`` and a
strided ``F.conv2d`` for the fused resampling convs.

Semantics (the original reference's ``upfirdn2d_native``): append ``up-1``
zeros after each sample (length ``in * up``), pad both spatial dims by
``(pad0, pad1)`` (a negative pad crops), correlate with the FLIPPED FIR
kernel, keep every ``down``-th sample. Torch has no ``lhs_dilation``, so the
zeros are stuffed explicitly with a view and a pad.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IntPair = Union[int, Tuple[int, int]]


def setup_fir_kernel(k: Union[Sequence[float], np.ndarray, None], gain: float = 1.0) -> np.ndarray:
    """A (possibly separable 1-D) FIR kernel as 2-D f32, normalized to sum
    ``gain``. ``None`` is the box [1, 1]."""
    if k is None:
        k = [1.0] * 2
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    return k * gain


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def upfirdn2d(
    x: torch.Tensor,
    kernel: Union[torch.Tensor, np.ndarray],
    up: IntPair = 1,
    down: IntPair = 1,
    pad: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Upsample (zero-stuff), FIR-filter and downsample ``x`` (B, C, H, W).

    ``kernel``: (kh, kw) FIR taps. ``up``/``down``: an int or (y, x)
    factors. ``pad``: (pad0, pad1) on both spatial dims after the
    zero-stuffing; negative values crop."""
    up_y, up_x = _pair(up)
    down_y, down_x = _pair(down)
    pad0, pad1 = pad
    B, C, H, W = x.shape
    if up_y > 1 or up_x > 1:
        z = x.reshape(B, C, H, 1, W, 1)
        z = F.pad(z, (0, up_x - 1, 0, 0, 0, up_y - 1))
        x = z.reshape(B, C, H * up_y, W * up_x)
    x = F.pad(x, (pad0, pad1, pad0, pad1))  # negative entries crop
    k = torch.as_tensor(np.asarray(kernel) if not isinstance(kernel, torch.Tensor) else kernel)
    k = torch.flip(k.to(device=x.device, dtype=x.dtype), (0, 1))
    w = k[None, None].expand(C, 1, *k.shape)
    return F.conv2d(x, w, stride=(down_y, down_x), groups=C)


def upsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR-filtered ``factor``-x upsampling."""
    assert factor >= 1
    k = setup_fir_kernel(k, gain * (factor**2))
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR-filtered ``factor``-x downsampling."""
    assert factor >= 1
    k = setup_fir_kernel(k, gain)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Transposed-conv upsampling followed by the FIR correction filter.

    ``w`` is a conv weight (O, I, kh, kw). The JAX package correlates the
    ``factor``-dilated input with its HWIO kernel as it is
    (``lax.conv_transpose(transpose_kernel=False)``); torch's transposed
    conv convolves, so it gets the taps flipped, in its (I, O, kh, kw)
    layout."""
    assert factor >= 1
    kw = w.shape[3]
    k = setup_fir_kernel(k, gain * (factor**2))
    p = (k.shape[0] - factor) - (kw - 1)
    out = F.conv_transpose2d(x, torch.flip(w, (2, 3)).transpose(0, 1), stride=factor)
    return upfirdn2d(out, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR filter, then a ``factor``-strided VALID conv with ``w`` (O, I, kh, kw)."""
    assert factor >= 1
    k = setup_fir_kernel(k, gain)
    p = (k.shape[0] - factor) + (w.shape[3] - 1)
    x = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w, stride=factor)
