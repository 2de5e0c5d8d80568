"""Fused bias + LeakyReLU with gain (kernel B2).

Counterpart of ``dyffusion_tpu/ops/fused_act.py::fused_leaky_relu``:

    out = leaky_relu(x + bias, negative_slope) * scale,  scale = sqrt(2)

with ``bias`` broadcast over dim 1, the channel axis of NCHW (the original
reference's fused_bias_act op; the JAX package, being NHWC, broadcasts over
the last axis). On a CUDA tensor :func:`fused_leaky_relu` launches the
hand-written kernel in ``csrc/fused_act.cu`` (built on first use by
:mod:`dyffusion_tpu_torch.ops._build`) or raises; it never falls back. On a
CPU tensor it runs :func:`fused_leaky_relu_plain`, the same arithmetic in
plain PyTorch, which is also what the kernel is checked against. Both go
through the ``torch.library`` op ``dyffusion_tpu_torch::fused_leaky_relu``.
The backward replays the plain composition (the JAX package differentiates
its composition too).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional

import torch

SOURCE = "dyffusion_tpu_torch/csrc/fused_act.cu"
REPLACES = "dyffusion_tpu/ops/fused_act.py:54"  # the pl.pallas_call of _pallas_fused_leaky_relu

# Kernel launches since the last reset; bumped only where the kernel is
# launched, so a run can show that it went through the kernel.
launches = 0

_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def fused_leaky_relu_plain(
    x: torch.Tensor, bias: Optional[torch.Tensor] = None, negative_slope: float = 0.2, scale: float = math.sqrt(2.0)
) -> torch.Tensor:
    """Plain PyTorch version: f32 arithmetic (the kernel's numerics), result
    cast back to the input dtype."""
    v = x.float()
    if bias is not None:
        v = v + bias.float().reshape((1, -1) + (1,) * (x.dim() - 2))
    return (torch.where(v >= 0, v, v * negative_slope) * scale).to(x.dtype)


def _is_dense(x: torch.Tensor) -> bool:
    """True when x's elements fill one block of memory in some axis order
    (contiguous, channels-last, any permutation of a contiguous tensor)."""
    expected = 1
    for d in sorted((d for d in range(x.dim()) if x.shape[d] != 1), key=x.stride):
        if x.stride(d) != expected:
            return False
        expected *= x.shape[d]
    return True


def _check(x: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if bias is None:
        return
    if x.dim() < 2 or bias.shape != (x.shape[1],):
        raise ValueError(
            f"bias must be (C,) for the channel axis (dim 1) of x, got bias {tuple(bias.shape)} for x {tuple(x.shape)}"
        )
    if bias.device != x.device:
        raise ValueError(f"bias lies on {bias.device}, x on {x.device}")


def load_width(x: torch.Tensor, out: torch.Tensor) -> int:
    """Elements per load and store of the kernel: the most, up to 16 bytes,
    that both base pointers' alignment allows. Shape and layout do not
    narrow it: a vector may span channels, and the kernel takes the last
    numel % width elements one by one."""
    isz = x.element_size()
    vec = 16 // isz
    while vec > 1 and (x.data_ptr() % (vec * isz) or out.data_ptr() % (vec * isz)):
        vec //= 2
    return vec


def divisor(d: int) -> tuple:
    """(m, s) of the kernel's multiply-shift divide: for 0 <= n < 2**63,
    n // d == (((n * m) >> 64) + n) >> s, with s = ceil(log2 d) and m =
    ceil(2**(64 + s) / d) - 2**64 < 2**64."""
    s = (d - 1).bit_length()
    return -(-(1 << (64 + s)) // d) - (1 << 64), s


# how the kernel finds each element's bias (csrc/fused_act.cu, Mode)
NO_BIAS, RUNS, CHANNELS_LAST = 0, 1, 2


def _check_kernel_args(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_leaky_relu kernel takes float32 or bfloat16, got {x.dtype}")
    if not _is_dense(x):
        raise ValueError(f"fused_leaky_relu kernel takes a dense tensor in any axis order, got strides {x.stride()}")


def _launch(x: torch.Tensor, bias: Optional[torch.Tensor], negative_slope: float, scale: float) -> torch.Tensor:
    global launches, _fn
    _check_kernel_args(x)
    out = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    numel = x.numel()
    if numel == 0:
        return out
    vec = load_width(x, out)
    C, cstride, b, mode = 1, 1, None, NO_BIAS
    if bias is not None:
        if x.shape[1] > 1:
            C, cstride = x.shape[1], x.stride(1)
        b = bias.detach().float().contiguous()  # C floats; a no-op for a contiguous f32 bias
        if b.data_ptr() % 16:
            b = b.clone()  # float4 reads of the bias need 16-byte alignment
        mode = CHANNELS_LAST if cstride == 1 and C % vec == 0 else RUNS
    if _fn is None:
        from dyffusion_tpu_torch.ops._build import load_library

        fn = load_library("fused_act").fused_leaky_relu_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] + [
            ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    args = (x.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16), vec,
            mode, numel, cstride, C, *divisor(cstride), *divisor(C), float(negative_slope), float(scale))
    # the kernel launches on the current device: switch to x's only when it
    # is another
    current = x.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(x.device):
        err = _fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_leaky_relu kernel launch failed: cudaError {err}")
    launches += 1
    return out


# B2 as a torch.library op, so that torch.export records it as one node and
# a traced graph knows its output layout (its fake): x's strides, as the
# kernel writes them; the CPU implementation, the plain version, is given
# the same layout. The backward replays the plain composition:
# grad_x = g * scale * (1 where x + b >= 0, else slope), grad_b = grad_x
# summed over every axis but 1.
@torch.library.custom_op("dyffusion_tpu_torch::fused_leaky_relu", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, bias: Optional[torch.Tensor], negative_slope: float, scale: float) -> torch.Tensor:
    out = fused_leaky_relu_plain(x, bias, negative_slope, scale)
    like = torch.empty_like(x)
    return out if out.stride() == like.stride() else like.copy_(out)


_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _(x, bias, negative_slope, scale):
    if x.device.type == "cuda":
        _check_kernel_args(x)
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    x, bias, *ctx.args = inputs
    ctx.save_for_backward(x, bias)


def _backward(ctx, grad):
    x, bias = ctx.saved_tensors
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True)]
        if bias is not None:
            xs.append(bias.detach().requires_grad_(True))
        out = fused_leaky_relu_plain(xs[0], xs[1] if bias is not None else None, *ctx.args)
        grads = torch.autograd.grad(out, xs, grad)
    return grads[0], (grads[1] if bias is not None else None), None, None


_op.register_autograd(_backward, setup_context=_setup)


def fused_leaky_relu(
    x: torch.Tensor, bias: Optional[torch.Tensor] = None, negative_slope: float = 0.2, scale: float = math.sqrt(2.0)
) -> torch.Tensor:
    """leaky_relu(x + bias, negative_slope) * scale, ``bias`` (C,) over dim 1;
    the op ``dyffusion_tpu_torch::fused_leaky_relu``.

    CUDA tensor: the B2 kernel (float32 or bfloat16, any dense layout; the
    output keeps x's strides), or an error. CPU tensor: the plain version,
    in the same layout. Differentiable either way."""
    _check(x, bias)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_leaky_relu takes CPU or CUDA tensors, got device {x.device}")
    return _op(x, bias, float(negative_slope), float(scale))
