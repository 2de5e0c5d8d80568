"""'qkv'-rescale linear attention: kernels B1 and B3.

Counterparts of ``dyffusion_tpu/ops/pallas_attention.py``:

- :func:`linear_attention_qkv` (B1, ``linear_attention_qkv`` there) on the
  to_qkv projection laid out as (B, N, 3*heads*dim_head);
- :func:`linear_attention_core` (B3, ``linear_attention_core`` there) on
  separate per-(batch*head) q, k, v of shape (BH, dim_head, N).

Per batch element and head:

    q' = softmax over dim_head (per token) * scale;  k' = softmax over tokens;
    v' = v / N;  context = k'^T v' (d x d);  out = q' context

Both run the one hand-written kernel in ``csrc/linear_attention.cu`` (built
on first use by :mod:`dyffusion_tpu_torch.ops._build`): B1 reads q, k and v
as the channel thirds of one tensor, B3 as three tensors of one layout with
heads = 1. On a CUDA tensor each wrapper launches the kernel or raises; it
never falls back. On a CPU tensor it runs its plain version, the same
arithmetic in plain PyTorch, which is also what the kernel is checked
against. Each backward replays the plain composition, as the JAX package's
``_pallas_qkv_bwd`` and ``_pallas_core_bwd`` replay their XLA references.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "dyffusion_tpu_torch/csrc/linear_attention.cu"
REPLACES = "dyffusion_tpu/ops/pallas_attention.py:181"  # the pl.pallas_call of _pallas_qkv
CORE_REPLACES = "dyffusion_tpu/ops/pallas_attention.py:293"  # the pl.pallas_call of _pallas_core_impl
KERNEL_DIM_HEAD = 32  # the kernel holds one head's channels in one warp

# Kernel launches since the last reset, B1 (``launches``) and B3
# (``core_launches``); bumped only where the kernel is launched, so a run can
# show that it went through the kernel.
launches = 0
core_launches = 0

_fn = None


def reset_launches() -> None:
    global launches, core_launches
    launches = core_launches = 0


def linear_attention_qkv_plain(qkv: torch.Tensor, heads: int, dim_head: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of B1: f32 softmaxes and products (the kernel's
    numerics), result cast back to the input dtype. Any strides."""
    B, N, F = qkv.shape
    x = qkv.float().reshape(B, N, 3, heads, dim_head)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]  # (B, N, h, d)
    q = torch.softmax(q, dim=-1) * scale
    k = torch.softmax(k, dim=1)
    v = v / N
    context = torch.einsum("bnhd,bnhe->bhde", k, v)
    out = torch.einsum("bnhd,bhde->bnhe", q, context)
    return out.reshape(B, N, heads * dim_head).to(qkv.dtype)


def linear_attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of B3 (the JAX package's ``_core_reference``) in
    f32, result cast back to the input dtype: (BH, d, N) -> (BH, d, N)."""
    N = q.shape[-1]
    qf = torch.softmax(q.float(), dim=-2) * scale
    kf = torch.softmax(k.float(), dim=-1)
    vf = v.float() / N
    context = torch.einsum("bdn,ben->bde", kf, vf)
    return torch.einsum("bde,bdn->ben", context, qf).to(q.dtype)


def _check(qkv: torch.Tensor, heads: int, dim_head: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * heads * dim_head:
        raise ValueError(
            f"qkv must be (B, N, 3*heads*dim_head) = (B, N, {3 * heads * dim_head}), got {tuple(qkv.shape)}"
        )
    if qkv.shape[0] == 0 or qkv.shape[1] == 0:
        raise ValueError(f"qkv must have a non-empty batch and token axis, got {tuple(qkv.shape)}")


def _check_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must be three (BH, d, N) tensors of one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[0] == 0 or q.shape[2] == 0:
        raise ValueError(f"q, k, v must have a non-empty batch and token axis, got {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must share one dtype and one device")
    if q.device.type == "cuda" and not (k.stride() == q.stride() == v.stride()):
        raise ValueError(
            f"the linear attention kernel takes q, k, v of one layout, got strides {q.stride()}, {k.stride()}, {v.stride()}"
        )


def _launch(q, k, v, out, packed: bool, B: int, N: int, heads: int, dim_head: int, strides, scale: float) -> None:
    """Launch the kernel. ``packed``: q is the (B, N, 3*heads*dim_head)
    projection holding k and v too. ``strides`` holds the (batch, token,
    channel) element strides of the inputs (one layout for q, k and v), then
    of out."""
    global _fn
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the linear attention kernel takes float32 or bfloat16, got {q.dtype}")
    if dim_head != KERNEL_DIM_HEAD:
        raise ValueError(f"the linear attention kernel takes dim_head={KERNEL_DIM_HEAD}, got {dim_head}")
    if any(s < 0 for s in strides):
        raise ValueError(f"the linear attention kernel takes non-negative strides, got {strides}")
    if _fn is None:
        from dyffusion_tpu_torch.ops._build import load_library

        fn = load_library("linear_attention").linear_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 6 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), int(packed), int(q.dtype == torch.bfloat16),
            B, N, heads, dim_head, *strides, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"linear attention kernel launch failed: cudaError {err}")


def _launch_qkv(qkv: torch.Tensor, heads: int, dim_head: int, scale: float) -> torch.Tensor:
    global launches
    B, N, _ = qkv.shape
    hd = heads * dim_head
    # the output keeps the input's axis order: tokens fastest for the NCHW
    # view of a 1x1-conv output (so it is itself an NCHW tensor), channels
    # fastest otherwise
    if qkv.stride(1) == 1 and N > 1:
        out = torch.empty((B, hd, N), dtype=qkv.dtype, device=qkv.device).transpose(1, 2)
    else:
        out = torch.empty((B, N, hd), dtype=qkv.dtype, device=qkv.device)
    # q, k, v are the three thirds of the channel axis of qkv
    _launch(qkv, qkv, qkv, out, True, B, N, heads, dim_head, qkv.stride() + out.stride(), scale)
    launches += 1
    return out


def _launch_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    global core_launches
    BH, d, N = q.shape
    out = torch.empty((BH, d, N), dtype=q.dtype, device=q.device)

    def bnc(t):  # (batch, token, channel) strides of a (BH, d, N) tensor
        return t.stride(0), t.stride(2), t.stride(1)

    _launch(q, k, v, out, False, BH, N, 1, d, bnc(q) + bnc(out), scale)
    core_launches += 1
    return out


class _LinearAttentionQKV(torch.autograd.Function):
    """B1 forward; the backward replays the plain composition, as the JAX
    package's ``_pallas_qkv_bwd`` replays ``_xla_qkv``."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head, scale):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, dim_head, scale)
        return _launch_qkv(qkv, heads, dim_head, scale)

    @staticmethod
    def backward(ctx, grad):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            out = linear_attention_qkv_plain(x, *ctx.args)
            (g,) = torch.autograd.grad(out, x, grad)
        return g, None, None, None


class _LinearAttentionCore(torch.autograd.Function):
    """B3 forward; the backward replays the plain composition, as the JAX
    package's ``_pallas_core_bwd`` replays ``_core_reference``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch_core(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = linear_attention_core_plain(*xs, ctx.scale)
            grads = torch.autograd.grad(out, xs, grad)
        return (*grads, None)


def linear_attention_qkv(qkv: torch.Tensor, heads: int, dim_head: int, scale: float) -> torch.Tensor:
    """(B, N, 3*heads*dim_head) -> (B, N, heads*dim_head).

    CUDA tensor: the B1 kernel (any non-negative strides; float32 or
    bfloat16; dim_head 32), or an error. CPU tensor: the plain version.
    Differentiable either way."""
    _check(qkv, heads, dim_head)
    if qkv.device.type == "cuda":
        return _LinearAttentionQKV.apply(qkv, heads, dim_head, scale)
    if qkv.device.type == "cpu":
        return linear_attention_qkv_plain(qkv, heads, dim_head, scale)
    raise ValueError(f"linear_attention_qkv takes CPU or CUDA tensors, got device {qkv.device}")


def linear_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v (BH, d, N) -> out (BH, d, N), the linear-attention core per
    (batch*head).

    CUDA tensors: the B3 kernel (any non-negative strides; float32 or
    bfloat16; d = 32), or an error. CPU tensors: the plain version.
    Differentiable either way."""
    _check_core(q, k, v)
    if q.device.type == "cuda":
        return _LinearAttentionCore.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return linear_attention_core_plain(q, k, v, scale)
    raise ValueError(f"linear_attention_core takes CPU or CUDA tensors, got device {q.device}")
