"""'qkv'-rescale linear attention: kernels B1 and B3.

Counterparts of ``dyffusion_tpu/ops/pallas_attention.py``:

- :func:`linear_attention_qkv` (B1, ``linear_attention_qkv`` there) on the
  to_qkv projection laid out as (B, N, 3*heads*dim_head);
- :func:`linear_attention_core` (B3, ``linear_attention_core`` there) on
  separate per-(batch*head) q, k, v of shape (BH, dim_head, N).

Per batch element and head:

    q' = softmax over dim_head (per token) * scale;  k' = softmax over tokens;
    v' = v / N;  context = k'^T v' (d x d);  out = q' context

Both run the hand-written kernels of ``csrc/linear_attention_qkv.cu``
(built on first use by :mod:`dyffusion_tpu_torch.ops._build`) in two
launches: a partial pass over S chunks of the tokens per (batch, head), then
a pass that merges the chunks and writes the output, S' blocks per (batch,
head) (:func:`split_counts`). The kernels read q, k and v from three base
pointers of one layout: B1 passes the channel thirds of its one tensor, B3
its three tensors as heads = 1 and batch = BH. Each wrapper calls a
``torch.library`` op (``dyffusion_tpu_torch::linear_attention_qkv``,
``::linear_attention_core``), which ``torch.export`` records as one node.
On a CUDA tensor the op launches the kernels or raises; it never falls
back. On a CPU tensor it runs its plain version, the same arithmetic in
plain PyTorch, which is also what the kernel is checked against. Each
backward replays the plain composition, as the JAX package's
``_pallas_qkv_bwd`` and ``_pallas_core_bwd`` replay their XLA references.

:func:`linear_attention_qkv_split` is B1 with the tokens split across the
ranks of a process group (spatial sharding): q's softmax stays per token,
k's softmax over the tokens and the context sum span every rank's tokens,
and v / N takes the global N. Its kernel path runs the partial pass over
the rank's tokens, merges the chunks into one partial per (batch, head) at
the global maximum (an ``all_reduce`` of the max between the merge's two
calls), sums that partial over the group (one ``all_reduce`` of
B*heads*(32*32 + 2*32) floats) and runs the output pass over the rank's
tokens from it. Its plain version is the same arithmetic in PyTorch over
the same collectives. Its backward replays the plain version on the
rank's tokens at the forward's global maximum (a shift that the softmax
cancels: it gets no gradient) with differentiable sums, whose backward sums
the context's and the normaliser's gradients over the group: the split
counterpart of ``_pallas_qkv_bwd``. Every rank of the group runs it.
A rank of no tokens (a level of fewer rows than ranks) launches neither
pass: the merge, launched with no chunk, writes its maxima as -inf and its
partial as zeros, which the all_reduces take as they are, and its output
is (B, 0, heads*dim_head); its plain version does the same.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

SOURCE = "dyffusion_tpu_torch/csrc/linear_attention_qkv.cu"  # B1
REPLACES = "dyffusion_tpu/ops/pallas_attention.py:181"  # the pl.pallas_call of _pallas_qkv
CORE_SOURCE = SOURCE  # B3 runs B1's kernels
CORE_REPLACES = "dyffusion_tpu/ops/pallas_attention.py:293"  # the pl.pallas_call of _pallas_core_impl
KERNEL_DIM_HEAD = 32  # the kernels hold one head's D x D context

# B1's launch geometry (csrc/linear_attention_qkv.cu): the partial pass walks
# whole tiles of TILE_N tokens; the output pass takes OUT_TOKENS tokens at a
# time, one thread each; each chunk's partial is PARTIAL_FLOATS f32 (its
# D x D context, per-channel max and sum of exponentials)
TILE_N = 64
OUT_TOKENS = 128
PARTIAL_FLOATS = KERNEL_DIM_HEAD * KERNEL_DIM_HEAD + 2 * KERNEL_DIM_HEAD
# the H100's SMs, and the blocks of each pass resident on one SM with
# vector loads (the occupancy that chip_smoke.py reads from the CUDA runtime
# and prints); split_counts sizes both grids to at least two waves of these
SMS = 132
PARTIAL_BLOCKS_PER_SM = 3
OUTPUT_BLOCKS_PER_SM = 5
# at most this many tiles (partial pass) or OUT_TOKENS-token steps (output
# pass) per block: more splits mean more partials to write and merge
MAX_TILES_PER_CHUNK = 16
MAX_STEPS_PER_BLOCK = 8

# Kernel launches since the last reset, B1 (``launches``) and B3
# (``core_launches``); bumped only where the kernel is launched, so a run can
# show that it went through the kernel.
launches = 0
core_launches = 0
# of them, B1 calls split across ranks (each also counts in ``launches``),
# and the partial and output passes those calls launched (none on a rank of
# no tokens)
split_launches = 0
split_partial_launches = 0
split_output_launches = 0

_qkv_fn = None
_split_fns = None


def reset_launches() -> None:
    global launches, core_launches, split_launches, split_partial_launches, split_output_launches
    launches = core_launches = split_launches = split_partial_launches = split_output_launches = 0


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


def _split_plain(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, n_total: int, group,
                 maximum: Optional[torch.Tensor] = None) -> tuple:
    """:func:`linear_attention_qkv_split_plain` and k's per-channel maximum
    over the group, (B, heads, dim_head) f32; ``maximum`` given: taken as
    it is, detached (no collective). A rank of no tokens adds a maximum of
    -inf and sums of zeros."""
    from dyffusion_tpu_torch.parallel.distributed import group_max, group_sum

    B, N, _ = qkv.shape
    x = qkv.float().reshape(B, N, 3, heads, dim_head)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]  # (B, N, h, d)
    if maximum is None:
        m = k.detach().amax(dim=1) if N else k.new_full((B, heads, dim_head), -torch.inf)
        m = group_max(m, group)
    else:
        m = maximum.detach()
    p = torch.exp(k - m[:, None])
    sums = torch.cat([torch.einsum("bnhd,bnhe->bhde", p, v).flatten(2), p.sum(dim=1)], dim=-1)  # (B, h, d*d + d)
    if group is not None:  # differentiable: the backward sums the gradients over the group
        sums = group_sum(sums, group)
    context = sums[..., : dim_head * dim_head].reshape(B, heads, dim_head, dim_head)
    context = context * (scale / (sums[..., dim_head * dim_head:, None] * n_total))
    out = torch.einsum("bnhd,bhde->bnhe", torch.softmax(q, dim=-1), context)
    return out.reshape(B, N, heads * dim_head).to(qkv.dtype), m


def linear_attention_qkv_split_plain(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, n_total: int,
                                     group=None) -> torch.Tensor:
    """Plain PyTorch version of the split B1: this rank's (B, N_local,
    3*heads*dim_head) tokens of ``n_total`` over the ranks of ``group``
    (None: one rank). k's per-channel maximum over the group, then the
    sums of e^{k - M} and of e^{k - M} v over it, in f32. Differentiable:
    the sums' backward sums their gradients over the group."""
    return _split_plain(qkv, heads, dim_head, scale, n_total, group)[0]


def _check(qkv: torch.Tensor, heads: int, dim_head: int, split: bool = False) -> None:
    """``split``: a rank's tokens of the split B1, which may be none."""
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * heads * dim_head:
        raise ValueError(
            f"qkv must be (B, N, 3*heads*dim_head) = (B, N, {3 * heads * dim_head}), got {tuple(qkv.shape)}"
        )
    if qkv.shape[0] == 0 or (qkv.shape[1] == 0 and not split):
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


@functools.lru_cache(maxsize=1024)
def split_counts(bh: int, n: int) -> tuple:
    """(S, S') of B1 for B*heads = ``bh`` and N = ``n`` tokens: the chunks
    per (batch, head) of the partial pass and the blocks per (batch, head)
    of the output pass. Each pass takes the fewest splits (at most
    MAX_TILES_PER_CHUNK tiles or MAX_STEPS_PER_BLOCK steps per block) whose
    grid fills two waves of the card, or one tile / one step per block when
    no split does. The partial pass takes at least two chunks once N spans
    two tiles, so no block walks a whole (batch, head); S = 1 when one tile
    holds N. No split is empty. Cached: it runs on every call, on the
    host."""

    def split(units: int, blocks_per_sm: int, cap: int) -> int:
        target = 2 * SMS * blocks_per_sm
        fits = [c for c in range(1, min(units, cap) + 1) if bh * -(-units // c) >= target]
        return -(-units // max(fits, default=1))

    tiles = -(-n // TILE_N)
    return (split(tiles, PARTIAL_BLOCKS_PER_SM, min(MAX_TILES_PER_CHUNK, -(-tiles // 2))),
            split(-(-n // OUT_TOKENS), OUTPUT_BLOCKS_PER_SM, MAX_STEPS_PER_BLOCK))


def load_width(qkv: torch.Tensor, *more: torch.Tensor) -> tuple:
    """(vec, tokens_fast) of the kernels' loads from ``qkv`` (B, N, C) and
    from ``more``, tensors of its layout read by the same loads (B3's k and
    v beside the (BH, N, d) view of q): tokens_fast when tokens are the
    stride-1 axis (the NCHW view), and vec, the most elements (up to 16
    bytes) per load along the stride-1 axis that every base pointer's
    alignment, the other strides and, when tokens are fast, N allow. Neither
    axis at stride 1: one element per load."""
    B, N, _ = qkv.shape
    sb, sn, sc = qkv.stride()
    isz = qkv.element_size()
    ptrs = [t.data_ptr() for t in (qkv, *more)]
    tokens_fast = sn == 1 and sc != 1
    if not tokens_fast and sc != 1:
        return 1, sn <= sc
    # the strides that step between vectors must keep each one aligned
    others = ([sc] if tokens_fast else [sn] if N > 1 else []) + ([sb] if B > 1 else [])
    vec = 16 // isz
    while vec > 1 and not (
        all(p % (vec * isz) == 0 for p in ptrs) and all(s % vec == 0 for s in others)
        and (not tokens_fast or N % vec == 0)
    ):
        vec //= 2
    return vec, tokens_fast


def _check_kernel_args(dtype: torch.dtype, dim_head: int, strides) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the linear attention kernel takes float32 or bfloat16, got {dtype}")
    if dim_head != KERNEL_DIM_HEAD:
        raise ValueError(f"the linear attention kernel takes dim_head={KERNEL_DIM_HEAD}, got {dim_head}")
    if any(s < 0 for s in strides):
        raise ValueError(f"the linear attention kernel takes non-negative strides, got {strides}")


def _library_fn(name: str, symbol: str, argtypes):
    from dyffusion_tpu_torch.ops._build import load_library

    fn = getattr(load_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _qkv_library():
    global _qkv_fn
    if _qkv_fn is None:
        _qkv_fn = _library_fn("linear_attention_qkv", "linear_attention_qkv_launch", [ctypes.c_void_p] * 5
                              + [ctypes.c_int] * 7 + [ctypes.c_int64] * 6 + [ctypes.c_int] * 2
                              + [ctypes.c_float, ctypes.c_void_p])
    return _qkv_fn


def _split_library():
    """The split path's three entry points: partials, merge, output."""
    global _split_fns
    if _split_fns is None:
        ptr, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        _split_fns = (
            _library_fn("linear_attention_qkv", "linear_attention_qkv_partials",
                        [ptr] * 3 + [i] * 7 + [i64] * 3 + [i, ptr]),
            _library_fn("linear_attention_qkv", "linear_attention_qkv_merge", [ptr, i, i, ptr, ptr, ptr, ptr]),
            _library_fn("linear_attention_qkv", "linear_attention_qkv_output",
                        [ptr] * 3 + [i] * 7 + [i64] * 6 + [i] * 3 + [ctypes.c_float, ptr]),
        )
    return _split_fns


def _split_call(qkv: torch.Tensor, fn, *args) -> None:
    """``fn(*args, stream)`` on qkv's device; raises on a CUDA error."""
    current = qkv.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(qkv.device):
        err = fn(*args, torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"split linear attention kernel launch failed: cudaError {err}")


def split_partial(qkv: torch.Tensor, heads: int, dim_head: int) -> tuple:
    """The split B1's first step on this rank's tokens (CUDA): the partial
    pass over its S chunks per (batch, head), then each (b, h, d)'s maximum
    over them. Returns (workspace, S, maxima (B*heads, dim_head)). No
    token: S = 0, no partial pass, and the merge writes maxima of -inf."""
    global split_partial_launches
    B, N, _ = qkv.shape
    _check_kernel_args(qkv.dtype, dim_head, qkv.stride())
    partials, merge, _ = _split_library()
    bh = B * heads
    S = split_counts(bh, N)[0] if N else 0
    ws = torch.empty(bh * S * PARTIAL_FLOATS, dtype=torch.float32, device=qkv.device)
    maxima = torch.empty((bh, dim_head), dtype=torch.float32, device=qkv.device)
    if N:
        vec, tokens_fast = load_width(qkv)
        third = heads * dim_head * qkv.stride(2) * qkv.element_size()
        _split_call(qkv, partials, qkv.data_ptr() + third, qkv.data_ptr() + 2 * third, ws.data_ptr(),
                    int(qkv.dtype == torch.bfloat16), vec, int(tokens_fast), B, N, heads, dim_head, *qkv.stride(), S)
        split_partial_launches += 1
    _split_call(qkv, merge, ws.data_ptr(), bh, S, None, maxima.data_ptr(), None)
    return ws, S, maxima


def split_merge(qkv: torch.Tensor, ws: torch.Tensor, S: int, maxima: torch.Tensor) -> torch.Tensor:
    """The split B1's second step (CUDA): one partial per (batch, head) of
    this rank's tokens at the global ``maxima``; summed over the ranks it is
    the partial of all tokens. S = 0 (no token): zeros."""
    merged = torch.empty((maxima.shape[0], PARTIAL_FLOATS), dtype=torch.float32, device=qkv.device)
    _split_call(qkv, _split_library()[1], ws.data_ptr(), maxima.shape[0], S, maxima.data_ptr(), None,
                merged.data_ptr())
    return merged


def split_output(qkv: torch.Tensor, merged: torch.Tensor, heads: int, dim_head: int, scale: float,
                 n_total: int) -> torch.Tensor:
    """The split B1's last step (CUDA): the output pass over this rank's
    tokens from the partial of all tokens, v / ``n_total``. No token: no
    launch, an empty output."""
    global split_output_launches
    B, N, _ = qkv.shape
    out = _qkv_out(qkv, heads * dim_head)
    if not N:
        return out
    vec, tokens_fast = load_width(qkv)
    _split_call(qkv, _split_library()[2], qkv.data_ptr(), out.data_ptr(), merged.data_ptr(),
                int(qkv.dtype == torch.bfloat16), vec, int(tokens_fast), B, N, heads, dim_head, *qkv.stride(),
                *out.stride(), 1, split_counts(B * heads, N)[1], int(n_total), float(scale))
    split_output_launches += 1
    return out


def _launch_split(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, n_total: int, group) -> tuple:
    """The kernel path of :func:`linear_attention_qkv_split`: the three
    steps with the two all_reduces between them. Returns the output and the
    global maximum, (B, heads, dim_head)."""
    import torch.distributed as dist

    from dyffusion_tpu_torch.parallel.distributed import group_max

    global launches, split_launches
    ws, S, maxima = split_partial(qkv, heads, dim_head)
    maxima = group_max(maxima, group)
    merged = split_merge(qkv, ws, S, maxima)
    if group is not None:
        dist.all_reduce(merged, group=group)
    out = split_output(qkv, merged, heads, dim_head, scale, n_total)
    launches += 1
    split_launches += 1
    return out, maxima.view(qkv.shape[0], heads, dim_head)


class _SplitQKV(torch.autograd.Function):
    """The split B1: the kernels (CUDA) or the plain version (CPU) forward,
    the plain version replayed backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head, scale, n_total, group):
        ctx.args = (heads, dim_head, scale, n_total, group)
        if qkv.device.type == "cuda":
            out, maximum = _launch_split(qkv, heads, dim_head, scale, n_total, group)
        else:
            out, maximum = _split_plain(qkv, heads, dim_head, scale, n_total, group)
        ctx.save_for_backward(qkv, maximum)
        return out

    @staticmethod
    def backward(ctx, grad):
        qkv, maximum = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(_split_plain(x, *ctx.args, maximum=maximum)[0], x, grad)
        return g, None, None, None, None, None


def linear_attention_qkv_split(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, n_total: int,
                               group=None) -> torch.Tensor:
    """B1 over ``n_total`` tokens split across the ranks of ``group``
    (None: this rank's are all of them), this rank holding ``qkv`` (B,
    N_local, 3*heads*dim_head), N_local >= 0: the softmax of k over all tokens, the
    context summed over all, v / ``n_total``; the output of this rank's
    tokens. CUDA tensor: the B1 kernels (partial pass, merge, output pass)
    with two all_reduces between them, or an error. CPU tensor: the plain
    version (:func:`linear_attention_qkv_split_plain`). Differentiable: the
    backward replays the plain version with one all_reduce. Every rank of
    the group must call it, and its backward."""
    _check(qkv, heads, dim_head, split=True)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_attention_qkv_split takes CPU or CUDA tensors, got device {qkv.device}")
    return _SplitQKV.apply(qkv, heads, dim_head, float(scale), int(n_total), group)


def qkv_occupancy(dtype: torch.dtype, vec: int, tokens_fast: bool) -> tuple:
    """(partial, output): resident blocks per SM of B1's two kernels for
    this dtype and load width, from the CUDA runtime (needs the card)."""
    fn = _library_fn("linear_attention_qkv", "linear_attention_qkv_occupancy",
                     [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    blocks = (ctypes.c_int * 2)()
    err = fn(int(dtype == torch.bfloat16), vec, int(tokens_fast), blocks)
    if err != 0:
        raise RuntimeError(f"linear attention occupancy query failed: cudaError {err}")
    return blocks[0], blocks[1]


def _run(x: torch.Tensor, ptrs, width, out: torch.Tensor, heads: int, dim_head: int, scale: float) -> None:
    """Launch the two kernels on ``x`` (B, N, C), a view in the inputs'
    layout: q, k and v from the base pointers ``ptrs``, with the load width
    ``width`` (:func:`load_width`); ``out`` a (B, N, heads*dim_head) view."""
    B, N, _ = x.shape
    _check_kernel_args(x.dtype, dim_head, x.stride())
    S, S2 = split_counts(B * heads, N)
    vec, tokens_fast = width
    ws = torch.empty(B * heads * S * PARTIAL_FLOATS, dtype=torch.float32, device=x.device)
    args = (*ptrs, out.data_ptr(), ws.data_ptr(), int(x.dtype == torch.bfloat16), vec, int(tokens_fast),
            B, N, heads, dim_head, *x.stride(), *out.stride(), S, S2, float(scale))
    # the kernels launch on the current device: switch to x's only when it
    # is another (a per-call cost on the host, which bounds small calls)
    current = x.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(x.device):
        err = _qkv_library()(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear attention kernel launch failed: cudaError {err}")


def _qkv_out(qkv: torch.Tensor, hd: int) -> torch.Tensor:
    """B1's output, uninitialized, in the layout its device writes: on CUDA
    the kernel keeps the input's axis order, tokens fastest for the NCHW
    view of a 1x1-conv output (so it is itself an NCHW tensor) and channels
    fastest otherwise; on the CPU the plain version's contiguous result.
    The launch and the op's fake share it, so a traced graph holds the
    strides the run will have."""
    B, N, _ = qkv.shape
    if qkv.device.type == "cuda" and qkv.stride(1) == 1 and N > 1:
        return torch.empty((B, hd, N), dtype=qkv.dtype, device=qkv.device).transpose(1, 2)
    return torch.empty((B, N, hd), dtype=qkv.dtype, device=qkv.device)


def _launch_qkv(qkv: torch.Tensor, heads: int, dim_head: int, scale: float) -> torch.Tensor:
    global launches
    out = _qkv_out(qkv, heads * dim_head)
    q = qkv.data_ptr()
    third = heads * dim_head * qkv.stride(2) * qkv.element_size()  # bytes from q's channels to k's, and k's to v's
    _run(qkv, (q, q + third, q + 2 * third), load_width(qkv), out, heads, dim_head, scale)
    launches += 1
    return out


def _launch_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """B3 as B1 with heads = 1: the (BH, N, d) views of q, k, v. The output
    is a contiguous (BH, d, N) tensor whatever the inputs' layout (tokens at
    stride 1: the output pass's direct stores)."""
    global core_launches
    BH, d, N = q.shape
    out = torch.empty((BH, d, N), dtype=q.dtype, device=q.device)
    x = q.transpose(1, 2)
    _run(x, (q.data_ptr(), k.data_ptr(), v.data_ptr()), load_width(x, k, v), out.transpose(1, 2), 1, d, scale)
    core_launches += 1
    return out


# B1 and B3 as torch.library ops, so that torch.export records them as
# nodes and a traced graph knows their output layouts (their fakes). The CPU
# implementation is the plain version, the CUDA one launches the kernels.
# Each backward replays the plain composition, as the JAX package's
# ``_pallas_qkv_bwd`` replays ``_xla_qkv`` and ``_pallas_core_bwd`` replays
# ``_core_reference``.
@torch.library.custom_op("dyffusion_tpu_torch::linear_attention_qkv", mutates_args=(), device_types="cpu")
def _qkv_op(qkv: torch.Tensor, heads: int, dim_head: int, scale: float) -> torch.Tensor:
    return linear_attention_qkv_plain(qkv, heads, dim_head, scale).contiguous()


_qkv_op.register_kernel("cuda")(_launch_qkv)


@_qkv_op.register_fake
def _(qkv, heads, dim_head, scale):
    if qkv.device.type == "cuda":
        _check_kernel_args(qkv.dtype, dim_head, qkv.stride())
    return _qkv_out(qkv, heads * dim_head)


def _qkv_setup(ctx, inputs, output):
    qkv, *ctx.args = inputs
    ctx.save_for_backward(qkv)


def _qkv_backward(ctx, grad):
    (qkv,) = ctx.saved_tensors
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(linear_attention_qkv_plain(x, *ctx.args), x, grad)
    return g, None, None, None


_qkv_op.register_autograd(_qkv_backward, setup_context=_qkv_setup)


@torch.library.custom_op("dyffusion_tpu_torch::linear_attention_core", mutates_args=(), device_types="cpu")
def _core_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    return linear_attention_core_plain(q, k, v, scale).contiguous()


_core_op.register_kernel("cuda")(_launch_core)


@_core_op.register_fake
def _(q, k, v, scale):
    if q.device.type == "cuda":
        _check_kernel_args(q.dtype, q.shape[1], q.stride())
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _core_setup(ctx, inputs, output):
    *qkv, ctx.scale = inputs
    ctx.save_for_backward(*qkv)


def _core_backward(ctx, grad):
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        grads = torch.autograd.grad(linear_attention_core_plain(*xs, ctx.scale), xs, grad)
    return (*grads, None)


_core_op.register_autograd(_core_backward, setup_context=_core_setup)


def linear_attention_qkv(qkv: torch.Tensor, heads: int, dim_head: int, scale: float) -> torch.Tensor:
    """(B, N, 3*heads*dim_head) -> (B, N, heads*dim_head), the op
    ``dyffusion_tpu_torch::linear_attention_qkv``.

    CUDA tensor: the B1 kernel (any non-negative strides; float32 or
    bfloat16; dim_head 32), or an error. CPU tensor: the plain version.
    Differentiable either way."""
    _check(qkv, heads, dim_head)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_attention_qkv takes CPU or CUDA tensors, got device {qkv.device}")
    return _qkv_op(qkv, heads, dim_head, float(scale))


def linear_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v (BH, d, N) -> out (BH, d, N), the linear-attention core per
    (batch*head), the op ``dyffusion_tpu_torch::linear_attention_core``.

    CUDA tensors: the B3 kernels (q, k, v of one layout, any non-negative
    strides; float32 or bfloat16; d = 32), or an error. CPU tensors: the
    plain version. Differentiable either way."""
    _check_core(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_attention_core takes CPU or CUDA tensors, got device {q.device}")
    return _core_op(q, k, v, float(scale))
