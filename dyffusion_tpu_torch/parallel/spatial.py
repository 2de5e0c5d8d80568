"""Spatial sharding of the network's grid over a model group: what the JAX
package's GSPMD inserts by itself on its mesh's ``'model'`` axis.

Each of the K ranks of a model group (``distributed.model_group``) holds a
slab of every grid tensor: contiguous rows of its H or W axis
(``trainer.spatial_axis``), the network's weights whole. Every resolution
of the ``Unet`` is a :class:`Level`: the global extent of the sharded axis,
split into K balanced contiguous blocks (the first ``total % K`` ranks one
row longer: SST's 60 -> 30 -> 15 rows at K = 2 are 30/30, 15/15, 8/7; a
level of fewer rows than K leaves the last ranks a block of no rows, as
GSPMD pads an empty shard: 3 rows at K = 4 are 1/1/1/0). A level's blocks
follow from its extent alone, so a skip connection finds its level's
partition again on the way up. Activations stay at about 1/K per rank;
what crosses ranks:

- :func:`rows` (the halo): the global rows [lo, hi) a rank needs, taken
  from whichever ranks own them, zeros outside the grid (a conv's zero
  padding). :func:`conv2d` and :func:`upsample_conv` ask for the rows
  their output block reads: a k x k conv of stride s and padding p gives
  output rows [a, b) from input rows [a s - p, (b - 1) s + k - p);
  an x2 upsample (nearest, or bilinear) then a conv of padding p reads the
  source rows of upsampled rows [a - p, b + p).
- :func:`resize` and :func:`conv_transpose2d` (the physical-systems
  backbones): the outer resample to the working grid and back, and the
  ``UNetSimple``'s k4 s2 p1 readout. A resample's taps come from the GLOBAL
  coordinates of the output block: half-pixel centres, the source index
  clamped at the grid's edges 0 and total - 1 ('bilinear',
  'nearest-exact', as torch's and the JAX package's resizes do); torch's
  floor ``nearest`` for NCSN++'s SPADE maps; or a row of the kernel's
  weight matrix (``utils.resize``: 'cubic', 'lanczos3', 'lanczos5', up to
  4, 6 or 10 taps). The source rows of non-zero weight, from whichever
  ranks own them, are a halo like any other; so are the input rows a
  transposed conv's output block reads (:func:`transposed_rows`).
- :func:`upfirdn2d` (NCSN++'s FIR resampling, and on it the x2 resamplers
  :func:`fir_upsample`, :func:`fir_downsample`, :func:`upsample_conv_fir`,
  :func:`conv_downsample_fir`): output rows [a, b) read the zero-stuffed
  rows [a down - pad0, (b - 1) down + k - pad0), whose samples are a halo
  of input rows.
- :func:`group_norm`: per (row, group) the sum and count, then the
  squares about the mean, in f32, summed over the group
  (``distributed.mean_var``, as the cross-rank BatchNorm).
- :func:`gather`: a small tensor whole (the mid-block attention's keys and
  values, 15 x 15 tokens at SST; NCSN++'s at 32 x 32 and below).
- :func:`linear_attention`: B1 split across ranks (``ops.linear_attention
  .linear_attention_qkv_split``); :func:`linear_attention_qk`: the 'qk'
  linear attention, k's softmax and the context summed over the group.

A rank whose block of a level is empty asks for no rows and gets a slab of
no rows of the right shape (:func:`_empty`, kept on the autograd graph of
its input), and still joins every transfer and its backward: it adds
zeros, a count of 0, a maximum of -inf.

Every transfer is an ``all_reduce`` over the model group of a zero-filled
buffer that each rank fills with the rows it owns (gloo takes only
``all_reduce`` and ``broadcast`` on CUDA tensors; see ``distributed``): a
halo moves the rows that cross ranks, 2 x halo rows a rank. Every rank of
the group calls every collective in the same order.

Every transfer is differentiable, as GSPMD's halos are in the JAX
package's backward. The halo is one autograd node (:class:`_Rows`) whose
backward runs the same all_reduce reversed: each rank puts the gradients
of the rows it took from others into the buffer, and each owner adds the
sum at its rows. It is one node, not a sum and some copies, so that every
rank calls the backward's collective even where its own output reads no
other rank's row (SST's 15 -> 30 upsample: rank 0 reads only its own
rows, rank 1 reads one of rank 0's). The moments of :func:`group_norm`,
the keys and values of :func:`gather` and B1's sums go through
``distributed.model_sum``, whose backward is the same sum of the incoming
gradients. So a rank's backward of its slab's loss gives the gradient of
the sum of its group's losses with respect to the tensors it holds; summed
over the world and divided by it (``distributed.all_reduce_gradients``),
the weight gradient is that of the loss over the whole grid and batch.

:func:`sharded` is the context of a sharded forward or train step: the
trainer enters it around its evaluation and its train step, and the
backbones (:func:`current`) then run on their slab; the draws over the
input grid take the rank's slab (``utils.rng.spatial_shard``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dyffusion_tpu_torch.parallel import distributed
from dyffusion_tpu_torch.utils import resize as resize_ops
from dyffusion_tpu_torch.utils import rng

# the sharded axis of an NCHW tensor for trainer.spatial_axis
AXES = {"h": -2, "w": -1}


def blocks(total: int, k: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of ``k`` ranks' contiguous blocks of ``total``
    rows: balanced, the first ``total % k`` one row longer."""
    q, r = divmod(int(total), int(k))
    out, start = [], 0
    for i in range(k):
        n = q + (i < r)
        out.append((start, start + n))
        start += n
    return out


@dataclasses.dataclass(frozen=True)
class Level:
    """One resolution of the sharded grid: axis ``dim`` of NCHW tensors
    (-2: H, -1: W), its global extent ``total`` and ``other``, the extent
    of the unsharded spatial axis, on rank ``rank`` of ``size``."""

    dim: int
    total: int
    other: int
    rank: int
    size: int

    @property
    def blocks(self) -> List[Tuple[int, int]]:
        return blocks(self.total, self.size)

    @property
    def start(self) -> int:
        return self.blocks[self.rank][0]

    @property
    def stop(self) -> int:
        return self.blocks[self.rank][1]

    @property
    def slab(self) -> rng.Slab:
        """This rank's rows, for a draw over a tensor of this level."""
        return rng.Slab(self.dim, self.total, self.start)

    @property
    def tokens(self) -> int:
        """The level's global number of grid points."""
        return self.total * self.other

    def conv(self, k: int, stride: int, padding: int) -> "Level":
        """The level a k x k conv of ``stride`` and ``padding`` maps to."""
        return dataclasses.replace(self, total=(self.total + 2 * padding - k) // stride + 1,
                                   other=(self.other + 2 * padding - k) // stride + 1)

    def doubled(self) -> "Level":
        return dataclasses.replace(self, total=2 * self.total, other=2 * self.other)

    def need(self, span) -> List[Tuple[int, int]]:
        """Every rank's ``span(a, b)``, the input rows [lo, hi) its block
        [a, b) of this level reads; (0, 0), no row, for an empty block."""
        return [span(a, b) if a < b else (0, 0) for a, b in self.blocks]

    def empty(self) -> bool:
        return self.stop == self.start

    def shape(self, batch: int, channels: int) -> Tuple[int, int, int, int]:
        """The NCHW shape of this rank's slab of ``channels``."""
        shape = [batch, channels, self.other, self.other]
        shape[self.dim] = self.stop - self.start
        return tuple(shape)

    def check(self, x: torch.Tensor) -> None:
        if x.shape[self.dim] != self.stop - self.start or x.shape[self.other_dim] != self.other:
            raise ValueError(f"a slab of shape {tuple(x.shape)} is not rank {self.rank}'s block "
                             f"[{self.start}, {self.stop}) of a {self.total} x {self.other} level (axis {self.dim})")

    @property
    def other_dim(self) -> int:
        return -1 if self.dim == -2 else -2


@dataclasses.dataclass(frozen=True)
class Shard:
    """A sharded forward's layout: the NCHW axis ``dim`` split over the
    model group, the top-level grid ``spatial`` (H, W)."""

    dim: int
    spatial: Tuple[int, int]

    def top(self) -> Level:
        total, other = (self.spatial if self.dim == -2 else self.spatial[::-1])
        return Level(self.dim, int(total), int(other), distributed.model_rank(), distributed.model_size())


_SHARD: contextvars.ContextVar = contextvars.ContextVar("spatial_shard", default=None)


@contextlib.contextmanager
def sharded(axis: str, spatial: Sequence[int]) -> Iterator[Shard]:
    """The context of a sharded forward over the model group: the grid
    ``spatial`` (H, W) split on ``axis`` ('h' or 'w'). The draws over the
    input grid take this rank's slab (``utils.rng.spatial_shard``)."""
    if axis not in AXES:
        raise ValueError(f"trainer.spatial_axis must be 'h' or 'w', got {axis!r}")
    shard = Shard(AXES[axis], (int(spatial[0]), int(spatial[1])))
    token = _SHARD.set(shard)
    try:
        with rng.spatial_shard(shard.top().slab):
            yield shard
    finally:
        _SHARD.reset(token)


def current() -> Optional[Shard]:
    """The layout of :func:`sharded`, or None outside it."""
    return _SHARD.get()


def _with_extent(x: torch.Tensor, dim: int, n: int) -> Tuple[int, ...]:
    shape = list(x.shape)
    shape[dim] = n
    return tuple(shape)


def _halo_all_reduce(buf: torch.Tensor) -> torch.Tensor:
    """The halo's transfer: the rows each rank filled in, summed over the
    model group."""
    return distributed.model_all_reduce(buf)


def _segments(level: Level, need: Sequence[Tuple[int, int]]) -> List[Tuple[int, int, int, int]]:
    """(needing rank, owning rank, first row, end row) of every run of rows
    that crosses ranks, in one order on every rank."""
    segments = [(r, q, max(n_lo, blk[0]), min(n_hi, blk[1]))
                for r, (n_lo, n_hi) in enumerate(need) for q, blk in enumerate(level.blocks) if q != r]
    return [s for s in segments if s[2] < s[3]]


def _take_rows(x: torch.Tensor, level: Level, need: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The forward of :func:`rows`."""
    dim, me, own = level.dim, level.rank, level.blocks
    lo, hi = need[me]
    out = x.new_zeros(_with_extent(x, dim, hi - lo))
    a, b = max(lo, own[me][0]), min(hi, own[me][1])
    if a < b:
        out.narrow(dim, a - lo, b - a).copy_(x.narrow(dim, a - own[me][0], b - a))
    segments = _segments(level, need)
    if not segments:
        return out
    buf = x.new_zeros(_with_extent(x, dim, sum(b - a for _, _, a, b in segments)))
    offset = 0
    for _, q, a, b in segments:
        if q == me:
            buf.narrow(dim, offset, b - a).copy_(x.narrow(dim, a - own[me][0], b - a))
        offset += b - a
    buf = _halo_all_reduce(buf)
    offset = 0
    for r, _, a, b in segments:
        if r == me:
            out.narrow(dim, a - lo, b - a).copy_(buf.narrow(dim, offset, b - a))
        offset += b - a
    return out


def _return_rows(grad: torch.Tensor, level: Level, need: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The backward of :func:`rows`: the gradient of this rank's slab, its
    own rows' part of ``grad`` plus, summed over the group, what the other
    ranks' ``grad`` holds for the rows they took from it (the forward's
    all_reduce, with the roles of needing and owning rank swapped)."""
    dim, me, own = level.dim, level.rank, level.blocks
    lo, hi = need[me]
    gx = grad.new_zeros(_with_extent(grad, dim, own[me][1] - own[me][0]))
    a, b = max(lo, own[me][0]), min(hi, own[me][1])
    if a < b:
        gx.narrow(dim, a - own[me][0], b - a).copy_(grad.narrow(dim, a - lo, b - a))
    segments = _segments(level, need)
    if not segments:
        return gx
    buf = grad.new_zeros(_with_extent(grad, dim, sum(b - a for _, _, a, b in segments)))
    offset = 0
    for r, _, a, b in segments:
        if r == me:
            buf.narrow(dim, offset, b - a).copy_(grad.narrow(dim, a - lo, b - a))
        offset += b - a
    buf = _halo_all_reduce(buf)
    offset = 0
    for _, q, a, b in segments:
        if q == me:
            gx.narrow(dim, a - own[me][0], b - a).add_(buf.narrow(dim, offset, b - a))
        offset += b - a
    return gx


class _Rows(torch.autograd.Function):
    """:func:`rows` as one autograd node (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, level, need):
        ctx.level, ctx.need = level, need
        return _take_rows(x, level, need)

    @staticmethod
    def backward(ctx, grad):
        return _return_rows(grad, ctx.level, ctx.need), None, None


def rows(x: torch.Tensor, level: Level, need: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The global rows ``need[rank]`` = [lo, hi) of the sharded axis for
    this rank, from its slab ``x`` of ``level`` and the slabs of the ranks
    that own them; zeros outside [0, level.total). ``need`` holds every
    rank's range (each rank computes all of them alike). One all_reduce of
    the rows that cross ranks, none when no rank needs another's rows; the
    backward returns each row's gradient to its owner with one more."""
    return _Rows.apply(x, level, tuple(need))


def _empty(x: torch.Tensor, out: Level, channels: int) -> torch.Tensor:
    """The slab of no rows of ``out`` (``channels``) from ``x``, an empty
    tensor of this rank (a halo of no rows): a view of ``x``, so that the
    rank's backward reaches the transfers that made ``x`` and runs their
    collectives as the other ranks do."""
    return x.reshape(out.shape(x.shape[0], channels))


def gather(x: torch.Tensor, level: Level) -> torch.Tensor:
    """The whole of a level's tensor on every rank of the group (for small
    tensors): each rank's slab placed in a zero-filled buffer, summed (the
    backward: the gradient of the whole summed over the group, this rank's
    slab of it)."""
    buf = x.new_zeros(_with_extent(x, level.dim, level.total))
    buf.narrow(level.dim, level.start, level.stop - level.start).copy_(x)
    return distributed.model_sum(buf)


def _padding(level: Level, p: int) -> Tuple[int, int]:
    """F.conv2d's (H, W) padding: none on the sharded axis (the halo holds
    its zeros), ``p`` on the other."""
    return (0, p) if level.dim == -2 else (p, 0)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], level: Level, stride: int = 1,
           padding: int = 0) -> Tuple[torch.Tensor, Level]:
    """A square conv (zero padding ``padding`` on both axes, ``stride``) of
    this rank's slab of ``level``: its slab of the output and the output's
    level. A 1 x 1 conv moves nothing."""
    level.check(x)
    k = int(weight.shape[level.dim])
    out = level.conv(k, stride, padding)
    halo = rows(x, level, out.need(lambda a, b: (a * stride - padding, (b - 1) * stride + k - padding)))
    if out.empty():
        return _empty(halo, out, weight.shape[0]), out
    return F.conv2d(halo, weight, bias, stride=stride, padding=_padding(level, padding)), out


def _taps(lo: int, hi: int, n_in: int, n_out: int, mode: str,
          dtype=np.float32) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The source rows (i0, i1) and the weight of i1 of output rows [lo,
    hi) of a resample of ``n_in`` rows to ``n_out`` with half-pixel
    centres and no antialias, computed in ``dtype`` as torch computes them
    for a tensor of that type (float32 for float32, bfloat16 and float16;
    ``align_corners=False``: the source index clamped at 0, i1 at n_in - 1;
    ``nearest-exact``: one tap; torch's ``nearest``: one tap at
    floor(i n_in / n_out), no half-pixel centres). The kernel modes take
    :func:`_weights`."""
    i = np.arange(lo, hi, dtype=dtype)
    scale, half = dtype(n_in) / dtype(n_out), dtype(0.5)
    if mode == "nearest":
        i0 = np.minimum(np.floor(i * scale).astype(np.int64), n_in - 1)
        return i0, i0, np.zeros_like(i)
    if mode == "bilinear":
        src = np.maximum(scale * (i + half) - half, dtype(0.0))
        i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), (src - i0).astype(dtype)
    if mode == "nearest-exact":
        i0 = np.minimum(np.floor((i + half) * scale).astype(np.int64), n_in - 1)
        return i0, i0, np.zeros_like(i)
    raise ValueError(f"unknown resample mode {mode!r}: 'nearest', 'nearest-exact', 'bilinear' or one of "
                     f"{sorted(resize_ops.RADIUS)}")


def _weights(lo: int, hi: int, n_in: int, n_out: int, mode: str, dtype=np.float32) -> Tuple[int, np.ndarray]:
    """The source rows of output rows [lo, hi) of a resample by the kernel
    ``mode`` ('cubic', 'lanczos3', 'lanczos5'; ``utils.resize.weights``):
    the first source row of non-zero weight, and the rows' weights from it
    to the last, (hi - lo, span). No row: (0, an empty matrix)."""
    w = resize_ops.weights(n_in, n_out, mode, dtype)[lo:hi]
    cols = np.flatnonzero(np.any(w != 0, axis=0))
    if not len(cols):
        return 0, w[:, :0]
    return int(cols[0]), w[:, cols[0]:cols[-1] + 1]


def _resample(x: torch.Tensor, level: Level, out: Level, need: Sequence[Tuple[int, int]], mode: str) -> torch.Tensor:
    """Rows ``need[rank]`` = [lo, hi) of the sharded axis of the resample
    of this rank's slab ``x`` of ``level`` to the grid of ``out``, zeros
    outside [0, out.total) (a conv's padding after it): the source rows
    the taps read (:func:`rows`), resampled on the sharded axis by their
    global coordinates, then on the whole other axis. No row: a slab of
    no rows."""
    level.check(x)
    # in float64 for a float64 tensor, else in float32 (as torch's resize computes a bf16 one)
    dtype = resize_ops.np_dtype(x.dtype)
    clipped = [(max(lo, 0), min(hi, out.total)) for lo, hi in need]
    if mode in resize_ops.RADIUS:
        taps = [_weights(a, b, level.total, out.total, mode, dtype) for a, b in clipped]
        src_need = [(first, first + w.shape[1]) for first, w in taps]
    else:
        taps = [_taps(a, b, level.total, out.total, mode, dtype) for a, b in clipped]
        src_need = [(int(i0[0]), int(i1[-1]) + 1) if len(i0) else (0, 0) for i0, i1, _ in taps]
    src = rows(x, level, src_need)
    (lo, hi), (a, b) = need[level.rank], clipped[level.rank]
    if hi <= lo:  # an empty block of out
        return _empty(src, out, x.shape[1])
    first, dim = src_need[level.rank][0], level.dim
    if mode in resize_ops.RADIUS:
        y = resize_ops.contract(src, dim, taps[level.rank][1])
    else:
        i0, i1, w = taps[level.rank]
        as_index = lambda i: torch.as_tensor(i - first, device=x.device)  # noqa: E731
        y = src.index_select(dim, as_index(i0))
        if mode == "bilinear":
            shape = [1] * x.dim()
            shape[dim] = len(w)
            weight = torch.as_tensor(w, device=x.device).reshape(shape)
            y = torch.lerp(y.to(weight.dtype), src.index_select(dim, as_index(i1)).to(weight.dtype),
                           weight).to(x.dtype)
    if a - lo or hi - b:  # the conv's zero padding beyond the grid's edges
        pad = [0, 0, a - lo, hi - b] if dim == -2 else [a - lo, hi - b]
        y = F.pad(y, pad)
    other = -1 if dim == -2 else -2
    if mode in resize_ops.RADIUS:  # the other axis is whole on every rank
        y = resize_ops.resize_axis(y, other, out.other, mode)
    elif out.other != level.other:
        size = (y.shape[-2], out.other) if dim == -2 else (out.other, y.shape[-1])
        kw = {"align_corners": False} if mode == "bilinear" else {}
        y = F.interpolate(y, size=size, mode=mode, **kw)
    return y


def resize(x: torch.Tensor, level: Level, size: Sequence[int], mode: str = "bilinear") -> Tuple[torch.Tensor, Level]:
    """This rank's slab of the resample of the whole grid to ``size`` =
    (H, W), no antialias, and the output's level: ``mode`` 'bilinear' or
    'nearest-exact' (``F.interpolate``'s, with half-pixel centres),
    torch's 'nearest', or a kernel mode of ``utils.resize`` ('cubic',
    'lanczos3', 'lanczos5': ``jax.image.resize``'s)."""
    total, other = (size if level.dim == -2 else tuple(size)[::-1])
    out = dataclasses.replace(level, total=int(total), other=int(other))
    return _resample(x, level, out, out.blocks, mode), out


def upsample_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], level: Level,
                  padding: int = 1, mode: str = "nearest-exact") -> Tuple[torch.Tensor, Level]:
    """An x2 upsample, then a square stride-1 conv with zero padding
    ``padding`` that keeps the extent: nearest then 3 x 3 (the ``Unet``'s
    ``Upsample``; nearest x2 and 'nearest-exact' x2 pick the same rows),
    or bilinear with half-pixel centres then (size - 1)^2 (each
    ``UNetSimple`` decoder block). Of this rank's slab: the upsampled rows
    its output block reads, ``padding`` beyond it on each side (zeros
    beyond the grid), then the conv without padding on the sharded axis. A
    1 x 1 conv (``padding`` 0) still needs the bilinear's source rows."""
    out = level.doubled()
    up = _resample(x, level, out, out.need(lambda a, b: (a - padding, b + padding)), mode)
    if out.empty():
        return _empty(up, out, weight.shape[0]), out
    return F.conv2d(up, weight, bias, padding=_padding(level, padding)), out


def transposed_rows(a: int, b: int, k: int, s: int, p: int) -> Tuple[int, int]:
    """The input rows [lo, hi) that output rows [a, b) of a transposed conv
    (kernel k, stride s, padding p) read: output row o = i s - p + j takes
    input row i through tap j in [0, k), so lo = ceil((a + p - k + 1) / s)
    and hi = (b - 1 + p) // s + 1."""
    return -((k - 1 - p - a) // s), (b - 1 + p) // s + 1


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], level: Level,
                     stride: int, padding: int) -> Tuple[torch.Tensor, Level]:
    """A square transposed conv (``F.conv_transpose2d``, weight (C_in,
    C_out, k, k)) of this rank's slab: the input rows its output block
    reads (:func:`transposed_rows`; zeros beyond the grid), transposed-
    convolved without padding on the sharded axis and cropped to the
    block; its slab of the output and the output's level."""
    level.check(x)
    k, s, p = int(weight.shape[level.dim]), int(stride), int(padding)
    grow = lambda n: (n - 1) * s - 2 * p + k  # noqa: E731
    out = dataclasses.replace(level, total=grow(level.total), other=grow(level.other))
    need = out.need(lambda a, b: transposed_rows(a, b, k, s, p))
    halo = rows(x, level, need)
    if out.empty():
        return _empty(halo, out, weight.shape[1]), out
    y = F.conv_transpose2d(halo, weight, bias, stride=s, padding=_padding(level, p))
    return y.narrow(level.dim, out.start - need[level.rank][0] * s + p, out.stop - out.start), out


def upfirdn_level(level: Level, k: int, up: int, down: int, pad: Tuple[int, int]) -> Level:
    """The level of :func:`upfirdn2d`'s output: (n up + pad0 + pad1 - k)
    // down + 1 rows of n on each axis."""
    grow = lambda n: (n * up + pad[0] + pad[1] - k) // down + 1  # noqa: E731
    return dataclasses.replace(level, total=grow(level.total), other=grow(level.other))


def upfirdn2d(x: torch.Tensor, kernel: np.ndarray, level: Level, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> Tuple[torch.Tensor, Level]:
    """This rank's slab of ``ops.upfirdn2d.upfirdn2d(x, kernel, up, down,
    pad)`` of the whole grid (a square ``kernel``; ``up`` - 1 zeros after
    each sample, ``pad`` on both ends, the flipped kernel correlated at
    stride ``down``), and the output's level. Output rows [a, b) read the
    zero-stuffed rows [a down - pad0, (b - 1) down + k - pad0), whose
    samples are the input rows [ceil((a down - pad0) / up), ((b - 1) down
    + k - 1 - pad0) // up + 1): a halo (:func:`rows`, zeros beyond the
    grid), stuffed and padded to that span on the sharded axis and by
    ``pad`` on the other, then filtered."""
    level.check(x)
    kernel = np.asarray(kernel, np.float32)
    k, (p0, p1) = int(kernel.shape[0]), pad
    out = upfirdn_level(level, k, up, down, pad)
    span = out.need(lambda a, b: (a * down - p0, (b - 1) * down + k - p0))
    need = [(-(-s0 // up), (s1 - 1) // up + 1) if s0 < s1 else (0, 0) for s0, s1 in span]
    z = rows(x, level, need)
    if out.empty():
        return _empty(z, out, x.shape[1]), out
    (lo, hi), (s0, s1) = need[level.rank], span[level.rank]
    B, C, H, W = z.shape
    if up > 1:
        z = F.pad(z.reshape(B, C, H, 1, W, 1), (0, up - 1, 0, 0, 0, up - 1)).reshape(B, C, H * up, W * up)
    front, back = lo * up - s0, s1 - hi * up  # a negative pad crops
    z = F.pad(z, [p0, p1, front, back] if level.dim == -2 else [front, back, p0, p1])
    w = torch.flip(torch.as_tensor(kernel, device=z.device, dtype=z.dtype), (0, 1))
    return F.conv2d(z, w[None, None].expand(C, 1, k, k), stride=down, groups=C), out


def fir_upsample(x: torch.Tensor, kernel, level: Level) -> Tuple[torch.Tensor, Level]:
    """``ops.upfirdn2d.upsample_2d(x, kernel)`` (x2, gain 1) of this rank's
    slab, and the output's level."""
    from dyffusion_tpu_torch.ops.upfirdn2d import setup_fir_kernel

    k = setup_fir_kernel(kernel, 4.0)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, level, up=2, pad=((p + 1) // 2 + 1, p // 2))


def fir_downsample(x: torch.Tensor, kernel, level: Level) -> Tuple[torch.Tensor, Level]:
    """``ops.upfirdn2d.downsample_2d(x, kernel)`` (/2, gain 1) of this
    rank's slab, and the output's level."""
    from dyffusion_tpu_torch.ops.upfirdn2d import setup_fir_kernel

    k = setup_fir_kernel(kernel)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, level, down=2, pad=((p + 1) // 2, p // 2))


def upsample_conv_fir(x: torch.Tensor, w: torch.Tensor, kernel, level: Level) -> Tuple[torch.Tensor, Level]:
    """``ops.upfirdn2d.upsample_conv_2d(x, w, kernel)`` (x2) of this rank's
    slab: the stride-2 transposed conv on its halo (:func:`conv_transpose2d`,
    a level of 2n + k - 2 rows), then the FIR on that level's halo; the
    output's level."""
    from dyffusion_tpu_torch.ops.upfirdn2d import setup_fir_kernel

    k = setup_fir_kernel(kernel, 4.0)
    p = (k.shape[0] - 2) - (w.shape[3] - 1)
    y, mid = conv_transpose2d(x, torch.flip(w, (2, 3)).transpose(0, 1), None, level, stride=2, padding=0)
    return upfirdn2d(y, k, mid, pad=((p + 1) // 2 + 1, p // 2 + 1))


def conv_downsample_fir(x: torch.Tensor, w: torch.Tensor, kernel, level: Level) -> Tuple[torch.Tensor, Level]:
    """``ops.upfirdn2d.conv_downsample_2d(x, w, kernel)`` (/2) of this
    rank's slab: the FIR on its halo (a level of n + 1 rows for the 3 x 3
    ``w``), then the stride-2 VALID conv on that level's halo; the output's
    level."""
    from dyffusion_tpu_torch.ops.upfirdn2d import setup_fir_kernel

    k = setup_fir_kernel(kernel)
    p = (k.shape[0] - 2) + (w.shape[3] - 1)
    y, mid = upfirdn2d(x, k, level, pad=((p + 1) // 2, p // 2))
    return conv2d(y, w, None, mid, stride=2)


def group_norm(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               eps: float, level: Level) -> torch.Tensor:
    """GroupNorm (biased variance) over the whole grid of this rank's slab
    ``x`` (B, C, h, w): per (row, group) the mean and variance summed over
    the model group (``distributed.mean_var``); in f32 (f64 for an f64
    ``x``), returned in x's dtype. ``weight`` and ``bias`` None: no
    affine."""
    level.check(x)
    B = x.shape[0]
    per_group = x[:1].numel() // num_groups  # 0 on an empty slab, where -1 would not resolve
    centred, _, var = distributed.mean_var(x.reshape(B, num_groups, per_group), (-1,), distributed.model_group())
    y = (centred * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        y = y * weight.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]
    return y.to(x.dtype)


def linear_attention(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, level: Level) -> torch.Tensor:
    """B1 over the level's global tokens, this rank holding ``qkv`` (B,
    N_local, 3 * heads * dim_head) of its slab (``ops.linear_attention
    .linear_attention_qkv_split``)."""
    from dyffusion_tpu_torch.ops.linear_attention import linear_attention_qkv_split

    return linear_attention_qkv_split(qkv, heads, dim_head, scale, level.tokens, distributed.model_group())


def linear_attention_qk(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, level: Level) -> torch.Tensor:
    """The 'qk' linear attention over the level's global tokens, this rank
    holding ``qkv`` (B, 3 * heads * dim_head, N_local), the 1 x 1
    projection of its slab flattened: q * scale on its tokens, k's softmax
    over all of the level's tokens and the context summed over them (the
    JAX package's plain ``jnp`` composition; it has no kernel). k's
    maximum over the group (detached: the softmax cancels it; -inf from a
    rank of no tokens), then the sums of e^{k - M} and of e^{k - M} v over
    the group (``distributed.model_sum``, differentiable), in f32 (f64 for
    an f64 ``qkv``). Returns (B, heads * dim_head, N_local) in qkv's
    dtype."""
    B = qkv.shape[0]
    x = qkv.to(torch.promote_types(qkv.dtype, torch.float32)).reshape(B, 3, heads, dim_head, qkv.shape[-1])
    q, k, v = x.unbind(1)  # (B, h, d, N_local)
    m = k.detach().amax(-1) if k.shape[-1] else k.new_full(k.shape[:-1], -torch.inf)
    p = torch.exp(k - distributed.group_max(m, distributed.model_group())[..., None])
    sums = distributed.model_sum(torch.cat([torch.einsum("bhdn,bhen->bhde", p, v).flatten(2), p.sum(-1)], -1))
    dd = dim_head * dim_head
    context = sums[..., :dd].reshape(B, heads, dim_head, dim_head) / sums[..., dd:, None]
    out = torch.einsum("bhde,bhdn->bhen", context, q * scale)
    return out.reshape(qkv.shape[0], heads * dim_head, qkv.shape[-1]).to(qkv.dtype)
