"""Spatial sharding of the network's grid over a model group: what the JAX
package's GSPMD inserts by itself on its mesh's ``'model'`` axis.

Each of the K ranks of a model group (``distributed.model_group``) holds a
slab of every grid tensor: contiguous rows of its H or W axis
(``trainer.spatial_axis``), the network's weights whole. Every resolution
of the ``Unet`` is a :class:`Level`: the global extent of the sharded axis,
split into K balanced contiguous blocks (the first ``total % K`` ranks one
row longer: SST's 60 -> 30 -> 15 rows at K = 2 are 30/30, 15/15, 8/7; a
level of fewer rows than K raises). A
level's blocks follow from its extent alone, so a skip connection finds its
level's partition again on the way up. Activations stay at about 1/K per
rank; what crosses ranks:

- :func:`rows` (the halo): the global rows [lo, hi) a rank needs, taken
  from whichever ranks own them, zeros outside the grid (a conv's zero
  padding). :func:`conv2d` and :func:`upsample_conv` ask for the rows
  their output block reads: a k x k conv of stride s and padding p gives
  output rows [a, b) from input rows [a s - p, (b - 1) s + k - p);
  nearest x2 then a 3 x 3 conv reads source rows [(a - 1) // 2,
  b // 2 + 1), upsampled and cropped to [a - 1, b + 1).
- :func:`group_norm`: the sum and the sum of squares per (row, group), in
  f32, summed over the group (flax's fast variance, E[x^2] - E[x]^2).
- :func:`gather`: a small tensor whole (the mid-block attention's keys and
  values, 15 x 15 tokens at SST).
- :func:`linear_attention`: B1 split across ranks (``ops.linear_attention
  .linear_attention_qkv_split``).

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
``Unet`` (:func:`current`) then runs on its slab; the draws over the input
grid take the rank's slab (``utils.rng.spatial_shard``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dyffusion_tpu_torch.parallel import distributed
from dyffusion_tpu_torch.utils import rng

# the sharded axis of an NCHW tensor for trainer.spatial_axis
AXES = {"h": -2, "w": -1}
# the ROADMAP item of what is not ported under a shard
BACKBONES = "A2, other backbones and layouts under a shard"


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

    def __post_init__(self):
        if self.total < self.size:
            raise NotImplementedError(
                f"a level of {self.total} rows over {self.size} ranks leaves a rank without rows: a slab of no rows "
                f"is not ported (ROADMAP {BACKBONES}); shard fewer ranks or the other axis")

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


def refuse(what: str, roadmap: str) -> None:
    """Raise ``NotImplementedError`` for ``what`` inside :func:`sharded`."""
    if current() is not None:
        raise NotImplementedError(f"{what} under spatial sharding is not ported (ROADMAP {roadmap})")


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
    need = [(a * stride - padding, (b - 1) * stride + k - padding) for a, b in out.blocks]
    halo = rows(x, level, need)
    return F.conv2d(halo, weight, bias, stride=stride, padding=_padding(level, padding)), out


def upsample_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  level: Level) -> Tuple[torch.Tensor, Level]:
    """Nearest x2, then a 3 x 3 conv with padding 1 (the ``Unet``'s
    ``Upsample``), of this rank's slab: the source rows its output block
    reads, upsampled and cropped, then the conv without padding on the
    sharded axis."""
    level.check(x)
    out = level.doubled()
    need = [((a - 1) // 2, b // 2 + 1) for a, b in out.blocks]
    src = rows(x, level, need)
    up = F.interpolate(src, scale_factor=2, mode="nearest")
    up = up.narrow(level.dim, out.start - 1 - 2 * need[level.rank][0], out.stop - out.start + 2)
    return F.conv2d(up, weight, bias, padding=_padding(level, 1)), out


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               level: Level) -> torch.Tensor:
    """GroupNorm (biased variance) over the whole grid of this rank's slab
    ``x`` (B, C, h, w): per (row, group) the f32 sum and sum of squares,
    summed over the model group; computed in f32, returned in x's dtype."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B, num_groups, -1)
    moments = distributed.model_sum(torch.stack([xf.sum(-1), xf.square().sum(-1)]))
    n = (C // num_groups) * level.tokens
    mean = moments[0] / n
    var = torch.clamp(moments[1] / n - mean.square(), min=0.0)
    y = ((xf - mean[..., None]) * torch.rsqrt(var + eps)[..., None]).reshape(x.shape)
    return (y * weight.float()[:, None, None] + bias.float()[:, None, None]).to(x.dtype)


def linear_attention(qkv: torch.Tensor, heads: int, dim_head: int, scale: float, level: Level) -> torch.Tensor:
    """B1 over the level's global tokens, this rank holding ``qkv`` (B,
    N_local, 3 * heads * dim_head) of its slab (``ops.linear_attention
    .linear_attention_qkv_split``)."""
    from dyffusion_tpu_torch.ops.linear_attention import linear_attention_qkv_split

    return linear_attention_qkv_split(qkv, heads, dim_head, scale, level.tokens, distributed.model_group())
