"""The process group of a data-parallel run, and its collectives.

Counterpart of ``dyffusion_tpu/parallel/distributed.py``. The JAX package
runs one controller per host over a mesh of chips; the port runs one process
per rank, each on one device, joined by ``torch.distributed``:

- :func:`init_distributed` joins the group the launcher describes in the
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``: ``torchrun``, or the CLI's own workers), the counterpart
  of ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID``. Idempotent; a no-op on one process.
- The backend is NCCL when the run is on CUDA and every rank of the host
  has a card of its own, gloo otherwise (on the CPU, or with more ranks
  than cards: NCCL refuses two ranks on one card). Rank r runs on
  ``cuda:{LOCAL_RANK}`` on a host with that many cards, else on
  ``cuda:0``.
- The port uses only ``all_reduce`` and ``broadcast`` on tensors and
  ``barrier``, which gloo supports on CUDA tensors too. What is gathered
  goes through an ``all_reduce`` of a zero-filled global buffer
  (:func:`gather_box`).
- Spatial sharding (:func:`set_model_axis`): the ranks form a D x K grid
  in the order of the JAX package's mesh (``devices.reshape(n_data,
  n_model)``), rank r at ``(r // K, r % K)``: one ``model`` group per data
  index (the K ranks that split one example's grid) and one ``data`` group
  per model index. :func:`model_rank`, :func:`model_size`,
  :func:`data_rank`, :func:`data_size`, :func:`model_all_reduce` and
  :func:`model_sum` read them; without a model axis the model group is one
  rank and the data axis the world.
- The gradient of a train step (:func:`all_reduce_gradients`): every rank
  computes the loss of its box of the global batch (the rows of its data
  index, its model index's slab of the grid), a mean over the box's
  elements (a masked mean's count is the global batch's over D,
  ``utils.loss``). The K slabs of a model group are equal in size (the grid
  divides by K), so the loss of the whole grid and the whole global batch
  is the mean of the world's D x K rank losses. A rank's backward goes
  through the model group's differentiable collectives
  (``parallel.spatial``): it gives the gradient of the sum of the group's
  losses with respect to the weights as this rank's slab uses them. Summed
  over the world and divided by D x K, that is the gradient of the global
  loss: one all_reduce over the world, divided by the world, for any grid
  (pure data parallelism is K = 1). The logged loss metrics are the mean
  over the world (:func:`all_reduce_mean`), the global loss.

Without a process group every function answers for one process: rank 0,
world 1, collectives that return their input.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# elements per all_reduce of the flat gradients (32 MiB of f32)
GRAD_BUCKET_ELEMENTS = 1 << 23


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def active() -> bool:
    """True inside a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


# the spatial layout of the world: (K, this rank's model group, its data group,
# the world's group), set by set_model_axis; None means K = 1
_MODEL_AXIS: Optional[tuple] = None


def _axis() -> Optional[tuple]:
    """The model axis of the current world (None without one, or once the
    world it was made for is gone)."""
    if _MODEL_AXIS is None or not active() or _MODEL_AXIS[3] is not dist.group.WORLD:
        return None
    return _MODEL_AXIS


def set_model_axis(k: int) -> None:
    """Split the world into a D x K grid (see the module docstring): every
    rank creates every group, in the same order. ``k`` must divide the
    world; ``k = 1`` drops the grid. Idempotent for the same ``k``."""
    global _MODEL_AXIS
    k = int(k)
    world = world_size()
    if world % k:
        raise ValueError(f"trainer.devices={world} not divisible by trainer.spatial_shards={k}")
    if k == 1:
        _MODEL_AXIS = None
        return
    if _axis() is not None and _MODEL_AXIS[0] == k:
        return
    me = rank()
    model = data = None
    for d in range(world // k):
        g = dist.new_group([d * k + m for m in range(k)])
        if me // k == d:
            model = g
    for m in range(k):
        g = dist.new_group([d * k + m for d in range(world // k)])
        if me % k == m:
            data = g
    _MODEL_AXIS = (k, model, data, dist.group.WORLD)


def model_size() -> int:
    """K: the ranks that split one example's grid (1 without a model axis)."""
    axis = _axis()
    return axis[0] if axis is not None else 1


def model_rank() -> int:
    """This rank's index in its model group."""
    return rank() % model_size()


def data_size() -> int:
    """D: the data-parallel axis, world / K."""
    return world_size() // model_size()


def data_rank() -> int:
    """This rank's index on the data axis (its model group's)."""
    return rank() // model_size()


def model_group():
    """This rank's model group (None without a model axis)."""
    axis = _axis()
    return axis[1] if axis is not None else None


def data_group():
    """This rank's data group (None: the world, without a model axis)."""
    axis = _axis()
    return axis[2] if axis is not None else None


def gather_rows(t: torch.Tensor, total: int, first: int) -> torch.Tensor:
    """The ``total`` rows of a batch split over the data axis, this rank
    holding ``t``, its rows from ``first`` on: each rank's rows placed in a
    zero-filled buffer and summed over its data group (no rank of the group
    holds another's rows, so the sum adds only zeros); ``t`` outside a
    process group."""
    if not active():
        return t
    buf = torch.zeros((int(total),) + tuple(t.shape[1:]), dtype=t.dtype, device=collective_device())
    buf[first:first + t.shape[0]] = t.detach().to(buf.device)
    dist.all_reduce(buf, group=data_group())
    return buf.to(t.device)


def model_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over this rank's model group in place, outside autograd;
    ``t`` without a model axis."""
    group = model_group()
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def group_max(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s elementwise maximum over the ranks of ``group`` in place,
    outside autograd; ``t`` for ``group=None``."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


class _GroupSum(torch.autograd.Function):
    """An all_reduce sum whose backward is the all_reduce sum of the
    gradients (``torch.distributed.nn.functional.all_reduce``, which torch
    deprecates)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _GroupSum.apply(grad, ctx.group), None


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, differentiable: the
    backward sums the incoming gradients over the group, so every rank of
    it must run the backward too; ``t`` for ``group=None``."""
    return t if group is None else _GroupSum.apply(t, group)


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """:func:`group_sum` over this rank's model group; ``t`` without a model
    axis."""
    return group_sum(t, model_group())


def mean_var(x: torch.Tensor, dims: Sequence[int], group) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` centred on its mean, the mean and the biased variance, over
    ``dims`` of ``x`` and over the ranks of ``group`` (:func:`group_sum`,
    differentiable; this process alone for None), ``dims`` kept with size
    1; in f32, or in f64 for an f64 ``x``. Two sums: each rank's [sum,
    count], then its squares about the global mean. (flax's one sum,
    E[x^2] - E[x]^2, cancels in f32 where the mean is large against the
    spread.) The cross-rank BatchNorm and GroupNorm both take it."""
    dims = tuple(dims)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    sums = xf.sum(dim=dims, keepdim=True)
    count = torch.full((1,), float(xf.numel() // sums.numel()), dtype=xf.dtype, device=xf.device)
    total = group_sum(torch.cat([sums.reshape(-1), count]), group)
    mean = total[:-1].reshape(sums.shape) / total[-1]
    centred = xf - mean
    return centred, mean, group_sum(centred.square().sum(dim=dims, keepdim=True), group) / total[-1]


def launcher_world() -> Optional[int]:
    """The world size a launcher set in the environment, if any."""
    return _int_env("WORLD_SIZE")


def _local_world() -> int:
    return _int_env("LOCAL_WORLD_SIZE") or world_size()


def _own_cards() -> bool:
    """Every rank of this host has a card of its own."""
    return torch.cuda.is_available() and _local_world() <= torch.cuda.device_count()


def rank_device(device: torch.device | str) -> torch.device:
    """This rank's device for a run on ``device``: on CUDA, ``cuda:
    {LOCAL_RANK}`` where every rank of the host has its own card, else
    ``cuda:0`` (``device`` itself outside a process group); the CPU as
    asked."""
    device = torch.device(device)
    if device.type != "cuda" or not active():
        return device
    return torch.device("cuda", (_int_env("LOCAL_RANK") or 0) if _own_cards() else 0)


def init_distributed(device: torch.device | str = "cuda", timeout_s: float = 1800.0) -> None:
    """Join the launcher's process group (see the module docstring): NCCL
    for a CUDA run where every rank has its own card, else gloo. Does
    nothing when a group exists already or the environment names one
    process."""
    if active():
        return
    world = launcher_world()
    if world is None or world <= 1:
        return
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" and _own_cards() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_int_env("LOCAL_RANK") or 0)
    dist.init_process_group(
        backend, init_method="env://", rank=_int_env("RANK") or 0, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def backend() -> Optional[str]:
    return dist.get_backend() if active() else None


def collective_device() -> torch.device:
    """Where the host-side collectives' tensors live: this rank's card under
    NCCL (it reduces only CUDA tensors), the CPU under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if active():
        dist.barrier()


def effective_batch_size(per_rank_batch: int, accumulate_grad_batches: int = 1) -> int:
    """Global batch = per-rank batch x data axis x gradient accumulation."""
    return per_rank_batch * data_size() * accumulate_grad_batches


def rank_seed(seed: int) -> int:
    """The seed of this rank's generators: ``seed`` itself on one process
    or one data index (so a one-process run draws as it always has, and
    the K ranks of a model group draw alike: each keeps its slab of the
    same global draw, ``utils.rng.spatial_shard``), else a seed drawn from
    ``seed`` and the data index by numpy's ``SeedSequence``. The JAX package's
    partitionable threefry, whose draw on a sharded batch is the slice of
    the global draw, has no torch counterpart: each data index draws its
    own dropout masks for its rows, so a run with dropout differs between
    data-axis sizes in its masks (not in their distribution), while the K
    ranks of a model group, in training as at eval, keep their slabs of one
    draw and so train as one rank of that data index. The per-row draws of
    a train loss are the global batch's (``utils.rng.row_shard``) on a
    data axis of more than one rank, else the step generator's, the same on
    the K ranks of a group."""
    if data_size() == 1:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), data_rank()]).generate_state(1, np.uint64)[0] & (2**63 - 1))


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over ranks, in place; ``t`` outside a group."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_mean(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar tensors averaged over ranks, in one collective."""
    if not active() or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    all_reduce_sum(flat)
    flat /= world_size()
    return {k: flat[i] for i, k in enumerate(keys)}


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter], bucket_elements: int = GRAD_BUCKET_ELEMENTS) -> None:
    """Sum the parameters' gradients over the world and divide by it (the
    global loss's gradient on any D x K grid: see the module docstring):
    flat buckets of at most ``bucket_elements`` elements per dtype, one
    ``all_reduce`` each. A weight the loss does not reach (``grad`` None) enters as zeros on
    every rank (or the ranks would wait on one another) and leaves with a
    zero gradient."""
    if not active():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    world = world_size()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        buckets: List[List[torch.Tensor]] = [[]]
        size = 0
        for g in grads:
            if buckets[-1] and size + g.numel() > bucket_elements:
                buckets.append([])
                size = 0
            buckets[-1].append(g)
            size += g.numel()
        for bucket in buckets:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat /= world
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


def gather_box(t: torch.Tensor, starts, shape) -> torch.Tensor:
    """Every rank's block of a tensor split into boxes: this rank's ``t``
    placed at ``starts`` (one per axis) of a zero-filled buffer of
    ``shape``, then summed over ranks."""
    if not active():
        return t
    buf = torch.zeros(tuple(shape), dtype=t.dtype, device=t.device)
    box = buf
    for dim, (start, n) in enumerate(zip(starts, t.shape)):
        box = box.narrow(dim, start, n)
    box.copy_(t)
    return all_reduce_sum(buf)


def gather_bytes(data: torch.Tensor) -> List[torch.Tensor]:
    """Each rank's uint8 tensor (of one size on every rank), as a list by
    rank, through :func:`gather_box` (int32 on the collective device)."""
    if not active():
        return [data]
    local = data.reshape(1, -1).to(collective_device(), torch.int32)
    full = gather_box(local, (rank(), 0), (world_size(), local.shape[1]))
    return [row.to("cpu", torch.uint8) for row in full]


def broadcast_(t: torch.Tensor, src: int = 0) -> None:
    """``t`` overwritten in place by rank ``src``'s."""
    if active():
        dist.broadcast(t, src=src)
