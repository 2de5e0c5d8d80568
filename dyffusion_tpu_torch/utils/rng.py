"""The draws of the eval path, from an explicit generator or from the
default generator of the tensor's device.

Every random tensor of the samplers and the MC-dropout ensembles comes
through these functions. ``generator`` is one of:

- a ``torch.Generator``: the draw takes it, as eager evaluation and
  training always do (one stream per request or step, seeded by the caller);
- :data:`DEVICE_DEFAULT`: the draw takes the overload without a generator,
  so it reads the default generator of its device. That is the form
  ``torch.export`` can trace with a symbolic batch: a generator made inside
  the traced function would be lifted as a constant, and one passed in as an
  input pins the batch. The exported sampler (``serving.export_run``) runs
  on it, its caller seeding the device's default generator per request;
- ``None``: as torch reads it (the default generator). Where ``None`` means
  "no draw" (dropout off, no noise) the caller decides so before it gets
  here.

A fresh ``torch.Generator`` seeded with s and a device's default generator
after ``manual_seed(s)`` give the same draws, so one seed answers the same
eagerly and in the artifact.

:func:`split` gives each ensemble member of the unfolded layout a generator
of its own (the counterpart of ``jax.random.split``), and :func:`row_shard`
makes the per-row draws of a data-parallel train step those of the global
batch (see there).

Under spatial sharding a rank holds a slab of every grid tensor: rows
[start, start + n) of its H or W axis (a :class:`Slab`). A draw given a
slab is made at the tensor's global shape and sliced to the rank's rows,
so every rank of a model group, drawing from the same generator, keeps its
part of the one draw a single device would make (as the JAX package's draw
of a global shape is on a sharded grid); :func:`row_gamma` draws MCVD's
Gamma noise so, at the global batch and grid. Each rank draws the whole grid: K
times the draws, and a temporary of the global size per draw.
:func:`spatial_shard` holds the slab of the top-level grid, which the draws
over the network's inputs take (:func:`grid_randn`); the network passes the
slab of each of its levels itself.

A replica of a data-parallel artifact (``serving.export_run(devices=D)``)
keeps its rows of the draws at the request's batch in the same way
(:func:`replica_rows`).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch


class _DeviceDefault:
    """Marker for "the default generator of the tensor's device"."""

    def __repr__(self) -> str:
        return "DEVICE_DEFAULT"


DEVICE_DEFAULT = _DeviceDefault()
Generator = Optional[Union[torch.Generator, _DeviceDefault]]


class Slab(NamedTuple):
    """A rank's rows of one axis of a grid tensor: axis ``dim`` (negative,
    counted from the end) of global extent ``total``, this rank's rows
    from ``start`` on."""

    dim: int
    total: int
    start: int


def _kw(generator: Generator) -> dict:
    return {} if generator is DEVICE_DEFAULT else {"generator": generator}


def _sliced(draw, shape: Sequence[int], slab: Optional[Slab], **kw) -> torch.Tensor:
    """``draw(shape)``, or with ``slab`` the slab's rows of ``draw`` at the
    global shape (``shape[slab.dim]`` being the rank's rows); inside
    :func:`replica_rows` the replica's rows of the draw at the request's
    batch."""
    shape = tuple(shape)
    full = list(shape)
    if slab is not None:
        n = shape[slab.dim]
        if slab.start + n > slab.total:
            raise ValueError(f"a slab of {n} rows from row {slab.start} exceeds the global extent {slab.total}")
        full[slab.dim] = slab.total
    replica = _REPLICA_ROWS.get()
    if replica is None:
        out = draw(tuple(full), **kw)
    else:
        total, rows = replica
        b = rows.shape[0]
        if shape[0] % b:
            raise ValueError(f"a draw of {shape[0]} rows is not a fold of the replica's {b} batch rows")
        k = shape[0] // b  # the draw's rows: k groups (members, calls) of the batch's rows
        out = draw((k * total, *full[1:]), **kw)
        out = out.reshape((k, total, *full[1:])).index_select(1, rows).reshape(full)
    return out if slab is None else out.narrow(slab.dim, slab.start, n)


def rand(shape: Sequence[int], generator: Generator, device, dtype: Optional[torch.dtype] = None,
         slab: Optional[Slab] = None) -> torch.Tensor:
    """U[0, 1) of ``shape`` (with ``slab``: the slab of the global draw)."""
    return _sliced(torch.rand, shape, slab, **_kw(generator), device=device, dtype=dtype)


def randn(shape: Sequence[int], generator: Generator, device, dtype: Optional[torch.dtype] = None,
          slab: Optional[Slab] = None) -> torch.Tensor:
    """N(0, 1) of ``shape`` (with ``slab``: the slab of the global draw)."""
    return _sliced(torch.randn, shape, slab, **_kw(generator), device=device, dtype=dtype)


# the top-level grid's slab of this rank under spatial sharding, or None
_GRID_SLAB: contextvars.ContextVar = contextvars.ContextVar("grid_slab", default=None)


@contextlib.contextmanager
def spatial_shard(slab: Slab) -> Iterator[None]:
    """Within this context the draws over the network's input grid
    (:func:`grid_randn`, :func:`row_randn` with ``grid=True``) are made at
    the global grid and sliced to ``slab``, this rank's rows of the NCHW
    grid (the counterpart of :func:`row_shard` for a grid split over a
    model group)."""
    token = _GRID_SLAB.set(slab)
    try:
        yield
    finally:
        _GRID_SLAB.reset(token)


def grid_slab() -> Optional[Slab]:
    """The slab of :func:`spatial_shard`, or None outside it."""
    return _GRID_SLAB.get()


def grid_randn(shape: Sequence[int], generator: Generator, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """N(0, 1) over an NCHW grid tensor of ``shape``: the rank's slab of the
    global draw under :func:`spatial_shard`, else :func:`randn`."""
    kw = {} if grid_slab() is None else {"slab": grid_slab()}
    return randn(shape, generator, device, dtype, **kw)


# a data-parallel artifact's replica: (the request's batch rows, this replica's row indices), or None
_REPLICA_ROWS: contextvars.ContextVar = contextvars.ContextVar("replica_rows", default=None)


@contextlib.contextmanager
def replica_rows(total: int, rows: torch.Tensor) -> Iterator[None]:
    """Within this context every draw of the eval path (:func:`rand`,
    :func:`randn`, :func:`grid_randn`, :func:`row_randn` outside a train
    step, :func:`row_gamma`) is made at the request's batch of ``total``
    rows and cut to this replica's rows ``rows`` (a vector of indices on the
    draw's device): the replica of a data-parallel artifact keeps its rows
    of the one draw a single device would make, so that D replicas answer
    as one program over the whole batch. A draw's first axis is read as k
    groups of the batch's rows, group-major: the N members of the folded
    ensemble, or the two calls a cold step folds into one (2N). A
    row-scaled Gamma concentration would need the other replicas' rows:
    only a scalar one is taken here."""
    token = _REPLICA_ROWS.set((int(total), rows))
    try:
        yield
    finally:
        _REPLICA_ROWS.reset(token)


def replica_state() -> Optional[tuple]:
    """``(total, rows)`` of :func:`replica_rows`, or None outside it."""
    return _REPLICA_ROWS.get()


def randint(low: int, high: int, shape: Sequence[int], generator: Generator, device) -> torch.Tensor:
    """Integers in [low, high) of ``shape``."""
    return torch.randint(low, high, tuple(shape), **_kw(generator), device=device)




def split(generator: Generator, n: int) -> List[Generator]:
    """``n`` member generators from the request's ``generator``, the
    counterpart of ``jax.random.split(rng, n)``. A ``torch.Generator``
    gives one 62-bit draw (advancing it once, whatever ``n``), and member i
    a new generator on its device seeded from that draw and i through
    numpy's ``SeedSequence`` (so member i's stream does not depend on
    ``n``). :data:`DEVICE_DEFAULT` and ``None`` are handed to every member:
    their draws run on, member after member, through the one default
    generator, which is how the exported sampler stays seeded by the
    device's default generator at every draw site."""
    if generator is None or generator is DEVICE_DEFAULT:
        return [generator] * n
    base = int(randint(0, 2**62, (1,), generator, generator.device).item())
    out = []
    for i in range(n):
        g = torch.Generator(device=generator.device)
        state = np.random.SeedSequence(base, spawn_key=(i,)).generate_state(1, np.uint64)[0]
        g.manual_seed(int(state) & (2**63 - 1))
        out.append(g)
    return out


# the data-parallel train step's row shard: (generator, global rows, first row), or None
_ROW_SHARD: contextvars.ContextVar = contextvars.ContextVar("row_shard", default=None)


@contextlib.contextmanager
def row_shard(generator: torch.Generator, global_rows: int, first_row: int) -> Iterator[None]:
    """Within this context the per-row draws of a train loss
    (:func:`row_randint`, :func:`row_randn`) are drawn for ``global_rows``
    rows from ``generator``, which every rank seeds alike, and this rank
    keeps its rows from ``first_row`` on: the draws of a global batch split
    over ranks, as the JAX package's draws of a global shape are on a batch
    sharded over its mesh. Outside it they come from the generator the loss
    was given, as they always have."""
    token = _ROW_SHARD.set((generator, int(global_rows), int(first_row)))
    try:
        yield
    finally:
        _ROW_SHARD.reset(token)


def row_sharded() -> bool:
    """True inside :func:`row_shard` (a data-parallel train step)."""
    return _ROW_SHARD.get() is not None


def _rows(n: int):
    if _ROW_SHARD.get() is None:
        return None
    generator, total, first = _ROW_SHARD.get()
    if first + n > total:
        raise ValueError(f"a row draw of {n} rows from row {first} exceeds the global batch of {total}")
    return generator, total, first


def row_randint(low: int, high: int, n: int, generator: Generator, device) -> torch.Tensor:
    """Integers in [low, high), one per row of an ``n``-row batch (see
    :func:`row_shard`)."""
    shard = _rows(n)
    if shard is None:
        return randint(low, high, (n,), generator, device)
    g, total, first = shard
    return randint(low, high, (total,), g, g.device)[first:first + n].to(device)


def row_randn(shape: Sequence[int], generator: Generator, device, dtype: Optional[torch.dtype] = None,
              grid: bool = False) -> torch.Tensor:
    """N(0, 1) of ``shape``, whose first axis is the batch's rows (see
    :func:`row_shard`); with ``grid``, an NCHW grid tensor (see
    :func:`spatial_shard`)."""
    kw = {"slab": grid_slab()} if grid and grid_slab() is not None else {}
    shard = _rows(shape[0])
    if shard is None:
        return randn(shape, generator, device, dtype, **kw)
    g, total, first = shard
    return randn((total,) + tuple(shape[1:]), g, g.device, dtype, **kw)[first:first + int(shape[0])].to(device)


def row_gamma(concentration: torch.Tensor, shape: Sequence[int], generator: Generator, device,
              grid: bool = False) -> torch.Tensor:
    """Standard Gamma draws (scale 1) of ``shape``, whose first axis is the
    batch's rows, of shape parameter ``concentration``: a scalar tensor, or
    one per row ((n, 1, ..., 1)), constant over the other axes. Drawn as
    :func:`row_randn` draws: inside :func:`row_shard` at the global batch
    (the rows' concentrations gathered over the data axis,
    ``parallel.distributed.gather_rows``: an element of a Gamma draw may
    depend on the concentrations of those before it) and, with ``grid`` under
    :func:`spatial_shard`, at the global grid, then sliced to this rank's
    rows and slab."""
    shape = tuple(shape)
    n = shape[0]
    slab = grid_slab() if grid else None
    shard = _rows(n)
    g, first, conc = generator, 0, concentration
    if shard is not None:
        from dyffusion_tpu_torch.parallel.distributed import gather_rows

        g, total, first = shard
        conc = conc if conc.dim() == 0 else gather_rows(conc, total, first)
        conc, shape = conc.to(g.device), (total,) + shape[1:]

    if _REPLICA_ROWS.get() is not None and conc.dim() != 0:
        raise ValueError("a data-parallel replica draws Gamma noise only of a scalar concentration")

    def draw(full):
        return torch._standard_gamma(conc.expand(full).contiguous(), **_kw(g))

    return _sliced(draw, shape, slab)[first:first + n].to(device)
