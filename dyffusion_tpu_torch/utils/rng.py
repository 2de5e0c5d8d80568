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
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


class _DeviceDefault:
    """Marker for "the default generator of the tensor's device"."""

    def __repr__(self) -> str:
        return "DEVICE_DEFAULT"


DEVICE_DEFAULT = _DeviceDefault()
Generator = Optional[Union[torch.Generator, _DeviceDefault]]


def _kw(generator: Generator) -> dict:
    return {} if generator is DEVICE_DEFAULT else {"generator": generator}


def rand(shape: Sequence[int], generator: Generator, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """U[0, 1) of ``shape``."""
    return torch.rand(tuple(shape), **_kw(generator), device=device, dtype=dtype)


def randn(shape: Sequence[int], generator: Generator, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """N(0, 1) of ``shape``."""
    return torch.randn(tuple(shape), **_kw(generator), device=device, dtype=dtype)


def randint(low: int, high: int, shape: Sequence[int], generator: Generator, device) -> torch.Tensor:
    """Integers in [low, high) of ``shape``."""
    return torch.randint(low, high, tuple(shape), **_kw(generator), device=device)


def standard_gamma(concentration: torch.Tensor, generator: Generator) -> torch.Tensor:
    """Gamma(concentration, 1), one draw per element, on its device."""
    return torch._standard_gamma(concentration, **_kw(generator))
