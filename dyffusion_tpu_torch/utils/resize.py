"""``jax.image.resize(x, shape, method, antialias=False)`` on NCHW tensors:
the JAX package's outer resample of ``UNetSimple``, re-derived here from
JAX's definition (half-pixel centres, no antialias; the port imports no
JAX).

Each method's route (:func:`mode` names it):

- ``'nearest'``: source row floor((i + 0.5) n_in / n_out), torch's
  ``'nearest-exact'`` (``F.interpolate``), whose index equals JAX's;
- ``'linear'``, ``'bilinear'``, ``'trilinear'``, ``'triangle'``: JAX's
  triangle kernel, whose weights renormalised at an edge put the whole
  weight on the edge row: torch's ``'bilinear'`` with
  ``align_corners=False`` (its source index clamped at the edges), through
  ``F.interpolate``;
- ``'cubic'``, ``'bicubic'``, ``'tricubic'`` (Keys' cubic, a = -0.5, not
  torch's a = -0.75), ``'lanczos3'``, ``'lanczos5'``: a weight matrix per
  axis (:func:`weights`, built in numpy), applied as one contraction per
  axis whose extent changes.

Any other method raises JAX's ``ValueError``. ``parallel.spatial.resize``
applies the same modes to a rank's slab.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

LINEAR = ("linear", "bilinear", "trilinear", "triangle")
CUBIC = ("cubic", "bicubic", "tricubic")
# the modes built from a kernel's weight matrix, and the kernel's radius in source rows
RADIUS = {"cubic": 2, "lanczos3": 3, "lanczos5": 5}


def mode(method: str) -> str:
    """The resample mode of a ``jax.image.resize`` method: 'nearest-exact',
    'bilinear' (torch's modes, equal to JAX's) or one of :data:`RADIUS`."""
    if method == "nearest":
        return "nearest-exact"
    if method in LINEAR:
        return "bilinear"
    if method in CUBIC:
        return "cubic"
    if method in ("lanczos3", "lanczos5"):
        return method
    raise ValueError(f'Unknown resize method "{method}"')


def _kernel(name: str, x: np.ndarray) -> np.ndarray:
    """The kernel of mode ``name`` at distances ``x`` >= 0 (in x's dtype)."""
    if name == "cubic":
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        return np.where(x >= 2.0, 0.0, out).astype(x.dtype)
    radius = RADIUS[name]
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1.0), 1.0)
    return np.where(x > radius, 0.0, out).astype(x.dtype)


@functools.lru_cache(maxsize=256)
def weights(n_in: int, n_out: int, name: str, dtype=np.float32) -> np.ndarray:
    """The (n_out, n_in) matrix of a resample of ``n_in`` rows to ``n_out``
    with the kernel of mode ``name``, in ``dtype``: row i holds the kernel
    at the distances from its sample point (i + 0.5) n_in / n_out - 0.5 to
    each source row, divided by their sum (a sum of about 0 gives a row of
    zeros), zero where the sample point lies outside the source grid. The
    identity where n_in == n_out (JAX skips such an axis). Read-only."""
    if n_in == n_out:
        w = np.eye(n_in, dtype=dtype)
    else:
        inv_scale = dtype(1.0 / (n_out / n_in))
        sample = (np.arange(n_out, dtype=dtype) + dtype(0.5)) * inv_scale - dtype(0.5)
        w = _kernel(name, np.abs(sample[:, None] - np.arange(n_in, dtype=dtype)[None, :]))
        total = w.sum(axis=1, keepdims=True)
        w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                     w / np.where(total != 0, total, 1), 0).astype(dtype)
        w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[:, None], w, 0).astype(dtype)
    w.setflags(write=False)
    return w


def np_dtype(dtype: torch.dtype):
    """The dtype a tensor's weights are built in: float64 for float64, else
    float32 (as JAX builds them)."""
    return np.float64 if dtype == torch.float64 else np.float32


def contract(x: torch.Tensor, dim: int, w: np.ndarray) -> torch.Tensor:
    """Axis ``dim`` (-2 or -1) of ``x`` contracted with ``w`` (n_out,
    n_in): out[..., i, ...] = sum_j w[i, j] x[..., j, ...], in x's dtype."""
    wt = torch.tensor(w, dtype=x.dtype, device=x.device)
    return wt @ x if dim == -2 else x @ wt.T


def resize_axis(x: torch.Tensor, dim: int, n_out: int, name: str) -> torch.Tensor:
    """Axis ``dim`` of ``x`` resampled to ``n_out`` rows by the kernel mode
    ``name``; ``x`` itself where the extent is unchanged."""
    n_in = x.shape[dim]
    if n_in == n_out:
        return x
    return contract(x, dim, weights(n_in, n_out, name, np_dtype(x.dtype)))


def resize(x: torch.Tensor, size: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize`` of the NCHW ``x`` to ``size`` (H, W) by
    ``method``, without antialias (see the module docstring)."""
    size = (int(size[0]), int(size[1]))
    name = mode(method)
    if name == "bilinear":
        return F.interpolate(x, size=size, mode=name, align_corners=False, antialias=False)
    if name == "nearest-exact":
        return F.interpolate(x, size=size, mode=name)
    return resize_axis(resize_axis(x, -2, size[0], name), -1, size[1], name)
