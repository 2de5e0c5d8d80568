"""What a run feeds both sides, made from ``--seed``: the weights, the
batches, and the Navier-Stokes archive that the datamodule reads.

Seeds beyond 64 bits and per-purpose streams come from numpy's
``SeedSequence``; every draw is made by a ``torch.Generator`` on the run's
device, in a few large calls. The same seed gives the same inputs.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Sequence

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of the run seed ``seed``."""
    words = [int(seed) % (2**32), int(seed) // (2**32)]
    for t in tags:
        words += [int(b) for b in str(t).encode()] if isinstance(t, str) else [int(t)]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state) & (2**63 - 1)


def generator(seed: int, device, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def make_weights(spec: Dict[str, tuple], seed: int, device, tag: str) -> Dict[str, torch.Tensor]:
    """One float32 state dict for ``spec`` ({name: (shape, kind)}) from a
    single normal draw: 'weight' ~ N(0, 1/fan_in), 'bias' and 'zero' ~
    N(0, 0.02^2), 'one' ~ N(1, 0.05^2), 'count' = 0 (int64)."""
    sizes = [int(np.prod(shape)) for shape, _ in spec.values()]
    z = torch.randn(sum(sizes), generator=generator(seed, device, "weights", tag), device=device)
    out, at = {}, 0
    for (name, (shape, kind)), n in zip(spec.items(), sizes):
        v = z[at:at + n].reshape(shape)
        at += n
        if kind == "weight":
            v = v / math.sqrt(max(int(np.prod(shape[1:])), 1))
        elif kind in ("bias", "zero"):
            v = v * 0.02
        elif kind == "one":
            v = 1.0 + 0.05 * v
        elif kind == "count":
            v = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
        out[name] = v.clone() if kind != "count" else v
    return out


def smooth_fields(g: torch.Generator, rows: int, frames: int, hw: Sequence[int], channels: int, device,
                  modes: int = 6) -> torch.Tensor:
    """(rows, frames, H, W, C) traveling waves sum_j a_j sin(k_j . r - w_j t + phi_j),
    unit-scale and smooth: every row its own wave numbers, speeds and phases."""
    H, W = hw
    shape = (rows, 1, 1, 1, channels, modes)
    kx = torch.randint(1, 4, shape, generator=g, device=device).float()
    ky = torch.randint(1, 4, shape, generator=g, device=device).float()
    u = torch.rand((4,) + shape, generator=g, device=device)
    w, phi, amp = 0.05 + 0.2 * u[0], 2 * math.pi * u[1], 0.3 + 0.7 * u[2]
    yy = torch.linspace(0, 2 * math.pi, H, device=device)[None, None, :, None, None, None]
    xx = torch.linspace(0, 2 * math.pi, W, device=device)[None, None, None, :, None, None]
    t = torch.arange(frames, device=device, dtype=torch.float32)[None, :, None, None, None, None]
    f = (amp * torch.sin(kx * xx + ky * yy - w * t + phi)).sum(-1)
    return f / math.sqrt(modes / 2)


def ns_static(g: torch.Generator, rows: int, hw: Sequence[int], device) -> Dict[str, torch.Tensor]:
    """The Navier-Stokes batch's static part: a disk obstacle at a random
    place, the walls (first and last column), the two-channel condition
    (obstacle, walls), the fixed-cell mask of (vx, vy, p) (velocity fixed
    on walls and obstacle), the inflow speed, the left edge's y and the
    window's start time."""
    H, W = hw
    u = torch.rand((5, rows), generator=g, device=device)
    cy, cx, r = 20 + 40 * u[0], 12 + 18 * u[1], 3 + 3 * u[2]
    yy = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    disk = ((yy - cy[:, None, None]) ** 2 + (xx - cx[:, None, None]) ** 2) <= r[:, None, None] ** 2
    wall = torch.zeros((rows, H, W), dtype=torch.bool, device=device)
    wall[:, :, 0] = wall[:, :, -1] = True
    fixed_v = disk | wall
    return {
        "condition": torch.stack([disk.float(), wall.float()], dim=-1),
        "metadata_fixed_mask": torch.stack([fixed_v, fixed_v, torch.zeros_like(fixed_v)], dim=-1),
        "metadata_in_velocity": 0.5 + u[3],
        "metadata_vertex_y": torch.linspace(0, 0.41, W, device=device).expand(rows, W).contiguous(),
        "metadata_t0": 0.08 * torch.floor(49 * u[4]),
        "metadata_dt": torch.full((rows,), 0.08, device=device),
    }


def make_batches(kind: str, g: torch.Generator, pool: int, rows: int, frames: int, hw, channels: int,
                 device) -> List[Dict[str, torch.Tensor]]:
    """``pool`` distinct batches of ``rows`` rows and ``frames`` frames in
    the datamodule's layout: 'synthetic' (dynamics only) or 'navier_stokes'
    (dynamics, condition and the boundary metadata)."""
    out = []
    for _ in range(pool):
        batch = {"dynamics": smooth_fields(g, rows, frames, hw, channels, device)}
        if kind == "navier_stokes":
            batch.update(ns_static(g, rows, hw, device))
        out.append(batch)
    return out


# the nn-benchmark layout of the Navier-Stokes archive: split -> directory
NS_SUBDIRS = {
    "train": "ns-runs_train-navier-stokes-n100-t65-n0_00001",
    "val": "ns-runs_val-navier-stokes-n2-t65-n0_00001",
    "test": "ns-runs_eval-cors1-navier-stokes-n5-t65-n0_tagcors1_00001",
}


def write_ns_archive(root: str, seed: int, hw=(221, 42), n_time: int = 65) -> str:
    """One trajectory per split in the nn-benchmark archive's own format
    (``system_meta.json`` and ``trajectories.npz`` with flat (time, H*W, c)
    fields under per-trajectory keys), written from ``seed`` under
    ``root/navier-stokes-multi/run/data_gen``. Returns ``root``. The
    datamodule reads it to set up; the timed batches are made apart."""
    rng = np.random.default_rng(sub_seed(seed, "archive"))
    H, W = hw
    hw_n = H * W
    for split, sub in NS_SUBDIRS.items():
        d = os.path.join(root, "navier-stokes-multi", "run", "data_gen", sub)
        os.makedirs(d, exist_ok=True)
        key = "traj00000"
        t = np.arange(n_time, dtype=np.float64) * 0.08
        base = np.sin(np.linspace(0, 4 * np.pi, hw_n) + rng.uniform(0, 2 * np.pi))
        p = np.stack([np.outer(np.sin(0.3 * t + c), base) for c in range(2)], -1).astype(np.float32)
        q = np.outer(np.cos(0.3 * t), base).astype(np.float32)
        fixed = np.zeros((H, W), bool)
        fixed[:, 0] = fixed[:, -1] = True
        fk = {"p": f"{key}_p", "q": f"{key}_q", "t": f"{key}_t", "fixed_mask_p": f"{key}_fmp",
              "fixed_mask_q": f"{key}_fmq", "extra_fixed_mask": f"{key}_efm", "vertices": f"{key}_vertices"}
        yy = np.linspace(0, 0.41, W)
        arrays = {
            fk["p"]: p, fk["q"]: q, fk["t"]: t,
            fk["fixed_mask_p"]: np.repeat(fixed.reshape(hw_n, 1), 2, 1), fk["fixed_mask_q"]: fixed.reshape(hw_n),
            fk["extra_fixed_mask"]: np.stack([np.zeros(hw_n), fixed.reshape(hw_n)], -1).astype(np.float32),
            fk["vertices"]: np.stack([np.tile(np.linspace(0, 2.2, H)[:, None], (1, W)).reshape(-1),
                                      np.tile(yy[None, :], (H, 1)).reshape(-1)], -1).astype(np.float32),
        }
        meta = {"name": key, "num_time_steps": n_time, "time_step_size": 0.08, "in_velocity": 1.0,
                "field_keys": fk}
        with open(os.path.join(d, "system_meta.json"), "w") as f:
            json.dump({"system": "navier-stokes", "metadata": {}, "trajectories": [meta]}, f)
        np.savez(os.path.join(d, "trajectories.npz"), **arrays)
    return root
