"""Physical-systems benchmark data: Navier-Stokes and spring-mesh.

A numpy copy of ``dyffusion_tpu/data/physical_systems.py`` (the port does
not import the JAX package), so the same archive gives identical arrays in
both packages:

- parses the nn-benchmark layout (``system_meta.json`` + ``trajectories.npz``
  with per-trajectory field keys for p, q, t, fixed masks, vertices) and
  reassembles the flat (time, HW, c) fields into (time, H, W, C) grids;
- the same split subdirectory names, OOD and multi-obstacle test sets
  included;
- sliding-window examples with the per-example condition (the extra fixed
  mask) and metadata replicated;
- the physics boundary conditions re-imposed on predictions, as tensor ops
  on the predictions' device: the NS inflow profile
  ``4 v y (0.41 - y)/0.41^2 (1 - e^{-5t})`` in channel 0 of row 0 plus the
  fixed-mask zeroing, and the spring-mesh pinned nodes ``(p=0, q=base_q)``.

:func:`write_fake_benchmark_dir` writes synthetic trajectories in the exact
on-disk layout at the real grids (used by the tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from dyffusion_tpu_torch.data.base import DataModule, DatasetSplit, sliding_window_multi_horizon

_SYSTEMS = {
    "navier-stokes": {"hw": (221, 42), "ndims_p": 2, "ndims_q": 1},
    "spring-mesh": {"hw": (10, 10), "ndims_p": 2, "ndims_q": 2},
}


class TrajectoryReader:
    """Reads one split directory of the nn-benchmark layout."""

    def __init__(self, data_dir: str, subsample: int = 1, max_samples: Optional[int] = None):
        data_dir = pathlib.Path(data_dir)
        with open(data_dir / "system_meta.json", encoding="utf8") as f:
            meta = json.load(f)
        self.system = meta["system"]
        self.system_metadata = meta.get("metadata", {})
        self._traj_meta = meta["trajectories"]
        self._npz = np.load(data_dir / "trajectories.npz")
        self.subsample = subsample
        self.max_samples = max_samples
        self.h, self.w = _SYSTEMS[self.system]["hw"]

    def __len__(self) -> int:
        n = len(self._traj_meta)
        return n if self.max_samples is None else min(n, self.max_samples)

    def _grid(self, flat: np.ndarray) -> np.ndarray:
        """(time, H*W, c), (H*W, c), (time, H*W) or (H*W,) -> channels-last grid."""
        h, w = self.h, self.w
        if flat.ndim == 3:
            return flat.reshape(flat.shape[0], h, w, flat.shape[2])
        if flat.ndim == 2 and flat.shape[0] == h * w:
            return flat.reshape(h, w, flat.shape[1])
        if flat.ndim == 2:
            return flat.reshape(flat.shape[0], h, w, 1)
        return flat.reshape(h, w, 1)

    def get(self, idx: int) -> Dict[str, Any]:
        meta = dict(self._traj_meta[idx])
        keys = meta["field_keys"]
        q = self._npz[keys["q"]]
        t = self._npz[keys["t"]]
        # features = [p channels, q channels] on the last axis
        features = np.concatenate([self._npz[keys["p"]], q[..., None] if q.ndim == 2 else q], axis=-1)
        features = self._grid(features).astype(np.float32)

        def static_mask(key):
            return self._grid(self._npz[keys[key]]) if key in keys else None

        fixed_mask_p, fixed_mask_q = static_mask("fixed_mask_p"), static_mask("fixed_mask_q")
        fixed_mask = None
        if fixed_mask_p is not None and fixed_mask_q is not None:
            fixed_mask = np.concatenate([fixed_mask_p, fixed_mask_q], axis=-1)
        if self.subsample > 1:
            features = features[:: self.subsample]
            t = t[:: self.subsample]
            meta["time_step_size"] = meta["time_step_size"] * self.subsample
            meta["num_time_steps"] = len(t)
        return {
            "name": meta.get("name", str(idx)),
            "features": features,  # (time, H, W, C)
            "t": np.asarray(t, np.float32),
            "meta": meta,
            "fixed_mask": fixed_mask,  # (H, W, C) bool or None
            "condition": static_mask("extra_fixed_mask"),  # (H, W, Cc) or None
            "vertices": static_mask("vertices"),  # (H, W, 2) or None
        }


class PhysicalSystemsDataModule(DataModule):
    """The NS / spring-mesh datamodule. Test batches are single full
    trajectories (each spans the whole prediction horizon)."""

    def __init__(
        self,
        data_dir: str,
        physical_system: str = "navier-stokes",
        num_test_obstacles: int = 1,
        test_out_of_distribution: bool = False,
        num_trajectories: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        assert physical_system in _SYSTEMS, f"unknown system {physical_system}"
        assert self.window == 1, "window > 1 is not supported for this datamodule"
        self.physical_system = physical_system
        self.num_trajectories = num_trajectories
        self.num_test_obstacles = num_test_obstacles
        self.test_out_of_distribution = test_out_of_distribution

        # locate the nn-benchmark tree
        for sub in ("physical-nn-benchmark", "nn-benchmark"):
            cand = os.path.join(data_dir, sub)
            if "nn-benchmark" not in data_dir and os.path.isdir(cand):
                data_dir = cand
                break
        self.data_dir = data_dir

        ood = "outdist-" if test_out_of_distribution else ""
        if physical_system == "navier-stokes":
            first = "navier-stokes-multi"
            test_t = {1: 65, 4: 16, 16: 4}[num_test_obstacles]
            self.subdirs = {
                "train": "ns-runs_train-navier-stokes-n100-t65-n0_00001",
                "val": "ns-runs_val-navier-stokes-n2-t65-n0_00001",
                "test": (
                    f"ns-runs_eval-{ood}cors{num_test_obstacles}-navier-stokes-n5-"
                    f"t{test_t}-n0_tagcors{num_test_obstacles}_00001"
                ),
            }
        else:
            first = "spring-mesh"
            self.subdirs = {
                "train": "springmesh-10-perturball-runs_train-spring-mesh-n100-t805-n0_00001",
                "val": "springmesh-10-perturball-runs_val-spring-mesh-n3-t805-n0_00001",
                "test": f"springmesh-10-perturball-runs_eval-{ood}spring-mesh-n15-t805-n0_tagcors1_00001",
            }
        self.subdirs["predict"] = self.subdirs["val"]
        self._first_subdir = os.path.join(first, "run", "data_gen")

    @property
    def test_set_name(self) -> str:
        s = ""
        if self.num_test_obstacles != 1:
            s += f"{self.num_test_obstacles}obs"
        if self.test_out_of_distribution:
            s += "-ood"
        return s.lstrip("-")

    @property
    def dims(self) -> Dict[str, Any]:
        if self.physical_system == "navier-stokes":
            return {"input": 3, "output": 3, "conditional": 2, "spatial": (221, 42)}
        return {"input": 4, "output": 4, "conditional": 1, "spatial": (10, 10)}

    def get_horizon(self, split: str) -> int:
        if split in ("test", "predict"):
            return self.prediction_horizon or self.horizon
        return self.horizon

    def _split_dir(self, split: str) -> str:
        return os.path.join(self.data_dir, self._first_subdir, self.subdirs[split])

    def test_batches(self):
        """Single full trajectories, one per batch."""
        return self.split("test").batches(1)

    def setup(self, stage: Optional[str] = None) -> None:
        if self._splits:
            return
        for split in ("train", "val", "test", "predict"):
            reader = TrajectoryReader(self._split_dir(split), max_samples=1 if split == "predict" else None)
            self._splits[split] = DatasetSplit(self._build_split(reader, split))

    def _build_split(self, reader: TrajectoryReader, split: str) -> Dict[str, np.ndarray]:
        """Sliding-window examples with the condition and metadata replicated
        per example."""
        horizon = self.get_horizon(split)
        L = self.window + horizon
        n_traj = len(reader)
        if self.num_trajectories is not None and split == "train":
            n_traj = min(n_traj, self.num_trajectories)

        out: Dict[str, List[np.ndarray]] = {
            "dynamics": [], "condition": [], "metadata_fixed_mask": [],
            "metadata_t0": [], "metadata_dt": [], "metadata_in_velocity": [],
            "metadata_vertex_y": [], "metadata_base_q": [],
        }
        for i in range(n_traj):
            tr = reader.get(i)
            feats = tr["features"]
            n_ex = feats.shape[0] - L + 1
            assert n_ex > 0, f"trajectory {i} too short: {feats.shape[0]} < {L}"
            out["dynamics"].append(sliding_window_multi_horizon(feats, self.window, horizon).astype(np.float32))

            def rep(x):
                return np.repeat(x[None], n_ex, axis=0)

            if tr["condition"] is None:
                raise ValueError(
                    f"trajectory {i} of {self.physical_system!r} split {split!r} has no 'extra_fixed_mask' "
                    "field: the conditional channel this benchmark feeds the model is missing from the archive"
                )
            out["condition"].append(rep(np.asarray(tr["condition"], np.float32)))
            fm = tr["fixed_mask"]
            out["metadata_fixed_mask"].append(
                rep(np.asarray(fm, bool)) if fm is not None else rep(np.zeros(feats.shape[1:], bool))
            )
            # per-example start times: the window of frames starts at t[ex_index]
            out["metadata_t0"].append(tr["t"][:n_ex].astype(np.float32))
            out["metadata_dt"].append(np.full((n_ex,), float(tr["meta"].get("time_step_size", 1.0)), np.float32))
            if self.physical_system == "navier-stokes":
                out["metadata_in_velocity"].append(
                    np.full((n_ex,), float(tr["meta"].get("in_velocity", 1.0)), np.float32)
                )
                # y-coordinates along the left boundary row
                vy = tr["vertices"][0, :, 1] if tr["vertices"] is not None else np.zeros(reader.w)
                out["metadata_vertex_y"].append(rep(np.asarray(vy, np.float32)))
            else:
                # spring-mesh pinned positions: the q channels of the first frame
                out["metadata_base_q"].append(rep(feats[0, ..., 2:].astype(np.float32)))
        return {k: np.concatenate(v, axis=0) for k, v in out.items() if v}

    def boundary_conditions(
        self, preds: torch.Tensor, metadata: Optional[Mapping[str, Any]] = None, time=None
    ) -> torch.Tensor:
        """Re-impose the boundary conditions on predictions (..., B, H, W, C)
        (channels last), B matching the metadata's batch axis; extra leading
        axes (ensemble members) broadcast. ``time`` is the absolute
        simulation time (a scalar or (B,))."""
        md = metadata or {}
        dev = preds.device

        def get(key):
            return torch.as_tensor(md[key], device=dev)

        fixed = get("metadata_fixed_mask").bool()  # (B, H, W, C)
        if self.physical_system == "navier-stokes":
            preds = torch.where(fixed, torch.zeros((), dtype=preds.dtype, device=dev), preds)
            v = get("metadata_in_velocity").float()  # (B,)
            vy = get("metadata_vertex_y").float()  # (B, W)
            t = torch.as_tensor(0.0 if time is None else time, dtype=torch.float32, device=dev)
            t = torch.broadcast_to(t, v.shape)
            inflow = v[:, None] * 4.0 * vy * (0.41 - vy) / (0.41 * 0.41) * (1.0 - torch.exp(-5.0 * t))[:, None]
            preds = preds.clone()
            preds[..., 0, :, 0] = inflow.to(preds.dtype)  # (B, W) into row 0 of channel 0
            return preds
        base_q = get("metadata_base_q").to(preds.dtype)  # (B, H, W, 2)
        pinned = torch.cat([torch.zeros_like(base_q), base_q], dim=-1)  # p = 0, q = base
        return torch.where(fixed, pinned, preds)

    def get_boundary_condition_kwargs(self, batch, batch_idx: int, split: str) -> Dict[str, Any]:
        return {"t0": np.asarray(batch["metadata_t0"]), "dt": np.asarray(batch["metadata_dt"])}


def write_fake_benchmark_dir(
    root: str,
    physical_system: str = "spring-mesh",
    n_traj: Optional[Dict[str, int]] = None,
    n_time: int = 24,
    seed: int = 0,
) -> str:
    """Write a small nn-benchmark-layout dataset under ``root`` with the
    exact subdir names, ``system_meta.json`` schema and npz field keys of
    the real archives, at the real grid (so the whole parsing path runs).
    The same arguments write the same files as the JAX package's function."""
    rng = np.random.default_rng(seed)
    cfg = _SYSTEMS[physical_system]
    h, w = cfg["hw"]
    hw = h * w
    n_traj = n_traj or {"train": 3, "val": 2, "test": 2}

    dm = PhysicalSystemsDataModule(data_dir=root, physical_system=physical_system, horizon=4)
    for split in ("train", "val", "test"):
        d = os.path.join(root, dm._first_subdir, dm.subdirs[split])
        os.makedirs(d, exist_ok=True)
        trajs, npz = [], {}
        for i in range(n_traj[split]):
            key = f"traj{i:05d}"
            tt = np.arange(n_time, dtype=np.float64) * 0.1
            phase = rng.uniform(0, 2 * np.pi)
            base = np.sin(np.linspace(0, 4 * np.pi, hw) + phase)
            p = np.stack([np.outer(np.sin(0.3 * tt + c), base).astype(np.float32) for c in range(2)], axis=-1)
            if cfg["ndims_q"] == 1:
                q = np.outer(np.cos(0.3 * tt + phase), base).astype(np.float32)  # (time, hw)
            else:
                q = np.stack([np.outer(np.cos(0.3 * tt + c), base).astype(np.float32) for c in range(2)], axis=-1)
            fixed_p = np.zeros((hw, 2), bool)
            fixed_p[:w] = True  # pin the first row
            fixed_q = fixed_p[:, : cfg["ndims_q"]].reshape(hw, cfg["ndims_q"]).copy()
            if cfg["ndims_q"] == 1:
                fixed_q = fixed_q[:, 0]
            extra = rng.normal(size=(hw, 2 if physical_system == "navier-stokes" else 1)).astype(np.float32)
            field_keys = {
                "p": f"{key}_p", "q": f"{key}_q", "t": f"{key}_t",
                "dpdt": f"{key}_dpdt", "dqdt": f"{key}_dqdt",
                "fixed_mask_p": f"{key}_fmp", "fixed_mask_q": f"{key}_fmq",
                "extra_fixed_mask": f"{key}_efm",
            }
            npz.update({
                field_keys["p"]: p, field_keys["q"]: q, field_keys["t"]: tt,
                field_keys["dpdt"]: np.zeros_like(p), field_keys["dqdt"]: np.zeros_like(q),
                field_keys["fixed_mask_p"]: fixed_p, field_keys["fixed_mask_q"]: fixed_q,
                field_keys["extra_fixed_mask"]: extra,
            })
            meta = {"name": key, "num_time_steps": n_time, "time_step_size": 0.1, "field_keys": field_keys}
            if physical_system == "navier-stokes":
                meta["in_velocity"] = float(rng.uniform(0.5, 1.5))
                vkey = f"{key}_vertices"
                field_keys["vertices"] = vkey
                yy = np.linspace(0, 0.41, w)
                npz[vkey] = np.stack(
                    [np.tile(np.linspace(0, 2.2, h)[:, None], (1, w)).reshape(-1),
                     np.tile(yy[None, :], (h, 1)).reshape(-1)],
                    axis=-1,
                ).astype(np.float32)
            trajs.append(meta)
        with open(os.path.join(d, "system_meta.json"), "w") as f:
            json.dump({"system": physical_system, "metadata": {}, "trajectories": trajs}, f)
        np.savez(os.path.join(d, "trajectories.npz"), **npz)
    # the predict split shares the val directory
    return root
