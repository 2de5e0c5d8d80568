"""OISSTv2 daily sea-surface-temperature datamodule.

A numpy copy of ``dyffusion_tpu/data/oisstv2.py`` (the port does not import
the JAX package), so the same boxes give identical arrays in both packages:
60x60 regional SST boxes, several boxes at once (the named Pacific subset),
date-based splits (train up to 2018-12-31, val 2019, test 2020, predict a
configurable slice), the boxes stacked along the example axis, sliding
windows of window + horizon days, and an optional npz cache keyed by every
input of a split.

Per box, the data comes from the first of:

1. ``sst.day.mean.box{b}.npz``: ``sst`` (time, lat, lon) and ``time``
   (datetime64[D]) arrays (convert a NetCDF box once with
   :func:`convert_netcdf_box_to_npz`);
2. ``sst.day.mean.box{b}.nc``: NetCDF, read with ``xarray`` where it is
   installed (the archive's own format).

Layout: NHWC, examples are (example, window + horizon, lat, lon, 1).
:func:`write_fake_oisst_dir` writes small synthetic boxes in the on-disk
layout for tests and demos.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from dyffusion_tpu_torch.data.base import DataModule, DatasetSplit, sliding_window_multi_horizon

PACIFIC_BOXES = [84, 85, 86, 87, 88, 89, 108, 109, 110, 111, 112]


def get_name_for_boxes(boxes) -> str:
    if list(boxes) == PACIFIC_BOXES:
        return "Pacific"
    return ",".join(str(b) for b in boxes)


def _read_netcdf(nc_path) -> Tuple[np.ndarray, np.ndarray]:
    import xarray as xr

    ds = xr.open_dataset(nc_path)
    return (
        ds["sst"].transpose("time", "lat", "lon").values.astype(np.float32),
        ds["time"].values.astype("datetime64[D]"),
    )


def convert_netcdf_box_to_npz(nc_path: str, npz_path: Optional[str] = None) -> str:
    """Convert one NetCDF box to the npz layout (needs ``xarray``)."""
    sst, time = _read_netcdf(nc_path)
    npz_path = npz_path or nc_path.replace(".nc", ".npz")
    np.savez_compressed(npz_path, sst=sst, time=time)
    return npz_path


def _load_box(path_stem: pathlib.Path) -> Tuple[np.ndarray, np.ndarray]:
    """One box as (sst (time, lat, lon) float32, time datetime64[D])."""
    # with_suffix would cut the dotted stem ("sst.day.mean.box84")
    npz = path_stem.parent / (path_stem.name + ".npz")
    if npz.exists():
        f = np.load(npz)
        return f["sst"].astype(np.float32), f["time"].astype("datetime64[D]")
    nc = path_stem.parent / (path_stem.name + ".nc")
    if nc.exists():
        return _read_netcdf(nc)
    raise FileNotFoundError(f"no {npz} or {nc}")


class OISSTv2DataModule(DataModule):
    """``data_dir`` may be the archive's root (with an ``oisstv2-daily`` or
    ``oisstv2`` directory) or the box directory itself. ``boxes``,
    ``validation_boxes`` and ``predict_boxes`` are lists of box ids or
    ``"all"`` (every box file found; validation's ``"all"`` means
    ``boxes``). ``train_start_date`` is a date or a year (1980-2018)."""

    def __init__(
        self,
        data_dir: str,
        boxes: Union[List[int], str] = "all",
        validation_boxes: Union[List[int], str] = "all",
        predict_boxes: Union[List[int], str] = "all",
        predict_slice: Tuple[str, str] = ("2020-12-01", "2020-12-31"),
        train_start_date: Union[str, int, None] = None,
        box_size: int = 60,
        save_and_load_as_numpy: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if box_size != 60:
            raise ValueError(f"only 60x60 boxes are supported, got box_size={box_size}")
        for name in ("oisstv2-daily", "oisstv2"):
            cand = os.path.join(data_dir, name)
            if "oisst" not in data_dir and os.path.isdir(cand):
                data_dir = cand
                break
        sub = os.path.join(data_dir, f"subregion-{box_size}x{box_size}boxes-pixelwise_stats")
        if os.path.isdir(sub):
            data_dir = sub
        self.data_dir = pathlib.Path(data_dir)
        self.box_size = box_size
        self.boxes = boxes
        self.validation_boxes = validation_boxes
        self.predict_boxes = predict_boxes
        self.save_and_load_as_numpy = save_and_load_as_numpy
        if save_and_load_as_numpy:
            self.numpy_dir = self.data_dir / "numpy"
            os.makedirs(self.numpy_dir, exist_ok=True)

        if isinstance(train_start_date, int):
            if not 1980 <= train_start_date <= 2018:
                raise ValueError(f"Invalid train_start_date: {train_start_date}")
            train_start_date = f"{train_start_date}-01-01"
        self.slices = {
            "train": (train_start_date, "2018-12-31"),
            "val": ("2019-01-01", "2019-12-31"),
            "test": ("2020-01-01", "2020-12-31"),
            "predict": tuple(predict_slice),
        }

    @property
    def dims(self) -> Dict:
        return {"input": 1, "output": 1, "conditional": 0, "spatial": (self.box_size, self.box_size)}

    @property
    def dataset_identifier(self) -> str:
        boxes = get_name_for_boxes(self._resolve_boxes(self.boxes))
        return f"OISSTv2_{boxes}_horizon{self.horizon}_batch_stacked_multi_horizon"

    def get_horizon(self, split: str) -> int:
        if split in ("test", "predict"):
            return self.prediction_horizon or self.horizon
        return self.horizon

    def _resolve_boxes(self, boxes) -> List[int]:
        if boxes == "all":
            stems = sorted(self.data_dir.glob("sst.day.mean.box*.n*"))
            ids = sorted({int(p.stem.split("box")[-1]) for p in stems})
            if not ids:
                raise FileNotFoundError(f"no sst.day.mean.box*.nc/npz files under {self.data_dir}")
            return ids
        return list(boxes)

    def _boxes_for(self, split: str) -> List[int]:
        if split == "predict":
            return self._resolve_boxes(self.predict_boxes)
        if split == "val":
            v = self.validation_boxes
            return self._resolve_boxes(self.boxes if v == "all" else v)
        return self._resolve_boxes(self.boxes)

    def _numpy_cache_file(self, split: str) -> Optional[pathlib.Path]:
        """The split's npz cache, its name salted with every input the split
        is built from (window, horizon, dates, boxes), so that a changed
        setting never reads a stale cache."""
        if not self.save_and_load_as_numpy or split == "predict":
            return None
        salt_fields = (self.window, self.get_horizon(split), self.slices[split], tuple(self._boxes_for(split)))
        salt = hashlib.sha256(repr(salt_fields).encode()).hexdigest()[:10]
        return self.numpy_dir / f"{self.dataset_identifier}_{split}_{salt}.npz"

    def _build_split(self, split: str) -> Dict[str, np.ndarray]:
        cache = self._numpy_cache_file(split)
        if cache is not None and cache.exists():
            f = np.load(cache)
            return {k: f[k] for k in f.files}

        start, stop = self.slices[split]
        start_d = np.datetime64(start) if start else None
        stop_d = np.datetime64(stop) if stop else None
        horizon = self.get_horizon(split)
        L = self.window + horizon

        per_box = []
        for b in self._boxes_for(split):
            sst, time = _load_box(self.data_dir / f"sst.day.mean.box{b}")
            sel = np.ones(len(time), bool)
            if start_d is not None:
                sel &= time >= start_d
            if stop_d is not None:
                sel &= time <= stop_d
            sst = sst[sel]
            if sst.shape[0] < L:
                raise ValueError(f"box {b} split {split}: {sst.shape[0]} days < window + horizon = {L}")
            ex = sliding_window_multi_horizon(sst, self.window, horizon)[..., None]  # (n, L, lat, lon, 1)
            per_box.append(np.ascontiguousarray(ex, dtype=np.float32))
        out = {"dynamics": np.concatenate(per_box, axis=0)}  # the boxes stacked along the example axis
        if cache is not None:
            np.savez_compressed(cache, **out)
        return out

    def setup(self, stage: Optional[str] = None) -> None:
        # one split at a time: the default predict slice may lie outside the archive
        splits = (stage,) if stage in ("train", "val", "test", "predict") else ("train", "val", "test")
        for split in splits:
            if split not in self._splits:
                self._splits[split] = DatasetSplit(self._build_split(split))


def write_fake_oisst_dir(root: str, boxes: Sequence[int] = (84, 85), n_days_per_year: int = 30, seed: int = 0) -> str:
    """Write small synthetic npz boxes spanning 2018-2020 in the archive's
    layout under ``root``; returns the ``oisstv2`` directory. The same
    arguments write the same arrays as the JAX package's function."""
    rng = np.random.default_rng(seed)
    d = pathlib.Path(root) / "oisstv2" / "subregion-60x60boxes-pixelwise_stats"
    os.makedirs(d, exist_ok=True)
    days = []
    for year in (2018, 2019, 2020):
        start = np.datetime64(f"{year}-01-01")
        days.append(start + np.arange(n_days_per_year))
    time = np.concatenate(days)
    T = len(time)
    yy, xx = np.meshgrid(np.linspace(0, 2 * np.pi, 60), np.linspace(0, 2 * np.pi, 60), indexing="ij")
    for b in boxes:
        phase = rng.uniform(0, 2 * np.pi)
        t = np.arange(T)[:, None, None]
        sst = np.sin(xx + 0.1 * t + phase) + 0.5 * np.cos(yy - 0.07 * t)
        np.savez_compressed(
            d / f"sst.day.mean.box{b}.npz", sst=sst.astype(np.float32), time=time.astype("datetime64[D]")
        )
    return str(pathlib.Path(root) / "oisstv2")
