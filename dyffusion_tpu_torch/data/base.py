"""Data layer: sliding-window multi-horizon datasets and the datamodule protocol.

A numpy copy of ``dyffusion_tpu/data/base.py`` (the port does not import
the JAX package), so the same seed gives identical arrays in both packages:
trajectories become (example, time, H, W, C) windows, batched by simple
host-side iterators. Arrays keep the JAX package's channels-last layout; the
experiments move channels in front when they hand data to the models.
:func:`local_eval_batches` gives each rank of a process group its box of
every eval batch: its data index's rows of the batch padded to the data
axis and, under spatial sharding, its model index's slab of every grid
value (``parallel.mesh.process_local_box``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np

from dyffusion_tpu_torch.parallel.mesh import local_batch, process_local_rows


def sliding_window_multi_horizon(trajectory: np.ndarray, window: int, horizon: int) -> np.ndarray:
    """All length-(window+horizon) sub-sequences of one trajectory.

    Equivalent to the reference's
    ``np.lib.stride_tricks.sliding_window_view`` construction
    (``physical_systems_benchmark.py:191-243``): a trajectory of T frames
    yields T - (window + horizon) + 1 examples of shape
    (window + horizon, H, W, C).
    """
    T = trajectory.shape[0]
    L = window + horizon
    assert T >= L, f"trajectory length {T} < window+horizon {L}"
    n = T - L + 1
    # sliding_window_view over the time axis; copy to make examples contiguous
    view = np.lib.stride_tricks.sliding_window_view(trajectory, L, axis=0)
    # view shape: (n, H, W, C, L) -> (n, L, H, W, C)
    return np.ascontiguousarray(np.moveaxis(view, -1, 1))


def build_examples(
    trajectories: np.ndarray,
    window: int,
    horizon: int,
    metadata: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Stack sliding windows over a batch of trajectories into one dataset
    dict with per-example metadata replication (ref ``:224-240``)."""
    dynamics, meta_out = [], {k: [] for k in (metadata or {})}
    for i in range(trajectories.shape[0]):
        ex = sliding_window_multi_horizon(trajectories[i], window, horizon)
        dynamics.append(ex)
        for k, v in (metadata or {}).items():
            meta_out[k].append(np.repeat(v[i : i + 1], ex.shape[0], axis=0))
    out = {"dynamics": np.concatenate(dynamics, axis=0).astype(np.float32)}
    for k, v in meta_out.items():
        out[k] = np.concatenate(v, axis=0)
    return out


def pad_batch(batch: Dict[str, Any], target: int):
    """Pad a host batch to ``target`` rows by repeating its last row;
    returns ``(padded batch, number of real rows)``."""
    n = int(next(iter(batch.values())).shape[0])
    if n == target:
        return batch, n
    if n > target:
        raise ValueError(f"a batch of {n} rows exceeds the pad target {target}")
    idx = np.concatenate([np.arange(n), np.full(target - n, n - 1, dtype=np.int64)])
    return {k: np.asarray(v)[idx] for k, v in batch.items()}, n


def local_eval_batches(batches: Iterable[Dict[str, Any]], data_rank: int = 0, data_size: int = 1, axis: str = "h",
                       model_rank: int = 0, model_size: int = 1):
    """``(this rank's box of the batch, the valid mask of its rows, first
    row, padded rows, real rows)`` per eval batch: each batch padded to a
    multiple of ``data_size`` by repeating its last row, then split into
    equal blocks of rows, and with ``model_size`` > 1 each grid value's H
    or W axis (``axis``) into equal slabs (one rank: the whole batch, all
    valid)."""
    import torch

    for batch in batches:
        n = int(next(iter(batch.values())).shape[0])
        target = -(-n // data_size) * data_size
        padded, n_valid = pad_batch(batch, target)
        rows = process_local_rows(target, data_rank, data_size)
        valid = torch.arange(rows.start, rows.stop) < n_valid
        yield local_batch(padded, rows, axis, model_rank, model_size), valid, rows.start, target, n_valid


@dataclasses.dataclass
class DatasetSplit:
    """An in-memory split: dict of arrays keyed by 'dynamics' (+ extras like
    'condition', 'metadata_*') sharing the leading example axis
    (the reference's ``MyTensorDataset``, ``torch_datasets.py:11-45``)."""

    tensors: Dict[str, np.ndarray]

    def __post_init__(self):
        n = len(self)
        for k, v in self.tensors.items():
            assert v.shape[0] == n, f"{k} has {v.shape[0]} examples != {n}"

    def __len__(self) -> int:
        return next(iter(self.tensors.values())).shape[0]

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = False,
    ) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        idx = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        stop = n - (n % batch_size) if drop_last else n
        for start in range(0, stop, batch_size):
            sel = idx[start : start + batch_size]
            yield {k: v[sel] for k, v in self.tensors.items()}


class DataModule:
    """Datamodule protocol (ref ``BaseDataModule``, ``abstract_datamodule.py:19-175``).

    Concrete datamodules implement :meth:`setup` and fill ``self._splits``
    with train/val/test/predict :class:`DatasetSplit`s. A datamodule with
    physics re-imposes its boundary conditions on predictions through
    :meth:`boundary_conditions` (an identity here).
    """

    def __init__(
        self,
        batch_size: int = 32,
        eval_batch_size: Optional[int] = None,
        window: int = 1,
        horizon: int = 1,
        prediction_horizon: Optional[int] = None,
    ):
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size or batch_size
        self.window = window
        self.horizon = horizon
        self.prediction_horizon = prediction_horizon
        self._splits: Dict[str, DatasetSplit] = {}

    # -- dims -------------------------------------------------------------
    @property
    def dims(self) -> Dict[str, Any]:
        """{'input': C, 'output': C, 'spatial': (H, W), 'conditional': C_cond}."""
        raise NotImplementedError

    def setup(self, stage: Optional[str] = None) -> None:
        raise NotImplementedError

    def split(self, name: str) -> DatasetSplit:
        if name not in self._splits:
            self.setup(name)
        return self._splits[name]

    def train_batches(self, rng: Optional[np.random.Generator] = None):
        """Shuffled train batches of ``batch_size`` rows; the last partial
        batch is dropped."""
        return self.split("train").batches(self.batch_size, shuffle=True, rng=rng, drop_last=True)

    def train_loader(self, rng: Optional[np.random.Generator] = None, device_put=None, rows: Optional[slice] = None,
                     slab: Optional[tuple] = None):
        """The batches of :meth:`train_batches`, in the same order for the
        same ``rng``, gathered by the native loader in a background thread
        and passed through ``device_put`` there (a
        :class:`~dyffusion_tpu_torch.data.native_loader.DeviceStager`
        stages them on the device). Under data parallelism ``batch_size``
        is the GLOBAL batch and ``rows`` this rank's rows of it
        (``parallel.mesh.process_local_rows``): every rank shuffles alike,
        and each gathers and stages only its own rows. Under spatial
        sharding ``slab`` = (axis, model rank, model size) also cuts every
        grid value to the rank's slab (``parallel.mesh.process_local_box``)
        before it is staged."""
        from dyffusion_tpu_torch.data.native_loader import PrefetchIterator

        return PrefetchIterator(
            self.split("train").tensors, batch_size=self.batch_size, shuffle=True, rng=rng, drop_last=True,
            device_put=device_put, rows=rows, slab=slab,
        )

    def _balanced_eval_batch_size(self, n: int) -> int:
        """Minimal-padding eval batch size: the same NUMBER of batches as
        ``eval_batch_size`` would give, but sized so batches differ by at
        most one row. The Trainer pads every eval batch to one compile
        shape, and padded rows burn full sampler compute without earning
        any metric credit — e.g. 5 examples at eval_batch_size=4 would run
        4+4 padded rows for 5 rows of credit; balanced (3+2, padded to 3)
        runs 6."""
        if n <= 0:
            return self.eval_batch_size
        B = min(self.eval_batch_size, n)
        n_batches = -(-n // B)
        return -(-n // n_batches)

    def val_batches(self):
        split = self.split("val")
        return split.batches(self._balanced_eval_batch_size(len(split)))

    def test_batches(self):
        split = self.split("test")
        return split.batches(self._balanced_eval_batch_size(len(split)))

    def predict_batches(self):
        split = self.split("predict")
        return split.batches(self._balanced_eval_batch_size(len(split)))

    # -- physics hooks ----------------------------------------------------
    def boundary_conditions(self, preds, metadata=None, time=None):
        """Re-impose physical boundary conditions on predictions; the
        identity here."""
        return preds

    def get_boundary_condition_kwargs(self, batch: Dict[str, np.ndarray], batch_idx: int, split: str) -> Dict[str, Any]:
        return {"t0": 0.0, "dt": 1.0}


# the dims of each archive-backed dataset, before any datamodule is built
_DATASET_DIMS = {
    "oisstv2": lambda cfg: {
        "input": 1, "output": 1, "conditional": 0,
        "spatial": tuple(cfg.get("spatial_shape", (60, 60))),
    },
    "navier-stokes": lambda cfg: {"input": 3, "output": 3, "conditional": 2, "spatial": (221, 42)},
    "spring-mesh": lambda cfg: {"input": 4, "output": 4, "conditional": 1, "spatial": (10, 10)},
}


def get_dims_of_dataset(name: str, cfg: Optional[dict] = None) -> Dict[str, Any]:
    """{'input', 'output', 'conditional', 'spatial'} of the dataset ``name``."""
    if name not in _DATASET_DIMS:
        raise ValueError(f"Unknown dataset '{name}'. Available: {sorted(_DATASET_DIMS)}")
    return _DATASET_DIMS[name](cfg or {})
