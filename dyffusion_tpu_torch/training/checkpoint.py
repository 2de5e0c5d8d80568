"""Checkpoints and the local run registry (counterpart of
``dyffusion_tpu/training/checkpoint.py``).

A run directory ``<registry>/<run_id>/`` holds the ``best`` (by the
monitored metric) and ``last`` slots, ``meta.json`` (``best_score``,
``best_monitor``, ``best_step``, ``last_step``, ``epochs_done``) and
``config.json``: the JAX package's layout and file names. A slot holds one
``state.pt``, a plain dict of CPU tensors and numbers written with
``torch.save`` and read with ``torch.load(weights_only=True)``; the JAX
package's slots are orbax directories, which the port cannot read and says
so. A slot is written to ``<slot>.tmp`` and then moved into place, so a
crash mid-save leaves the previous slot whole.

Under data parallelism rank 0 alone writes slots, meta, config and the
rotation of a start-over; every rank reads. The registry must then be on a
filesystem every rank sees: a manager checks it when it is made (a probe
file written by rank 0, looked for by every rank). A barrier
(``parallel.distributed.barrier``) follows each write that other ranks
will read.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from dyffusion_tpu_torch.parallel import distributed
from dyffusion_tpu_torch.utils.logging import is_rank_zero

STATE_FILE = "state.pt"


class CheckpointManager:
    """Per-run checkpoint directory with ``last`` and ``best`` slots."""

    def __init__(self, run_dir: str, monitor: str, mode: str = "min"):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        if distributed.world_size() > 1:
            self._assert_shared_filesystem()
        self.best_score: Optional[float] = self._read_meta().get("best_score")  # a resumed run's best so far

    def _assert_shared_filesystem(self) -> None:
        """Raise on every rank unless every rank sees rank 0's probe file
        in the run directory."""
        probe = os.path.join(self.run_dir, ".shared_fs_probe")
        if is_rank_zero():
            with open(probe, "w") as f:
                f.write("shared-filesystem probe of the checkpoint manager")
        distributed.barrier()
        seen = torch.tensor([float(os.path.exists(probe))], device=distributed.collective_device())
        missing = distributed.world_size() - int(distributed.all_reduce_sum(seen).item())
        if missing:
            raise RuntimeError(
                f"checkpoint dir {self.run_dir!r} is not visible from every rank ({missing} of "
                f"{distributed.world_size()} do not see it): a data-parallel run needs registry_dir on a "
                "filesystem all ranks share"
            )

    def _slot_dir(self, slot: str) -> str:
        return os.path.join(self.run_dir, slot)

    def _read_meta(self) -> Dict[str, Any]:
        path = os.path.join(self.run_dir, "meta.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def _write_meta(self, meta: Dict[str, Any]) -> None:
        if not is_rank_zero():
            return
        with open(os.path.join(self.run_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)

    def _update_meta(self, **updates) -> None:
        self._write_meta({**self._read_meta(), **updates})

    def save_config(self, config: Dict[str, Any]) -> None:
        """Persist the full run config as ``config.json``."""
        if not is_rank_zero():
            return
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)

    def load_config(self) -> Dict[str, Any]:
        with open(os.path.join(self.run_dir, "config.json")) as f:
            return json.load(f)

    def _save_slot(self, slot: str, state: Dict[str, Any]) -> None:
        if not is_rank_zero():
            return
        path = self._slot_dir(slot)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def save_last(self, state: Dict[str, Any], step: int, epochs_done: Optional[int] = None) -> None:
        self._save_slot("last", state)
        if epochs_done is None:
            self._update_meta(last_step=step)
        else:
            self._update_meta(last_step=step, epochs_done=int(epochs_done))

    @property
    def epochs_done(self) -> int:
        """Completed epochs recorded with the ``last`` slot: a resumed run
        continues from the next epoch."""
        return int(self._read_meta().get("epochs_done", 0))

    def is_improvement(self, score: float) -> bool:
        if self.best_score is None or np.isnan(self.best_score):
            return True
        return score < self.best_score if self.mode == "min" else score > self.best_score

    def save_best_if_improved(self, state: Dict[str, Any], score: float, step: int) -> bool:
        if not np.isfinite(score) or not self.is_improvement(score):
            return False
        self.best_score = float(score)
        self._save_slot("best", state)
        self._update_meta(best_score=self.best_score, best_monitor=self.monitor, best_step=step)
        return True

    def restore(self, slot: str = "last") -> Optional[Dict[str, Any]]:
        """The slot's stored state (CPU tensors), or ``None`` if the slot is
        absent. A slot without the port's ``state.pt`` (an orbax slot of the
        JAX package) raises."""
        path = self._slot_dir(slot)
        if not os.path.exists(path):
            return None
        file = os.path.join(path, STATE_FILE)
        if not os.path.isfile(file):
            raise ValueError(
                f"checkpoint slot {path} holds no {STATE_FILE}: it was not written by dyffusion_tpu_torch "
                f"(an orbax slot of the JAX package holds {sorted(os.listdir(path))[:5]}); the port cannot read it"
            )
        return torch.load(file, map_location="cpu", weights_only=True)

    def has(self, slot: str) -> bool:
        return os.path.exists(self._slot_dir(slot))

    def reset_run_state(self) -> None:
        """Start over in this directory: drop the ``best``/``last`` slots and
        the meta counters, so the fresh run neither inherits a best score
        that would suppress its ``best`` slot nor saves the old run's
        ``epochs_done`` beside new weights; rotate the old ``metrics.jsonl``
        and ``curves/`` to ``<name>.<n>`` so the directory holds one run's
        outputs."""
        self.best_score = None
        if not is_rank_zero():
            return
        for slot in ("best", "last"):
            path = self._slot_dir(slot)
            if os.path.exists(path):
                shutil.rmtree(path)
        for name in ("metrics.jsonl", "curves"):
            path = os.path.join(self.run_dir, name)
            if os.path.exists(path):
                n = 1
                while os.path.exists(f"{path}.{n}"):
                    n += 1
                os.replace(path, f"{path}.{n}")
        meta = self._read_meta()
        for key in ("best_score", "best_monitor", "best_step", "last_step", "epochs_done"):
            meta.pop(key, None)
        self._write_meta(meta)


def find_run_dir(registry_dir: str, run_id: str) -> str:
    """The directory of run ``run_id`` in the local registry."""
    path = os.path.join(os.path.abspath(registry_dir), run_id)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"run '{run_id}' not found under {registry_dir}")
    return path
