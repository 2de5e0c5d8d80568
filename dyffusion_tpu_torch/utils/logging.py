"""Metrics logging (counterpart of ``dyffusion_tpu/utils/logging.py``).

- :class:`MetricsLogger`: a JSONL metric stream (``metrics.jsonl``) and a
  hyperparameter snapshot (``hparams.json``) in the run directory, in the
  JAX package's record layout, with an optional wandb mirror where the
  package is importable;
- :func:`save_arrays_as_line_plot`: per-horizon metric curves as npz + json
  under ``curves/``;
- :func:`get_logger`: a python logger.

Under data parallelism only rank zero of the process group writes the
metric stream, the hyperparameters and the wandb mirror, and only its
logger speaks at INFO.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np


def is_rank_zero() -> bool:
    """Rank zero of the process group, or the one process outside one."""
    from dyffusion_tpu_torch.parallel import distributed

    return distributed.rank() == 0


def get_logger(name: str = "dyffusion_tpu_torch") -> logging.Logger:
    """A python logger with one stream handler, at INFO on rank zero."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO if is_rank_zero() else logging.WARNING)
    return logger


class MetricsLogger:
    """JSONL metrics + hparams snapshot (+ optional wandb mirror)."""

    def __init__(self, run_dir: str, use_wandb: bool = False, wandb_kwargs: Optional[dict] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._wandb = None
        if use_wandb and is_rank_zero():
            try:
                import wandb

                self._wandb = wandb.init(dir=run_dir, **(wandb_kwargs or {}))
            except Exception:  # wandb not installed / offline: the JSONL stream is the record
                self._wandb = None

    def log_hyperparams(self, config: Dict[str, Any]) -> None:
        if not is_rank_zero():
            return
        with open(os.path.join(self.run_dir, "hparams.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
        if self._wandb is not None:
            self._wandb.config.update(config, allow_val_change=True)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if not is_rank_zero():
            return
        record = {"step": int(step), "time": time.time()}
        record.update({k: (float(v) if np.isscalar(v) or hasattr(v, "item") else v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def save_arrays_as_line_plot(
    run_dir: str,
    x: np.ndarray,
    metrics: Dict[str, np.ndarray],
    key_stem: str,
    x_label: str = "horizon",
) -> str:
    """Persist per-horizon metric curves: one npz with the arrays and a json
    table, under ``<run_dir>/curves/``. Returns that directory."""
    safe = key_stem.replace("/", "_").strip("_")
    out_dir = os.path.join(run_dir, "curves")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{safe}.npz"), **{x_label: np.asarray(x)}, **{k: np.asarray(v) for k, v in metrics.items()})
    table = {x_label: np.asarray(x).tolist(), **{k: np.asarray(v).tolist() for k, v in metrics.items()}}
    with open(os.path.join(out_dir, f"{safe}.json"), "w") as f:
        json.dump(table, f)
    return out_dir
