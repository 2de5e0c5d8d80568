"""Serving: a trained run's ensemble sampler as one predict function.

Counterpart of ``dyffusion_tpu/serving.py::build_predict_fn``:
:func:`build_predict_fn` reloads a finished run from the registry by
``(registry_dir, run_id)`` and serves its eval weights (the EMA when the
run trained with ``module.use_ema``), as the JAX package does;
:func:`build_experiment_predict_fn` serves an experiment built in memory,
with the eval weights the caller passes. ``predict(batch, seed)`` runs the
experiment's eval path (for DYffusion the folded MC-dropout ensemble cold
sampler) and returns the (N, B, T, H, W, C) f32 ensemble forecast on the
experiment's device; with ``reduce='mean_std'`` it returns (2, B, T, H, W,
C), the ensemble mean and std, reduced on the device. ``batch`` is a dict
of arrays in the JAX package's layout: ``dynamics`` (B, frames, H, W, C),
of which ``info['dynamics_frames_read']`` are read (the conditioning
window; for an interpolation run also the last of its window + horizon
frames), plus any static ``condition``. The same seed gives the same
answer: it seeds one ``torch.Generator`` on the device, drawn in a fixed
order. The exported artifact (``export_run``) is not ported yet.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dyffusion_tpu_torch.data import DataModule
from dyffusion_tpu_torch.experiments import Experiment, InterpolationExperiment


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: np.dtype


def _dynamics_frame_contract(exp: Experiment) -> Tuple[int, List[int]]:
    """(frames, frames read) of ``batch['dynamics']``: a forecaster reads
    its conditioning window; an interpolator takes window + horizon frames
    (the training layout) and reads the window and the last frame."""
    w = exp.cfg.window
    if isinstance(exp, InterpolationExperiment):
        h = exp.cfg.horizon
        return w + h, list(range(w)) + [w + h - 1]
    return w, list(range(w))


def _t_index(key: str) -> int:
    m = re.fullmatch(r"t(\d+)_preds", key)
    return int(m.group(1)) if m else -1


def build_experiment_predict_fn(
    experiment: Experiment,
    eval_fns: Dict[str, Callable],
    datamodule: DataModule,
    params: Optional[Mapping[str, torch.Tensor]],
    split: str = "predict",
    batch_size: Optional[int] = None,
    reduce: Optional[str] = None,
) -> Tuple[Callable, Dict[str, TensorSpec], Dict[str, Any]]:
    """Return ``(predict, input_specs, info)`` for ``experiment``'s ``split``
    eval function (``eval_fns`` as :func:`dyffusion_tpu_torch.interface.
    build_experiment` returns them), served with the weights ``params``:
    the eval weights (``TrainState.eval_params()``, the EMA when it is on;
    ``None`` is the model's own weights). ``input_specs`` takes its layout
    from the split's own data, dynamics cut to the frames served, leading
    dim ``batch_size`` (default: the datamodule's eval batch size)."""
    if reduce not in (None, "mean_std"):
        raise ValueError(f"unknown reduce '{reduce}' (choose None or 'mean_std')")
    eval_fn = eval_fns[split]
    example = next(iter(datamodule.split(split).batches(1)), None)
    if example is None:
        raise ValueError(f"split '{split}' is empty: cannot derive the serving input spec")
    frames, frames_read = _dynamics_frame_contract(experiment)
    if batch_size is None:
        batch_size = int(datamodule.eval_batch_size)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    input_specs = {}
    for k, v in example.items():
        v = np.asarray(v)
        tail = (frames,) + v.shape[2:] if k == "dynamics" else v.shape[1:]
        input_specs[k] = TensorSpec((batch_size,) + tuple(tail), v.dtype)

    def predict(batch: Dict[str, Any], seed: int) -> torch.Tensor:
        generator = torch.Generator(device=experiment.device)
        generator.manual_seed(int(seed))
        out = eval_fn(batch, generator, params)
        keys = sorted((k for k in out if _t_index(k) > 0), key=_t_index)
        members = torch.stack([out[k] for k in keys], dim=2)  # (N, B, T, H, W, C)
        if reduce == "mean_std":
            return torch.stack([members.mean(dim=0), members.std(dim=0, unbiased=False)], dim=0)
        return members

    info = {
        "experiment": type(experiment).__name__,
        "ensemble_members": int(experiment.num_members(split)),
        "dynamics_frames": int(frames),
        "dynamics_frames_read": frames_read,
        "device": str(experiment.device),
        "batch_size": int(batch_size),
        "reduce": reduce,
    }
    return predict, input_specs, info


def build_predict_fn(
    registry_dir: str,
    run_id: str,
    overrides: Optional[List[str]] = None,
    slot: str = "best",
    split: str = "predict",
    batch_size: Optional[int] = None,
    reduce: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> Tuple[Callable, Dict[str, TensorSpec], Dict[str, Any]]:
    """Reload run ``run_id`` of the registry (its ``slot`` checkpoint, else
    ``last``; ``overrides`` over its stored config) and serve its ``split``
    eval path with the run's eval weights: ``(predict, input_specs, info)``
    as :func:`build_experiment_predict_fn` returns them, ``info`` also
    naming the run and slot. ``split`` sets the ensemble size (``test``:
    ``module.num_predictions_test``)."""
    if reduce not in (None, "mean_std"):  # before the reload
        raise ValueError(f"unknown reduce '{reduce}' (choose None or 'mean_std')")
    from dyffusion_tpu_torch.interface import reload_trainer

    trainer = reload_trainer(registry_dir, run_id, overrides, slot=slot, device=device)
    predict, specs, info = build_experiment_predict_fn(
        trainer.experiment, trainer.eval_fns, trainer.datamodule, trainer.state.eval_params(),
        split=split, batch_size=batch_size, reduce=reduce,
    )
    return predict, specs, {"run_id": run_id, "slot": slot, **info}
