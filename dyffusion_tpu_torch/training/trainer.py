"""The trainer: train step, metric sums, the fit loop and streamed evaluation.

Counterpart of ``dyffusion_tpu/training/trainer.py`` on one device:

- :func:`make_train_step`: loss, backward, the optimizer step and the EMA,
  with the ``grad_norm`` and ``zero_grad_frac`` metrics. Metrics stay
  device tensors; the host reads them only at log points.
- :func:`mixed_precision_loss`: ``module.train_dtype=bfloat16`` as a cast at
  the loss boundary (not ``torch.autocast``, which would keep softmaxes and
  norms in f32 and so compute something else than the JAX package).
- :class:`Trainer`: ``fit`` (epochs, ``max_steps``, log cadence, validation
  cadence, early stopping, the best monitored score, the ``best`` and
  ``last`` checkpoints at each validation, resume by epoch), ``evaluate``
  (the experiment's folded ensemble eval function over a split, CRPS/MSE/SSR
  reduced as streamed per-batch sums on the device), ``predict`` and
  ``test`` (which saves the per-horizon curves).

Not ported yet: data parallelism (and with it the padding of eval batches
to the data axis, which off a mesh never pads), ``watch_gradients``, the
profiler.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from dyffusion_tpu_torch.models.base import MODEL_STATE_UPDATES
from dyffusion_tpu_torch.training.checkpoint import CheckpointManager
from dyffusion_tpu_torch.training.state import TrainState
from dyffusion_tpu_torch.utils.logging import save_arrays_as_line_plot

# loss_fn(params, batch, generator) -> (loss, metrics); params replaces the
# model's weights for the call (None: its own)
LossFn = Callable[[Optional[Dict[str, torch.Tensor]], Dict[str, Any], Optional[torch.Generator]], Any]


def mixed_precision_loss(loss_fn: LossFn, model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> LossFn:
    """Run ``loss_fn`` on ``dtype`` copies of the model's weights and
    buffers (BatchNorm running statistics, as the JAX package casts every
    variable) and of the batch's float arrays. The f32 master weights,
    optimizer state, EMA and buffers are untouched; gradients come back f32
    through the casts, the loss reductions stay f32 (``utils/loss.py``), and
    so do the BatchNorm updates (computed in f32, copied into f32 buffers)."""

    def cast(v):
        return v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v

    def wrapped(params, batch, generator):
        source = params if params is not None else dict(model.named_parameters())
        source = {**dict(model.named_buffers()), **source}
        return loss_fn({k: cast(v) for k, v in source.items()}, {k: cast(v) for k, v in batch.items()}, generator)

    return wrapped


def make_train_step(loss_fn: LossFn) -> Callable[[TrainState, Dict[str, Any]], Dict]:
    """``train_step(state, batch) -> metrics``: gradients of ``loss_fn`` with
    respect to the model's trainable weights, then
    :meth:`TrainState.apply_gradients` with the BatchNorm updates the loss
    returned under ``MODEL_STATE_UPDATES``. ``state`` is updated in place."""

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        loss, metrics = loss_fn(None, batch, state.generator)
        metrics = dict(metrics)
        updates = metrics.pop(MODEL_STATE_UPDATES, None)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            grads = [p.grad for p in state.params.values() if p.grad is not None]
            n_total = sum(p.numel() for p in state.params.values())
            metrics["grad_norm"] = torch.sqrt(sum(g.float().square().sum() for g in grads))
            # zero-gradient fraction; a weight the loss does not reach counts as zeros
            n_unreached = n_total - sum(g.numel() for g in grads)
            metrics["zero_grad_frac"] = (sum((g == 0).sum() for g in grads) + n_unreached) / n_total
        state.apply_gradients(updates)
        return metrics

    return train_step


def metric_sums(preds: torch.Tensor, targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-batch sums {n, sq, var, crps} of the streaming ensemble metrics,
    preds (m, B, ...) and targets (B, ...): mse = sq/n, crps = crps/n,
    ssr = sqrt(var/n)/sqrt(sq/n). CRPS uses the sorted O(m log m)
    estimator."""
    preds, targets = preds.float(), targets.float()
    m = preds.shape[0]
    n = torch.tensor(float(targets.numel()), device=preds.device)
    sq = ((preds.mean(dim=0) - targets) ** 2).sum()
    var = preds.var(dim=0, unbiased=False).sum()
    x = torch.sort(preds, dim=0).values
    skill = (x - targets[None]).abs().mean(dim=0)
    i = torch.arange(1, m + 1, device=preds.device, dtype=torch.float32).reshape((m,) + (1,) * targets.ndim)
    spread = (x * (2 * i - m - 1)).sum(dim=0) / (m * m)
    return {"n": n, "sq": sq, "var": var, "crps": (skill - spread).sum()}


class Trainer:
    """Fit loop and evaluation over one experiment on its device. With a
    ``run_dir`` (and ``save_checkpoints``) it keeps the run's ``best`` and
    ``last`` checkpoints there (``self.ckpt``); without one it trains in
    memory."""

    def __init__(
        self,
        experiment,
        datamodule,
        state: TrainState,
        loss_fn: LossFn,
        eval_fns: Dict[str, Callable],
        max_epochs: int = 10,
        max_steps: Optional[int] = None,
        seed: int = 0,
        monitor: Optional[str] = None,
        val_every_n_epochs: int = 1,
        log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
        early_stopping_patience: Optional[int] = None,
        log_every_n_steps: int = 50,
        run_dir: Optional[str] = None,
        save_checkpoints: bool = True,
        monitor_mode: str = "min",
    ):
        self.experiment = experiment
        self.datamodule = datamodule
        self.device = experiment.device
        self.state = state
        self.train_step = make_train_step(loss_fn)
        self.eval_fns = eval_fns
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.seed = seed
        self.monitor = monitor or experiment.monitor
        self.monitor_mode = monitor_mode
        self.val_every_n_epochs = val_every_n_epochs
        self.log_fn = log_fn or (lambda metrics, step: None)
        self.early_stopping_patience = early_stopping_patience
        self.log_every_n_steps = max(int(log_every_n_steps), 1)
        self.history: List[Dict[str, float]] = []
        self._np_rng = np.random.default_rng(seed)
        self._epochs_without_improvement = 0
        self.ckpt = CheckpointManager(run_dir, self.monitor, monitor_mode) if run_dir and save_checkpoints else None
        # fully completed epochs, kept current by fit() so that a save from
        # outside the loop (a signal, a crash) records a matching epochs_done
        self.epochs_completed = 0
        # per-horizon curves {metric: {"t": [...], "value": [...]}} of the last evaluate()
        self.last_eval_curves: Dict[str, Dict[str, list]] = {}

    def _state_tree(self) -> Dict[str, Any]:
        """The checkpoint of the train state (``TrainState.state_dict``)."""
        return self.state.state_dict()

    def _load_state_tree(self, tree: Dict[str, Any]) -> None:
        self.state.load_state_dict(tree)

    def maybe_resume(self, slot: str = "last") -> bool:
        """Load the ``slot`` checkpoint of the run directory, if it has one."""
        if self.ckpt is None or not self.ckpt.has(slot):
            return False
        self._load_state_tree(self.ckpt.restore(slot))
        return True

    def _put(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch as tensors on the device."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def fit(self) -> float:
        """Train with periodic validation; returns the best monitored score
        (nan if no validation gave a finite one)."""
        best = np.nan
        step = self.state.step
        done = False
        step_units = self.state.fold_factor  # a folded batch is fold_factor micro-batches
        # a resumed run continues at the epoch after its last checkpoint, and
        # its best so far comes from the registry's meta
        start_epoch = 0
        if step > 0 and self.ckpt is not None:
            start_epoch = self.ckpt.epochs_done
            if self.ckpt.best_score is not None and np.isfinite(self.ckpt.best_score):
                best = float(self.ckpt.best_score)
        self.epochs_completed = start_epoch
        for epoch in range(start_epoch, self.max_epochs):
            epoch_start = time.time()
            n_batches = 0
            loss_parts: List[torch.Tensor] = []  # device scalars; read once per epoch
            t_log, step_at_log = time.time(), step
            if self.max_steps and step >= self.max_steps:
                break  # a resumed run already at the cap trains no more
            for batch in self.datamodule.train_batches(rng=self._np_rng):
                metrics = self.train_step(self.state, self._put(batch))
                loss_parts.append(metrics["loss"])
                n_batches += 1
                step += step_units
                if step % self.log_every_n_steps < step_units:
                    now = time.time()
                    self.log_fn(
                        {"train/loss": float(metrics["loss"]), "time/train/step": (now - t_log) / max(step - step_at_log, 1)},
                        step,
                    )
                    t_log, step_at_log = time.time(), step
                if self.max_steps and step >= self.max_steps:
                    done = True
                    break
            if n_batches == 0 and not done:
                n_rows = len(self.datamodule.split("train"))
                raise ValueError(
                    f"train epoch produced 0 batches: batch_size={self.datamodule.batch_size} > train split "
                    f"rows={n_rows} (drop_last). Lower datamodule.batch_size or disable "
                    "trainer.fold_accumulation_into_batch."
                )
            if not done:  # a max_steps stop leaves its epoch partial
                self.epochs_completed = epoch + 1
            loss_epoch = float(torch.stack(loss_parts).sum()) / n_batches if loss_parts else 0.0
            epoch_metrics = {"train/loss_epoch": loss_epoch, "time/train": time.time() - epoch_start, "epoch": epoch}

            if (epoch + 1) % self.val_every_n_epochs == 0 or done or epoch == self.max_epochs - 1:
                val_start = time.time()
                val_metrics = self.evaluate("val")
                epoch_metrics.update(val_metrics)
                epoch_metrics["time/validation"] = time.time() - val_start
                score = val_metrics.get(self.monitor, np.nan)
                improved = False
                if self.ckpt is not None:
                    tree = self._state_tree()
                    improved = self.ckpt.save_best_if_improved(tree, score, step)
                    self.ckpt.save_last(tree, step, epochs_done=self.epochs_completed)
                if np.isfinite(score):
                    prev_best = best
                    best = score if np.isnan(best) else (min if self.monitor_mode == "min" else max)(best, score)
                    improved = improved or np.isnan(prev_best) or best != prev_best
                if self.early_stopping_patience is not None:
                    self._epochs_without_improvement = 0 if improved else self._epochs_without_improvement + 1
                    if self._epochs_without_improvement >= self.early_stopping_patience:
                        done = True
            self.history.append(epoch_metrics)
            self.log_fn(epoch_metrics, step)
            if done:
                break
        return float(best) if np.isfinite(best) else float("nan")

    def _eval_batches(self, split: str):
        return {
            "val": self.datamodule.val_batches,
            "test": self.datamodule.test_batches,
            "predict": self.datamodule.predict_batches,
        }[split]()

    def evaluate(self, split: str = "val") -> Dict[str, float]:
        """Streaming ensemble evaluation over a split with the train state's
        eval weights (the EMA when on): {split/t{i}/mse|crps|ssr,
        split/avg/*, split/crps, split/mse, split/ssr}. Per-batch sums reduce
        on the device; the host reads them once, at the end."""
        eval_fn = self.eval_fns[split]
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed + {"val": 1, "test": 2, "predict": 3}[split])
        params = self.state.eval_params()
        sums: Dict[str, Dict[str, torch.Tensor]] = {}
        n_frames = 0
        sample_start = time.time()
        for batch in self._eval_batches(split):
            out = eval_fn(batch, generator, params)
            for k, v in out.items():
                if not k.endswith("_preds") or f"{k[:-6]}_targets" not in out:
                    continue
                prefix = k[: -len("_preds")]
                part = metric_sums(v, out[f"{prefix}_targets"])
                sums[prefix] = part if prefix not in sums else {m: sums[prefix][m] + part[m] for m in part}
                n_frames += v.shape[0] * v.shape[1]
        sums_host = {p: {m: float(t) for m, t in s.items()} for p, s in sums.items()}  # the one sync
        sampling_time = time.time() - sample_start

        metrics: Dict[str, float] = {}
        per_metric = defaultdict(list)
        curves: Dict[str, Dict[str, list]] = defaultdict(lambda: {"t": [], "value": []})
        for prefix in sorted(sums_host, key=lambda p: (len(p), p)):
            s = sums_host[prefix]
            n = max(s["n"], 1.0)
            mse = s["sq"] / n
            crps = s["crps"] / n
            ssr = float(np.sqrt(s["var"] / n) / np.sqrt(mse)) if mse > 0 else float("nan")
            for name, v in (("mse", mse), ("crps", crps), ("ssr", ssr)):
                metrics[f"{split}/{prefix}/{name}"] = v
                per_metric[name].append(v)
                if prefix.startswith("t") and prefix[1:].isdigit():
                    curves[name]["t"].append(int(prefix[1:]))
                    curves[name]["value"].append(v)
        for name, vals in per_metric.items():
            metrics[f"{split}/avg/{name}"] = float(np.mean(vals))
            metrics[f"{split}/{name}"] = metrics[f"{split}/avg/{name}"]
        self.last_eval_curves = dict(curves)
        if n_frames and sampling_time > 0:
            metrics[f"{split}/frames_per_sec_per_chip"] = n_frames / sampling_time
        return metrics

    def predict(self, split: str = "predict") -> Dict[str, np.ndarray]:
        """The split's raw ensemble predictions and targets on the host,
        concatenated over batches (``*_preds`` along the batch axis 1, the
        rest along axis 0), with the train state's eval weights."""
        eval_fn = self.eval_fns[split]
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed + {"val": 1, "test": 2, "predict": 3}[split])
        params = self.state.eval_params()
        acc: Dict[str, List[np.ndarray]] = defaultdict(list)
        for batch in self._eval_batches(split):
            for k, v in eval_fn(batch, generator, params).items():
                acc[k].append(v.cpu().numpy())
        return {k: np.concatenate(vs, axis=1 if k.endswith("_preds") else 0) for k, vs in acc.items()}

    def test(self, save_curves: bool = True) -> Dict[str, float]:
        """Evaluate the test split (its ensemble size is
        ``module.num_predictions_test``) and save the per-horizon curves
        under the run directory's ``curves/`` (``test_crps`` etc.)."""
        metrics = self.evaluate("test")
        if save_curves and self.ckpt is not None:
            for name, curve in self.last_eval_curves.items():
                if not curve["t"]:
                    continue
                order = np.argsort(curve["t"])
                save_arrays_as_line_plot(
                    self.ckpt.run_dir,
                    np.asarray(curve["t"])[order],
                    {name: np.asarray(curve["value"])[order]},
                    key_stem=f"test_{name}",
                )
        return metrics
