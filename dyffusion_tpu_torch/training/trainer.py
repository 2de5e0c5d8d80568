"""The trainer: train step, metric sums, the fit loop and streamed evaluation.

Counterpart of ``dyffusion_tpu/training/trainer.py``, on one device or on
every rank of a data-parallel process group:

- :func:`make_train_step`: loss, backward, the optimizer step and the EMA,
  with the ``grad_norm`` and ``zero_grad_frac`` metrics, and with
  ``watch_gradients`` each top-level module's gradient norm and log10|g|
  histogram. Metrics stay device tensors; the host reads them only at log
  points.
- :func:`mixed_precision_loss`: ``module.train_dtype=bfloat16`` as a cast at
  the loss boundary (not ``torch.autocast``, which would keep softmaxes and
  norms in f32 and so compute something else than the JAX package).
- :class:`Trainer`: ``fit`` (the train batches gathered and staged on the
  device ahead of the step by ``DataModule.train_loader``; epochs,
  ``max_steps``, log cadence, validation
  cadence, early stopping, the best monitored score, the ``best`` and
  ``last`` checkpoints at each validation, resume by epoch), ``evaluate``
  (the experiment's ensemble eval function over a split, CRPS/MSE/SSR
  reduced as streamed per-batch sums on the device), ``predict`` and
  ``test`` (which saves the per-horizon curves).

Data parallelism (``parallel/``): each rank trains on its rows of the
global batch; after each backward the gradients are averaged across ranks
before ``grad_norm``, ``zero_grad_frac``, ``watch_gradients`` and clipping
read them, the per-row draws of the loss are the global batch's
(``utils.rng.row_shard``), and the logged train metrics are means over
ranks. Eval batches are padded to a multiple of the world size by repeating
their last row (``data.base.pad_batch``); each rank evaluates its rows, the padded
ones masked out of ``metric_sums``, and the sums are all-reduced once per
split, so every rank reads the same metrics and early stopping stops them
at the same step. Each rank's train and eval generators are seeded from the
seed and the rank (``parallel.distributed.rank_seed``).

Spatial sharding (``trainer.spatial_shards=K``): the ranks form a D x K
grid (``distributed.set_model_axis``). ``fit`` gives each rank its data
index's rows of every train batch and its model index's slab of the grid
(``DataModule.train_loader(slab=...)``), and the train step runs the loss
inside ``parallel.spatial.sharded``, where the ``Unet`` exchanges halos
across its model group, forward and backward. The K ranks of a group draw
alike: their step generators share the data index's seed, the dropout and
noise over the grid take each rank's slab of one global draw, and the
per-row draws are the data index's (``utils.rng.row_shard`` over the data
axis only). So the weight gradient, summed over the world and divided by
it (``distributed.all_reduce_gradients``), is the gradient of the loss over
the whole grid and the whole global batch before ``grad_norm``,
``zero_grad_frac``, ``watch_gradients`` and clipping read it, and the
logged loss is that loss (the normalisation is set out in
``parallel.distributed``). ``evaluate``, ``test`` and ``predict`` give each
rank its box of every eval batch (``data.base.local_eval_batches``) and
run inside the same context; the metric sums run over the rank's slab (n
counts its pixels) and are all-reduced over every rank; ``predict``
gathers rows and slabs.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from dyffusion_tpu_torch.data.base import local_eval_batches
from dyffusion_tpu_torch.data.native_loader import DeviceStager
from dyffusion_tpu_torch.models.base import MODEL_STATE_UPDATES
from dyffusion_tpu_torch.parallel import distributed, spatial
from dyffusion_tpu_torch.parallel.mesh import process_local_rows, slab_axis
from dyffusion_tpu_torch.training.checkpoint import CheckpointManager
from dyffusion_tpu_torch.training.state import TrainState
from dyffusion_tpu_torch.utils import rng
from dyffusion_tpu_torch.utils.logging import is_rank_zero, save_arrays_as_line_plot
from dyffusion_tpu_torch.utils.profiling import span

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


# gradient-histogram bins over log10|g|: [-inf, -12), 28 bins up to 2, [2, inf)
GRAD_HIST_BINS = 30
GRAD_HIST_EDGES = [-float("inf")] + list(np.linspace(-12.0, 2.0, GRAD_HIST_BINS - 1)) + [float("inf")]


def gradient_watch_metrics(params: Dict[str, nn.Parameter]) -> Dict[str, torch.Tensor]:
    """Per top-level module of the model (the first part of each weight's
    name: ``init_conv``, ``downs``, ``mid_block1``, ... in the reference's
    naming; the JAX package groups by flax's names, ``down0_block1``, ...):
    ``grads/{module}/norm``, the f32 norm of its gradients, and
    ``grads/{module}/hist``, the counts of log10(|g| + 1e-30) in the bins of
    :data:`GRAD_HIST_EDGES` (a bin holds edge_i <= x < edge_i+1), computed
    on the gradients' device. A weight the loss does not reach counts as
    zeros."""
    groups: Dict[str, List[torch.Tensor]] = defaultdict(list)
    for name, p in params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        groups[name.split(".")[0]].append(g.detach().reshape(-1).float())
    out: Dict[str, torch.Tensor] = {}
    edges = None
    for module, gs in groups.items():
        flat = torch.cat(gs)
        if edges is None:
            edges = torch.tensor(GRAD_HIST_EDGES, dtype=torch.float32, device=flat.device)
        out[f"grads/{module}/norm"] = flat.square().sum().sqrt()
        # torch.histogram has no CUDA version: bucketize + bincount instead
        bins = torch.bucketize(torch.log10(flat.abs() + 1e-30), edges, right=True) - 1
        out[f"grads/{module}/hist"] = torch.bincount(bins, minlength=GRAD_HIST_BINS)
    return out


def make_train_step(loss_fn: LossFn, watch_gradients: bool = False,
                    sharded: Callable[[], Any] = contextlib.nullcontext) -> Callable[[TrainState, Dict[str, Any]], Dict]:
    """``train_step(state, batch) -> metrics``: gradients of ``loss_fn`` with
    respect to the model's trainable weights, then
    :meth:`TrainState.apply_gradients` with the BatchNorm updates the loss
    returned under ``MODEL_STATE_UPDATES``. ``state`` is updated in place.
    ``watch_gradients`` adds :func:`gradient_watch_metrics`. The loss runs
    inside ``sharded()`` (``Trainer.sharded``: the spatial shard's
    context; the backward needs none, every block keeps its level). On a
    data axis of more than one rank the loss's per-row draws come from
    ``state.row_generator`` for the global batch. In a process group the
    gradients are summed over the world and divided by it after the
    backward, and the loss metrics are means over the world."""

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        world, n_data = distributed.world_size(), distributed.data_size()
        rows = contextlib.nullcontext()
        if n_data > 1:  # the K ranks of a model group hold the same rows
            n = int(next(iter(batch.values())).shape[0])
            rows = rng.row_shard(state.row_generator, n * n_data, distributed.data_rank() * n)
        with span("trainer.forward"), rows, sharded():
            loss, metrics = loss_fn(None, batch, state.generator)
        metrics = dict(metrics)
        updates = metrics.pop(MODEL_STATE_UPDATES, None)
        with span("trainer.backward"):
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if world > 1:
                distributed.all_reduce_gradients(state.params.values())
                metrics = distributed.all_reduce_mean(metrics)
        with span("trainer.update"):
            with torch.no_grad():
                grads = [p.grad for p in state.params.values() if p.grad is not None]
                n_total = sum(p.numel() for p in state.params.values())
                metrics["grad_norm"] = torch.sqrt(sum(g.float().square().sum() for g in grads))
                # zero-gradient fraction; a weight the loss does not reach counts as zeros
                n_unreached = n_total - sum(g.numel() for g in grads)
                metrics["zero_grad_frac"] = (sum((g == 0).sum() for g in grads) + n_unreached) / n_total
                if watch_gradients:
                    metrics.update(gradient_watch_metrics(state.params))
            state.apply_gradients(updates)
        return metrics

    return train_step


def metric_sums(
    preds: torch.Tensor, targets: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """Per-batch sums {n, sq, var, crps} of the streaming ensemble metrics,
    preds (m, B, ...) and targets (B, ...): mse = sq/n, crps = crps/n,
    ssr = sqrt(var/n)/sqrt(sq/n). CRPS uses the sorted O(m log m)
    estimator. ``valid`` (B,) bool marks the rows that count: padded rows
    are masked out of every sum and of n (the JAX package's masked sums)."""
    preds, targets = preds.float(), targets.float()
    m = preds.shape[0]
    if valid is None:
        valid = torch.ones(targets.shape[0], dtype=torch.bool)
    mask = valid.to(device=preds.device, dtype=torch.float32).reshape((-1,) + (1,) * (targets.ndim - 1))
    n = mask.sum() * float(np.prod(targets.shape[1:]))
    sq = (((preds.mean(dim=0) - targets) ** 2) * mask).sum()
    var = (preds.var(dim=0, unbiased=False) * mask).sum()
    x = torch.sort(preds, dim=0).values
    skill = (x - targets[None]).abs().mean(dim=0)
    i = torch.arange(1, m + 1, device=preds.device, dtype=torch.float32).reshape((m,) + (1,) * targets.ndim)
    spread = (x * (2 * i - m - 1)).sum(dim=0) / (m * m)
    return {"n": n, "sq": sq, "var": var, "crps": ((skill - spread) * mask).sum()}


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
        watch_gradients: bool = False,
        spatial_axis: str = "h",
    ):
        self.experiment = experiment
        self.datamodule = datamodule
        self.device = experiment.device
        self.state = state
        self.train_step = make_train_step(loss_fn, watch_gradients=watch_gradients, sharded=self.sharded)
        # a host batch as tensors on the device, ordered before later work on its stream
        self._put = DeviceStager(self.device)
        self.eval_fns = eval_fns
        self.spatial_axis = spatial_axis
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

    def _state_tree(self, collective: bool = True) -> Dict[str, Any]:
        """The checkpoint of the train state (``TrainState.state_dict``).
        With more than one rank it also holds every rank's step generator
        (``rank_generators``, gathered from all ranks: a collective, unless
        ``collective=False``, as a save on a signal or a crash of one rank
        must be) and the shared row generator."""
        tree = self.state.state_dict()
        if distributed.world_size() > 1:
            tree["row_generator"] = self.state.row_generator.get_state()
            if collective:
                tree["rank_generators"] = distributed.gather_bytes(self.state.generator.get_state())
        return tree

    def _load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Load a checkpoint; each rank takes its own step generator where
        the checkpoint has one per rank of this world, and where it was saved
        on a device of this type."""
        world = distributed.world_size()
        per_rank = tree.get("rank_generators")
        if world > 1 and per_rank is not None and len(per_rank) == world:
            tree = {**tree, "generator": per_rank[distributed.rank()]}
        elif world > 1:  # saved by another world: keep this rank's freshly seeded stream
            tree = {**tree, "generator": self.state.generator.get_state()}
        fresh = self.state.generator.get_state()
        if tree["generator"].numel() != fresh.numel():
            # saved on another device type (a CUDA run reloaded on the CPU to
            # serve it): a CPU generator cannot continue a CUDA stream, so
            # this one keeps its freshly seeded stream, as for another world
            tree = {**tree, "generator": fresh}
        self.state.load_state_dict(tree)
        if world > 1 and tree.get("row_generator") is not None:
            self.state.row_generator.set_state(tree["row_generator"])

    def maybe_resume(self, slot: str = "last") -> bool:
        """Load the ``slot`` checkpoint of the run directory, if it has one."""
        if self.ckpt is None or not self.ckpt.has(slot):
            return False
        self._load_state_tree(self.ckpt.restore(slot))
        return True

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
        # this rank's box of every global batch: its data index's rows, its slab of the grid
        n_data, n_model = distributed.data_size(), distributed.model_size()
        rows = process_local_rows(self.datamodule.batch_size, distributed.data_rank(), n_data) if n_data > 1 else None
        slab = (self.spatial_axis, distributed.model_rank(), n_model) if n_model > 1 else None
        for epoch in range(start_epoch, self.max_epochs):
            epoch_start = time.time()
            n_batches = 0
            loss_parts: List[torch.Tensor] = []  # device scalars; read once per epoch
            t_log, step_at_log = time.time(), step
            if self.max_steps and step >= self.max_steps:
                break  # a resumed run already at the cap trains no more
            # the loader gathers and stages the next batches while this step runs; the
            # loop holds its only reference, so a break or a raising step stops its worker
            for batch in self.datamodule.train_loader(rng=self._np_rng, device_put=self._put, rows=rows, slab=slab):
                metrics = self.train_step(self.state, batch)
                loss_parts.append(metrics["loss"])
                n_batches += 1
                step += step_units
                if step % self.log_every_n_steps < step_units:
                    now = time.time()
                    log_metrics = {
                        "train/loss": float(metrics["loss"]),
                        "time/train/step": (now - t_log) / max(step - step_at_log, 1),
                    }
                    for k, v in metrics.items():  # watch_gradients: counts as int lists
                        if k.startswith("grads/"):
                            log_metrics[k] = v.cpu().tolist() if v.ndim else float(v)
                    self.log_fn(log_metrics, step)
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
                    distributed.barrier()  # the others read these slots after the run
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

    def _eval_generator(self, split: str) -> torch.Generator:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(distributed.rank_seed(self.seed + {"val": 1, "test": 2, "predict": 3}[split]))
        return generator

    def local_eval_batches(self, split: str):
        """This rank's box of each eval batch (``data.base.local_eval_batches``):
        the rows of its data index, padded, and under spatial sharding its
        slab of the grid."""
        return local_eval_batches(self._eval_batches(split), distributed.data_rank(), distributed.data_size(),
                                  self.spatial_axis, distributed.model_rank(), distributed.model_size())

    def sharded(self):
        """The context of this rank's train step and eval under spatial
        sharding (``parallel.spatial.sharded``); a no-op on a model axis of
        1."""
        if distributed.model_size() == 1:
            return contextlib.nullcontext()
        return spatial.sharded(self.spatial_axis, self.experiment.dims["spatial"])

    def evaluate(self, split: str = "val") -> Dict[str, float]:
        """Streaming ensemble evaluation over a split with the train state's
        eval weights (the EMA when on): {split/t{i}/mse|crps|ssr,
        split/avg/*, split/crps, split/mse, split/ssr}. Per-batch sums reduce
        on the device (each rank's rows, padding masked out) and over ranks
        in one collective; the host reads them once, at the end.
        ``frames_per_sec_per_chip`` counts the real frames of all ranks per
        second and rank."""
        eval_fn = self.eval_fns[split]
        generator = self._eval_generator(split)
        params = self.state.eval_params()
        sums: Dict[str, Dict[str, torch.Tensor]] = {}
        n_frames = 0
        # the K ranks of a model group share their frames: one of them counts them
        counts_frames = distributed.model_rank() == 0
        sample_start = time.time()
        for batch, valid, _, _, _ in self.local_eval_batches(split):
            with self.sharded():
                out = eval_fn(batch, generator, params)
            for k, v in out.items():
                if not k.endswith("_preds") or f"{k[:-6]}_targets" not in out:
                    continue
                prefix = k[: -len("_preds")]
                part = metric_sums(v, out[f"{prefix}_targets"], valid)
                sums[prefix] = part if prefix not in sums else {m: sums[prefix][m] + part[m] for m in part}
                n_frames += v.shape[0] * int(valid.sum()) * counts_frames
        world = distributed.world_size()
        if world > 1:  # one all_reduce of every sum and the frame count
            keys = [(p, m) for p in sorted(sums) for m in sorted(sums[p])]
            flat = torch.stack([sums[p][m].float() for p, m in keys] + [torch.tensor(float(n_frames), device=self.device)])
            flat = distributed.all_reduce_sum(flat.to(distributed.collective_device()))
            for j, (p, m) in enumerate(keys):
                sums[p][m] = flat[j]
            n_frames = float(flat[-1])
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
            metrics[f"{split}/frames_per_sec_per_chip"] = n_frames / sampling_time / world
        return metrics

    def predict(self, split: str = "predict") -> Dict[str, np.ndarray]:
        """The split's raw ensemble predictions and targets on the host,
        concatenated over batches (``*_preds`` along the batch axis 1, the
        rest along axis 0), with the train state's eval weights. Under data
        parallelism every rank gets every row (gathered through a zero-filled
        buffer summed over ranks), the padding dropped; under spatial
        sharding every slab too."""
        eval_fn = self.eval_fns[split]
        generator = self._eval_generator(split)
        params = self.state.eval_params()
        k_model, m_rank = distributed.model_size(), distributed.model_rank()
        acc: Dict[str, List[np.ndarray]] = defaultdict(list)
        for batch, valid, first, total, n_valid in self.local_eval_batches(split):
            with self.sharded():
                out = eval_fn(batch, generator, params)
            for k, v in out.items():
                dim = 1 if k.endswith("_preds") else 0
                if distributed.world_size() > 1:
                    starts, shape = [0] * v.ndim, list(v.shape)
                    starts[dim], shape[dim] = first, total
                    pos = slab_axis(v.ndim - dim, self.spatial_axis) if k_model > 1 else None
                    if pos is not None:  # the grid axis of a (rows, H, W, C) value, after the member axis
                        starts[dim + pos] = m_rank * v.shape[dim + pos]
                        shape[dim + pos] = k_model * v.shape[dim + pos]
                    v = distributed.gather_box(v.to(distributed.collective_device()), starts, shape)
                acc[k].append(v.narrow(dim, 0, n_valid).cpu().numpy())
        return {k: np.concatenate(vs, axis=1 if k.endswith("_preds") else 0) for k, vs in acc.items()}

    def test(self, save_curves: bool = True) -> Dict[str, float]:
        """Evaluate the test split (its ensemble size is
        ``module.num_predictions_test``) and save the per-horizon curves
        under the run directory's ``curves/`` (``test_crps`` etc.)."""
        metrics = self.evaluate("test")
        if save_curves and self.ckpt is not None and is_rank_zero():
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
