"""Factories and the training driver: config -> datamodule, backbone,
experiment, engine, train state, trainer; the run registry.

Counterpart of ``dyffusion_tpu/interface.py`` on one device:
``get_datamodule`` (synthetic and physical-systems data),
``load_interpolator_from_registry`` (weights and BatchNorm statistics),
``build_experiment`` for the ``interpolation`` experiment and for
``dyffusion`` (its interpolator loaded from the registry by
``diffusion.interpolator_run_id``, or passed in memory),
``accumulation_layout``, ``create_train_state``, ``build_trainer``,
``run_experiment`` (run directory, checkpoints, resume, metrics log),
``reload_trainer`` and ``reload_and_test``. Everything runs on the CUDA
device unless the caller passes ``device="cpu"``. Not ported yet: the
device mesh (``trainer.devices`` > 1, ``trainer.spatial_shards`` > 1).
"""
from __future__ import annotations

import contextlib
import copy
import os
import signal
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from dyffusion_tpu_torch.config import apply_override
from dyffusion_tpu_torch.data import DataModule, PhysicalSystemsDataModule, SyntheticDataModule
from dyffusion_tpu_torch.diffusion.dyffusion import DyffusionConfig, DyffusionEngine
from dyffusion_tpu_torch.experiments import (
    DyffusionForecastingExperiment,
    Experiment,
    ExperimentConfig,
    InterpolationExperiment,
)
from dyffusion_tpu_torch.experiments.base import resolve_device
from dyffusion_tpu_torch.models import build_backbone
from dyffusion_tpu_torch.training import Trainer, TrainState, build_optimizer, mixed_precision_loss
from dyffusion_tpu_torch.training.checkpoint import CheckpointManager, find_run_dir
from dyffusion_tpu_torch.utils.logging import MetricsLogger, get_logger
from dyffusion_tpu_torch.utils.loss import get_loss_fn
from dyffusion_tpu_torch.utils.naming import get_run_id


def get_datamodule(config: Dict[str, Any]) -> DataModule:
    """Instantiate the datamodule: ``synthetic``, or ``physical-systems``
    (Navier-Stokes / spring-mesh archives under ``datamodule.data_dir``)."""
    dm_cfg = dict(config["datamodule"])
    name = dm_cfg.pop("name")
    if name == "synthetic":
        return SyntheticDataModule(**dm_cfg)
    if name == "physical-systems":
        return PhysicalSystemsDataModule(**dm_cfg)
    raise ValueError(f"Unknown or not yet ported datamodule: {name}")


def _experiment_cfg(config: Dict[str, Any]) -> ExperimentConfig:
    mod = dict(config.get("module", {}))
    fields = set(ExperimentConfig.__dataclass_fields__)
    return ExperimentConfig(**{k: v for k, v in mod.items() if k in fields})


def load_interpolator_from_registry(
    registry_dir: str, run_id: str, use_ema: bool = False, device: torch.device | str = "cuda"
) -> Tuple[nn.Module, Dict[str, Any]]:
    """Rebuild a stage-1 interpolator from its run in the local registry:
    the backbone from the run's ``config.json``, the weights from its
    ``best`` slot (``last`` if it has none; the EMA weights with
    ``use_ema``), frozen on ``device``. Returns ``(model, stage-1 config)``."""
    device = resolve_device(device)
    ckpt = CheckpointManager(find_run_dir(registry_dir, run_id), monitor="val/crps")
    s1_config = ckpt.load_config()
    dm = get_datamodule(s1_config)
    exp = InterpolationExperiment(_experiment_cfg(s1_config), dm.dims, device=device)
    with torch.random.fork_rng(devices=[]):  # the weights are overwritten: keep the global RNG as it was
        model = build_backbone(s1_config["model"], exp.backbone_spec())
    restored = ckpt.restore("best" if ckpt.has("best") else "last")
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt.run_dir}")
    model.load_state_dict(restored["model"])
    if use_ema:
        if restored["ema"] is None:
            raise ValueError(f"diffusion.interpolator_use_ema=true, but run {run_id} was trained without an EMA")
        model.load_state_dict(restored["ema"], strict=False)
    return model.to(device).requires_grad_(False), s1_config


def build_experiment(
    config: Dict[str, Any],
    datamodule: DataModule,
    interpolator: Optional[nn.Module] = None,
    device: torch.device | str = "cuda",
) -> Tuple[Experiment, nn.Module, Callable, Dict[str, Callable], Optional[DyffusionEngine]]:
    """Build ``(experiment, model, loss_fn, eval_fns, engine)`` on ``device``.

    The backbone's weights are drawn from ``config['seed']`` (the global RNG
    is left as it was). For ``dyffusion`` the frozen stage-1 interpolator is
    ``interpolator`` (the ``model`` of an ``interpolation`` build; the
    engine freezes a copy of it and leaves the caller's module as it was),
    or, without one, the run ``diffusion.interpolator_run_id`` of the
    registry ``config['registry_dir']``."""
    device = resolve_device(device)
    kind = config["experiment"]
    exp_cfg = _experiment_cfg(config)
    dims = datamodule.dims
    diff_cfg = config.get("diffusion") or {}

    def init_model(exp: Experiment) -> nn.Module:
        spec = exp.backbone_spec()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(config.get("seed", 0)))
            model = build_backbone(config["model"], spec)
        return model.to(device)

    if kind == "interpolation":
        exp = InterpolationExperiment(exp_cfg, dims, device=device)
        exp.model = init_model(exp)
        eval_fns = {s: exp.make_eval_fn(s) for s in ("val", "test", "predict")}
        return exp, exp.model, exp.make_loss_fn(), eval_fns, None

    if kind == "dyffusion":
        if interpolator is None:
            run_id = diff_cfg.get("interpolator_run_id")
            if not run_id:
                raise ValueError("diffusion.interpolator_run_id (or an in-memory interpolator) is required")
            interpolator, s1_config = load_interpolator_from_registry(
                config.get("registry_dir", "runs"), run_id, use_ema=diff_cfg.get("interpolator_use_ema", False),
                device=device,
            )
            # the horizon the interpolator was trained with, so that the
            # engine's horizon check compares two different configs
            ip_horizon = int(s1_config["datamodule"]["horizon"])
        else:
            interpolator = copy.deepcopy(interpolator).to(device).requires_grad_(False)
            ip_horizon = exp_cfg.horizon
        # the datamodule's physics hook, where it overrides the identity
        has_boundary = type(datamodule).boundary_conditions is not DataModule.boundary_conditions
        exp = DyffusionForecastingExperiment(
            exp_cfg, dims, forward_conditioning=diff_cfg.get("forward_conditioning", "data"),
            boundary_fn=datamodule.boundary_conditions if has_boundary else None, device=device,
        )
        model = init_model(exp)
        fields = set(DyffusionConfig.__dataclass_fields__)
        eng_cfg = DyffusionConfig(
            num_input_channels=dims["input"],
            **{
                k: (tuple(v) if isinstance(v, list) else v)
                for k, v in diff_cfg.items()
                if k in fields and k != "num_input_channels"
            },
        )
        engine = DyffusionEngine(
            eng_cfg, model, interpolator, interpolator_horizon=ip_horizon,
            criterion=get_loss_fn(diff_cfg.get("loss_function", "mse")),
        )
        exp.model, exp.engine, exp.interpolator = model, engine, interpolator
        ar = bool(exp_cfg.prediction_horizon and exp_cfg.prediction_horizon > exp_cfg.horizon)
        eval_fns = {
            "val": exp.make_eval_fn(split="val"),
            "test": exp.make_eval_fn(split="test", autoregressive=ar),
            "predict": exp.make_eval_fn(split="predict", autoregressive=ar),
        }
        return exp, model, exp.make_loss_fn(), eval_fns, engine

    raise ValueError(f"Unknown or not yet ported experiment type: {kind}")


def accumulation_layout(config: Dict[str, Any]) -> Tuple[int, int]:
    """(optimizer accumulation, fold factor) of the config's execution
    layout. Unfolded: (trainer.accumulate_grad_batches, 1). With
    trainer.fold_accumulation_into_batch: (1, accumulate): the micro-batches
    run as one batch, the optimizer steps every time, and the state replays
    the micro-batch EMA/step cadence through the fold factor."""
    tr = config.get("trainer", {}) or {}
    acc = int(tr.get("accumulate_grad_batches", 1) or 1)
    fold = bool(tr.get("fold_accumulation_into_batch")) and acc > 1
    return (1, acc) if fold else (acc, 1)


def create_train_state(config: Dict[str, Any], model: nn.Module) -> TrainState:
    """The train state of ``model`` from the config: optimizer (module.
    optimizer, module.scheduler, trainer.gradient_clip_val, the accumulation
    layout), EMA (module.use_ema, module.ema_decay), and the step generator,
    seeded from seed + 1 on the model's device."""
    mod = config.get("module", {})
    opt = dict(mod.get("optimizer") or {"name": "adamw", "lr": 3e-4})
    accumulate, fold_factor = accumulation_layout(config)
    optimizer = build_optimizer(
        model.named_parameters(),
        name=opt.pop("name", "adamw"),
        gradient_clip_val=(config.get("trainer") or {}).get("gradient_clip_val"),
        scheduler=mod.get("scheduler"),
        accumulate_grad_batches=accumulate,
        **opt,
    )
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(int(config.get("seed", 0)) + 1)
    return TrainState(
        model, optimizer, generator,
        use_ema=mod.get("use_ema", False), ema_decay=mod.get("ema_decay", 0.9999), fold_factor=fold_factor,
    )


def build_trainer(
    config: Dict[str, Any],
    datamodule: Optional[DataModule] = None,
    interpolator: Optional[nn.Module] = None,
    device: torch.device | str = "cuda",
    log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
    run_dir: Optional[str] = None,
) -> Trainer:
    """The :class:`Trainer` of one stage, ready to ``fit``: datamodule set up
    (its batch size scaled by the fold factor when accumulation is folded),
    experiment, loss in the config's precision, train state.
    ``module.train_dtype=bfloat16`` (or a half ``trainer.precision``) trains
    in bf16 mixed precision. With ``run_dir`` the trainer keeps its
    checkpoints there (unless ``trainer.save_checkpoints`` is false)."""
    device = resolve_device(device)
    tr_cfg = config.get("trainer", {}) or {}
    datamodule = datamodule or get_datamodule(config)
    datamodule.setup()
    _, fold_factor = accumulation_layout(config)
    if fold_factor > 1:  # the micro-batches of one step run as one physical batch
        datamodule.batch_size = datamodule.batch_size * fold_factor
    exp, model, loss_fn, eval_fns, _ = build_experiment(config, datamodule, interpolator=interpolator, device=device)
    # trainer.precision is an alias of module.train_dtype: any half precision means bf16-mixed
    precision = str(tr_cfg.get("precision", 32))
    if exp.cfg.train_dtype in ("bfloat16", "bf16") or precision in ("16", "bf16", "bf16-mixed", "bfloat16", "16-mixed"):
        loss_fn = mixed_precision_loss(loss_fn, model)
    return Trainer(
        experiment=exp,
        datamodule=datamodule,
        state=create_train_state(config, model),
        loss_fn=loss_fn,
        eval_fns=eval_fns,
        max_epochs=tr_cfg.get("max_epochs", 10),
        max_steps=tr_cfg.get("max_steps"),
        seed=config.get("seed", 0),
        monitor=(config.get("module") or {}).get("monitor") or exp.monitor,
        val_every_n_epochs=tr_cfg.get("val_every_n_epochs", 1),
        log_fn=log_fn,
        early_stopping_patience=tr_cfg.get("early_stopping_patience"),
        log_every_n_steps=tr_cfg.get("log_every_n_steps", 50),
        run_dir=run_dir,
        save_checkpoints=tr_cfg.get("save_checkpoints", True),
    )


def _check_one_device(config: Dict[str, Any]) -> None:
    """The port trains on one device: no mesh, no spatial sharding yet."""
    tr = config.get("trainer") or {}
    devices = tr.get("devices", "auto")
    if (devices not in ("auto", -1, None) and int(devices) > 1) or int(tr.get("spatial_shards", 1) or 1) > 1:
        raise NotImplementedError(
            "trainer.devices > 1 and trainer.spatial_shards > 1 need data parallelism, not ported yet (ROADMAP A9)"
        )


def _apply_matmul_precision(config: Dict[str, Any]) -> None:
    """``matmul_precision`` (or ``torch_matmul_precision``) as torch's f32
    matmul precision, with cuDNN's TF32 on unless it is 'highest'. Unset:
    torch's settings stay as they are. Either way the settings in force are
    logged."""
    mm = config.get("matmul_precision") or config.get("torch_matmul_precision")
    if mm:
        torch.set_float32_matmul_precision(mm)
        torch.backends.cudnn.allow_tf32 = mm != "highest"
    get_logger().info(
        "f32 matmul precision %s, cudnn.allow_tf32 %s (%s)", torch.get_float32_matmul_precision(),
        torch.backends.cudnn.allow_tf32, "from the config" if mm else "torch's settings, matmul_precision unset",
    )


def run_experiment(
    config: Dict[str, Any],
    datamodule: Optional[DataModule] = None,
    interpolator: Optional[nn.Module] = None,
    resume: bool = True,
    device: torch.device | str = "cuda",
    log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
) -> Tuple[Trainer, float]:
    """Train one stage into its run directory and return ``(trainer, best
    monitored score)``. The run directory is ``<registry_dir>/<run id>``
    (the config's ``run_id``, else :func:`get_run_id`): it receives
    ``config.json``, ``hparams.json``, ``metrics.jsonl`` and the ``best`` and
    ``last`` checkpoints. ``resume`` continues from its ``last`` checkpoint
    if it has one; ``resume=False`` starts the directory over. SIGUSR1 saves
    ``last``, and so does a crash before it re-raises. ``log_fn`` also
    receives every logged record. Stage 2 (``dyffusion``) loads its
    interpolator from the registry, or takes the stage-1 model in memory as
    ``interpolator``."""
    device = resolve_device(device)
    _check_one_device(config)
    _apply_matmul_precision(config)
    run_id = config.get("run_id") or get_run_id(config)
    run_dir = os.path.join(config.get("registry_dir", "runs"), run_id)
    trainer = build_trainer(config, datamodule, interpolator, device, run_dir=run_dir)
    if trainer.ckpt is not None:
        trainer.ckpt.save_config(config)
    logger = MetricsLogger(run_dir, use_wandb=config.get("use_wandb", False))
    logger.log_hyperparams(config)

    def log(metrics: Dict[str, float], step: int) -> None:
        logger.log(metrics, step)
        if log_fn is not None:
            log_fn(metrics, step)

    trainer.log_fn = log

    def save_last() -> None:
        # max(): a save before fit() restores its counter must not lower the meta's
        epochs = max(trainer.epochs_completed, trainer.ckpt.epochs_done)
        trainer.ckpt.save_last(trainer._state_tree(), trainer.state.step, epochs_done=epochs)

    def save_on_signal(signum, frame) -> None:
        if trainer.ckpt is not None:
            save_last()

    try:
        previous_handler = signal.signal(signal.SIGUSR1, save_on_signal)
        restore_handler = True
    except ValueError:  # not the main thread: no signal handler
        restore_handler = False

    if trainer.ckpt is not None and (not resume or (not trainer.maybe_resume() and not trainer.ckpt.has("best"))):
        # start over, or a directory without weights to resume (a registry
        # copied without its slots): a stale best score must not suppress
        # the fresh run's best slot
        trainer.ckpt.reset_run_state()
    anomaly = torch.autograd.set_detect_anomaly(True) if config.get("jax_debug_nans") else contextlib.nullcontext()
    try:
        with anomaly:
            best = trainer.fit()
    except BaseException:
        if trainer.ckpt is not None and trainer.state.step > 0:
            save_last()
        raise
    finally:
        logger.finish()
        if restore_handler:
            signal.signal(signal.SIGUSR1, previous_handler or signal.SIG_DFL)
    return trainer, best


def reload_trainer(
    registry_dir: str,
    run_id: str,
    overrides: Optional[List[str]] = None,
    slot: str = "best",
    device: torch.device | str = "cuda",
) -> Trainer:
    """A finished run as a ready :class:`Trainer`: its stored config with
    ``overrides`` applied over it, and its ``slot`` checkpoint (``last`` if
    the run has no such slot) loaded."""
    device = resolve_device(device)
    run_dir = find_run_dir(registry_dir, run_id)
    config = CheckpointManager(run_dir, monitor="val/crps").load_config()
    for ov in overrides or []:
        apply_override(config, ov)
    config["registry_dir"] = registry_dir
    config["run_id"] = run_id
    _check_one_device(config)
    trainer = build_trainer(config, device=device, run_dir=run_dir)
    if not trainer.maybe_resume(slot=slot) and not trainer.maybe_resume(slot="last"):
        raise FileNotFoundError(f"no checkpoint in {run_dir}")
    return trainer


def reload_and_test(
    registry_dir: str,
    run_id: str,
    overrides: Optional[List[str]] = None,
    slot: str = "best",
    return_trainer: bool = False,
    device: torch.device | str = "cuda",
):
    """Test mode: reload a finished run (:func:`reload_trainer`) and evaluate
    its test split with the test-size ensemble (``module.num_predictions_test``),
    saving the per-horizon curves. Returns the metrics (and the trainer)."""
    trainer = reload_trainer(registry_dir, run_id, overrides, slot=slot, device=device)
    metrics = trainer.test()
    return (metrics, trainer) if return_trainer else metrics
