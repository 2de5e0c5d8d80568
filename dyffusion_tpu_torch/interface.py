"""Factories: config -> datamodule, backbone, experiment, engine, train state,
and in-memory training.

Counterpart of ``dyffusion_tpu/interface.py``: ``get_datamodule`` (synthetic
data), ``build_experiment`` for the ``interpolation`` experiment and for
``dyffusion`` with an in-memory interpolator (the reference's option of
passing the stage-1 model directly), ``accumulation_layout``,
``create_train_state``, ``build_trainer`` and ``run_experiment``. Everything runs on the CUDA
device unless the caller passes ``device="cpu"``. Not ported yet: loading an
interpolator from the run registry, run directories and checkpoints,
resume, the device mesh.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from dyffusion_tpu_torch.data import DataModule, SyntheticDataModule
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
from dyffusion_tpu_torch.utils.loss import get_loss_fn


def get_datamodule(config: Dict[str, Any]) -> DataModule:
    """Instantiate the datamodule (synthetic only in the port so far)."""
    dm_cfg = dict(config["datamodule"])
    name = dm_cfg.pop("name")
    if name == "synthetic":
        return SyntheticDataModule(**dm_cfg)
    raise ValueError(f"Unknown or not yet ported datamodule: {name}")


def _experiment_cfg(config: Dict[str, Any]) -> ExperimentConfig:
    mod = dict(config.get("module", {}))
    fields = set(ExperimentConfig.__dataclass_fields__)
    return ExperimentConfig(**{k: v for k, v in mod.items() if k in fields})


def build_experiment(
    config: Dict[str, Any],
    datamodule: DataModule,
    interpolator: Optional[nn.Module] = None,
    device: torch.device | str = "cuda",
) -> Tuple[Experiment, nn.Module, Callable, Dict[str, Callable], Optional[DyffusionEngine]]:
    """Build ``(experiment, model, loss_fn, eval_fns, engine)`` on ``device``.

    The backbone's weights are drawn from ``config['seed']`` (the global RNG
    is left as it was). For ``dyffusion``, ``interpolator`` is the frozen
    stage-1 backbone (e.g. the ``model`` of an ``interpolation`` build)."""
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
            raise NotImplementedError(
                "loading the interpolator from the run registry is not ported yet: pass interpolator="
            )
        interpolator = interpolator.to(device).requires_grad_(False)
        exp = DyffusionForecastingExperiment(
            exp_cfg, dims, forward_conditioning=diff_cfg.get("forward_conditioning", "data"), device=device,
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
            eng_cfg, model, interpolator, interpolator_horizon=exp_cfg.horizon,
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
) -> Trainer:
    """The :class:`Trainer` of one stage, ready to ``fit``: datamodule set up
    (its batch size scaled by the fold factor when accumulation is folded),
    experiment, loss in the config's precision, train state.
    ``module.train_dtype=bfloat16`` (or a half ``trainer.precision``) trains
    in bf16 mixed precision."""
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
    )


def run_experiment(
    config: Dict[str, Any],
    datamodule: Optional[DataModule] = None,
    interpolator: Optional[nn.Module] = None,
    device: torch.device | str = "cuda",
    log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
) -> Tuple[Trainer, float]:
    """Train one stage in memory and return ``(trainer, best monitored
    score)``: no registry, no run directory, no checkpoints. Stage 2
    (``dyffusion``) takes the trained stage-1 model as ``interpolator``
    (``run_experiment(stage1_config)[0].experiment.model``)."""
    trainer = build_trainer(config, datamodule, interpolator, device, log_fn)
    return trainer, trainer.fit()
