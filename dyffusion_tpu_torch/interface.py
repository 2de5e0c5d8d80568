"""Factories and the training driver: config -> datamodule, backbone,
experiment, engine, train state, trainer; the run registry.

Counterpart of ``dyffusion_tpu/interface.py`` on one device:
``get_datamodule`` (synthetic, physical-systems and OISSTv2 data),
``load_interpolator_from_registry`` (weights and BatchNorm statistics),
``build_experiment`` for the ``interpolation`` experiment, for
``dyffusion`` (its interpolator loaded from the registry by
``diffusion.interpolator_run_id``, or passed in memory) and for the
baselines (``time_conditioned``; ``simultaneous``, alone or hosting the
``ddpm``, ``ddpm_v2`` or ``mcvd`` engine),
``accumulation_layout``, ``create_train_state``, ``build_trainer``,
``run_experiment`` (run directory, checkpoints, resume, metrics log),
``reload_trainer`` and ``reload_and_test``. Everything runs on the CUDA
device unless the caller passes ``device="cpu"``.

Data parallelism: ``run_experiment``, ``build_trainer`` and
``reload_trainer`` join the launcher's process group
(``parallel.init_distributed``) and take its world from
``trainer.devices`` (``auto``: the group's world; an int must equal it).
The global train batch is ``datamodule.batch_size`` x world, each rank
trains and evaluates on its rows, and ``mode=test`` reloads on the same
world. ``python -m dyffusion_tpu_torch.train trainer.devices=N`` starts the
N ranks itself. ``trainer.spatial_shards=K`` makes the world a D x K grid
whose model groups split the grid's H (or W, ``trainer.spatial_axis=w``):
training, evaluation and ``mode=test`` run on it (``parallel.spatial``).
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
from dyffusion_tpu_torch.data import DataModule, OISSTv2DataModule, PhysicalSystemsDataModule, SyntheticDataModule
from dyffusion_tpu_torch.diffusion import (
    DyffusionConfig,
    DyffusionEngine,
    GaussianDiffusionConfig,
    GaussianDiffusionEngine,
    LatentDDPMConfig,
    LatentDDPMEngine,
    McvdConfig,
    McvdEngine,
)
from dyffusion_tpu_torch.experiments import (
    DyffusionForecastingExperiment,
    Experiment,
    ExperimentConfig,
    InterpolationExperiment,
    SimultaneousForecastingExperiment,
    TimeConditionedForecastingExperiment,
)
from dyffusion_tpu_torch.experiments.base import resolve_device
from dyffusion_tpu_torch.models import build_backbone
from dyffusion_tpu_torch.parallel import distributed
from dyffusion_tpu_torch.parallel.mesh import replicate_state
from dyffusion_tpu_torch.training import Trainer, TrainState, build_optimizer, mixed_precision_loss
from dyffusion_tpu_torch.training.checkpoint import CheckpointManager, find_run_dir
from dyffusion_tpu_torch.utils.logging import MetricsLogger, get_logger
from dyffusion_tpu_torch.utils.loss import get_loss_fn
from dyffusion_tpu_torch.utils.naming import get_run_id


def get_datamodule(config: Dict[str, Any]) -> DataModule:
    """Instantiate the datamodule: ``synthetic``, ``physical-systems``
    (Navier-Stokes / spring-mesh archives under ``datamodule.data_dir``) or
    ``oisstv2`` (SST boxes under ``datamodule.data_dir``)."""
    dm_cfg = dict(config["datamodule"])
    name = dm_cfg.pop("name")
    if name == "synthetic":
        return SyntheticDataModule(**dm_cfg)
    if name == "physical-systems":
        return PhysicalSystemsDataModule(**dm_cfg)
    if name == "oisstv2":
        return OISSTv2DataModule(**dm_cfg)
    raise ValueError(f"Unknown datamodule: {name}")


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


def _config_fields(cls, section: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of a config section that the dataclass ``cls`` takes."""
    fields = set(cls.__dataclass_fields__)
    return {k: v for k, v in section.items() if k in fields}


def build_diffusion_engine(diff_cfg: Dict[str, Any], model: nn.Module, sample_shape, device: torch.device):
    """The baseline engine ``diffusion.name`` (``ddpm``, ``ddpm_v2`` or
    ``mcvd``) over ``model``, for samples of ``sample_shape`` (C, H, W).
    Its loss is ``diffusion.loss_function`` (l1 in the presets). With
    ``ddpm_v2``'s ``learn_logvar`` the (T,) logvar becomes the model's
    parameter ``_diffusion_logvar``: trained, decayed, EMA'd and
    checkpointed as one of its weights; the forward never reads it."""
    name = diff_cfg.get("name")
    criterion = get_loss_fn(diff_cfg.get("loss_function", "mse"))
    if name == "ddpm":
        cfg = GaussianDiffusionConfig(**_config_fields(GaussianDiffusionConfig, diff_cfg))
        return GaussianDiffusionEngine(cfg, model, sample_shape, criterion=criterion, device=device)
    if name == "ddpm_v2":
        cfg = LatentDDPMConfig(**_config_fields(LatentDDPMConfig, diff_cfg))
        engine = LatentDDPMEngine(cfg, model, sample_shape, device=device)
        if cfg.learn_logvar:
            model.register_parameter("_diffusion_logvar", nn.Parameter(engine.init_logvar().to(device)))
        return engine
    if name == "mcvd":
        cfg = McvdConfig(**_config_fields(McvdConfig, diff_cfg))
        return McvdEngine(cfg, model, sample_shape, criterion=criterion, device=device)
    raise ValueError(f"Unknown diffusion engine for the simultaneous experiment: {name}")


def build_experiment(
    config: Dict[str, Any],
    datamodule: DataModule,
    interpolator: Optional[nn.Module] = None,
    device: torch.device | str = "cuda",
) -> Tuple[Experiment, nn.Module, Callable, Dict[str, Callable], Optional[Any]]:
    """Build ``(experiment, model, loss_fn, eval_fns, engine)`` on ``device``.

    The backbone's weights are drawn from ``config['seed']`` (the global RNG
    is left as it was). For ``dyffusion`` the frozen stage-1 interpolator is
    ``interpolator`` (the ``model`` of an ``interpolation`` build; the
    engine freezes a copy of it and leaves the caller's module as it was),
    or, without one, the run ``diffusion.interpolator_run_id`` of the
    registry ``config['registry_dir']``. ``time_conditioned`` and
    ``simultaneous`` build no engine unless ``diffusion.name`` names one
    (``ddpm``, ``ddpm_v2``, ``mcvd``: the simultaneous experiment hosts it)."""
    device = resolve_device(device)
    kind = config["experiment"]
    exp_cfg = _experiment_cfg(config)
    dims = datamodule.dims
    diff_cfg = config.get("diffusion") or {}
    # the datamodule's physics hook, where it overrides the identity
    has_boundary = type(datamodule).boundary_conditions is not DataModule.boundary_conditions
    boundary_fn = datamodule.boundary_conditions if has_boundary else None
    ar = bool(exp_cfg.prediction_horizon and exp_cfg.prediction_horizon > exp_cfg.horizon)

    def forecast_eval_fns(exp) -> Dict[str, Callable]:
        """val, and test/predict chaining autoregressive windows when the
        prediction horizon exceeds the horizon."""
        return {
            "val": exp.make_eval_fn(split="val"),
            "test": exp.make_eval_fn(split="test", autoregressive=ar),
            "predict": exp.make_eval_fn(split="predict", autoregressive=ar),
        }

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
        exp = DyffusionForecastingExperiment(
            exp_cfg, dims, forward_conditioning=diff_cfg.get("forward_conditioning", "data"),
            boundary_fn=boundary_fn, device=device,
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
        return exp, model, exp.make_loss_fn(), forecast_eval_fns(exp), engine

    if kind == "time_conditioned":
        exp = TimeConditionedForecastingExperiment(exp_cfg, dims, boundary_fn=boundary_fn, device=device)
        exp.model = init_model(exp)
        return exp, exp.model, exp.make_loss_fn(), forecast_eval_fns(exp), None

    if kind == "simultaneous":
        is_diffusion = diff_cfg.get("name") in ("ddpm", "ddpm_v2", "mcvd")
        exp = SimultaneousForecastingExperiment(
            exp_cfg, dims, boundary_fn=boundary_fn, is_diffusion=is_diffusion, device=device
        )
        model = init_model(exp)
        exp.model = model
        engine = None
        if is_diffusion:
            H, W = dims["spatial"]
            engine = build_diffusion_engine(diff_cfg, model, (dims["output"] * exp_cfg.horizon, H, W), device)
            exp.diffusion_engine = engine
        return exp, model, exp.make_loss_fn(), forecast_eval_fns(exp), engine

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
    seeded from seed + 1 on the model's device (with more than one rank:
    from seed + 1 and the rank, beside a row generator seeded from seed + 1
    on every rank; see ``parallel.distributed.rank_seed``)."""
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
    seed = int(config.get("seed", 0)) + 1
    generator = torch.Generator(device=device)
    generator.manual_seed(distributed.rank_seed(seed))
    row_generator = None
    if distributed.world_size() > 1:
        row_generator = torch.Generator(device=device)
        row_generator.manual_seed(seed)
    return TrainState(
        model, optimizer, generator,
        use_ema=mod.get("use_ema", False), ema_decay=mod.get("ema_decay", 0.9999), fold_factor=fold_factor,
        row_generator=row_generator,
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
    (its batch size scaled by the data axis and by the fold factor when
    accumulation is folded: the GLOBAL batch, of which each rank takes its
    rows), experiment, loss in the config's precision, train state (the
    same on every rank). ``module.train_dtype=bfloat16`` (or a half
    ``trainer.precision``) trains in bf16 mixed precision. With ``run_dir``
    the trainer keeps its checkpoints there (unless
    ``trainer.save_checkpoints`` is false). Under ``trainer.spatial_shards=K``
    the world is a D x K grid and the trainer trains and evaluates on slabs
    of the grid's ``trainer.spatial_axis``."""
    device = _join_world(config, device)
    tr_cfg = config.get("trainer", {}) or {}
    datamodule = datamodule or get_datamodule(config)
    datamodule.setup()
    axis = str(tr_cfg.get("spatial_axis", "h") or "h")
    _check_spatial_divisibility(datamodule, distributed.model_size(), axis)
    _, fold_factor = accumulation_layout(config)
    # the micro-batches of one step run as one physical batch; the global batch spans the data axis
    datamodule.batch_size = datamodule.batch_size * fold_factor * distributed.data_size()
    exp, model, loss_fn, eval_fns, _ = build_experiment(config, datamodule, interpolator=interpolator, device=device)
    # trainer.precision is an alias of module.train_dtype: any half precision means bf16-mixed
    precision = str(tr_cfg.get("precision", 32))
    if exp.cfg.train_dtype in ("bfloat16", "bf16") or precision in ("16", "bf16", "bf16-mixed", "bfloat16", "16-mixed"):
        loss_fn = mixed_precision_loss(loss_fn, model)
    state = create_train_state(config, model)
    replicate_state(state)
    return Trainer(
        experiment=exp,
        datamodule=datamodule,
        state=state,
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
        watch_gradients=tr_cfg.get("watch_gradients", False),
        spatial_axis=axis,
    )


def _check_spatial_divisibility(datamodule: DataModule, n_model: int, axis: str = "h") -> None:
    """The JAX package's check (``interface._check_spatial_divisibility``):
    K must divide the grid's sharded extent (the port's lower levels may
    split unevenly, but the batches split into equal slabs)."""
    if n_model <= 1:
        return
    if axis not in ("h", "w"):
        raise ValueError(f"trainer.spatial_axis must be 'h' or 'w', got {axis!r}")
    extent = int(datamodule.dims["spatial"][0 if axis == "h" else 1])
    name = "height H" if axis == "h" else "width W"
    if extent % n_model:
        raise ValueError(
            f"trainer.spatial_shards={n_model} must divide the grid {name}={extent} "
            f"(got {extent} % {n_model} = {extent % n_model}); pick a divisor of "
            f"{extent} or shard the other axis (trainer.spatial_axis)"
        )


def _join_world(config: Dict[str, Any], device: torch.device | str) -> torch.device:
    """Join the launcher's process group, check ``trainer.devices``
    against its world, and return this rank's device for ``device``.
    ``trainer.devices`` is ``auto`` (the group's world, 1 outside one), or
    an int that must equal the world: the CLI starts N ranks for
    ``trainer.devices=N``, ``torchrun`` starts its own.
    ``trainer.spatial_shards=K`` must divide the world, which becomes a
    D x K grid (``distributed.set_model_axis``)."""
    tr = config.get("trainer") or {}
    distributed.init_distributed(device)
    devices, world = tr.get("devices", "auto"), distributed.world_size()
    if devices not in ("auto", -1, None) and int(devices) != world:
        raise ValueError(
            f"trainer.devices={devices} but this process runs in a world of {world}: start the ranks with "
            f"`python -m dyffusion_tpu_torch.train ... trainer.devices={devices}` (it spawns them) or with "
            f"`torchrun --nproc-per-node {devices}`, or set trainer.devices=auto"
        )
    distributed.set_model_axis(int(tr.get("spatial_shards", 1) or 1))
    return resolve_device(distributed.rank_device(device))


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
    ``interpolator``. Under ``trainer.spatial_shards=K`` each model group of
    K ranks trains on slabs of the grid."""
    device = _join_world(config, device)
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
        # max(): a save before fit() restores its counter must not lower the meta's.
        # No collective: a signal or a crash may reach one rank alone (rank 0 writes)
        epochs = max(trainer.epochs_completed, trainer.ckpt.epochs_done)
        trainer.ckpt.save_last(trainer._state_tree(collective=False), trainer.state.step, epochs_done=epochs)

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
    distributed.barrier()  # rank 0's config and start-over, before any rank trains
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
    the run has no such slot) loaded, on the world ``trainer.devices``
    names (a run trained on N ranks reloads on N: ``trainer.devices=1``
    among the ``overrides`` reloads it on one), with the run's
    ``matmul_precision``."""
    run_dir = find_run_dir(registry_dir, run_id)
    config = CheckpointManager(run_dir, monitor="val/crps").load_config()
    for ov in overrides or []:
        apply_override(config, ov)
    config["registry_dir"] = registry_dir
    config["run_id"] = run_id
    _apply_matmul_precision(config)
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
