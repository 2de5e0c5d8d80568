"""Deterministic run and group names (counterpart of
``dyffusion_tpu/utils/naming.py``).

A run id is the group name, the seed and a short hash of the config's
scientific identity, so a relaunch of the same science resumes the same run
directory, and a run id computed here equals the JAX package's for the same
config: a stage-1 run trained by either package can be found by the other's
``diffusion.interpolator_run_id``.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict


def clean_name(s: str) -> str:
    return str(s).replace(" ", "").replace("/", "-").replace(":", "-")


def get_group_name(config: Dict[str, Any]) -> str:
    """Hparams-derived group name, at most 100 characters."""
    dm = config.get("datamodule", {})
    md = config.get("model", {})
    parts = [
        clean_name(dm.get("name", "data")),
        clean_name(config.get("experiment", "exp")),
        clean_name(md.get("name", "model")),
        f"h{dm.get('horizon', '?')}",
        f"w{dm.get('window', 1)}",
    ]
    diff = config.get("diffusion")
    if diff:
        parts.append(clean_name(diff.get("name", "diffusion")))
        if diff.get("additional_interpolation_steps"):
            parts.append(f"k{diff['additional_interpolation_steps']}")
        if diff.get("forward_conditioning") and diff["forward_conditioning"] != "data":
            parts.append(clean_name(diff["forward_conditioning"]))
    return "_".join(parts)[:100]


# Keys that do not define the run's scientific identity: schedule length,
# logging and eval cadence, execution layout and machine-local paths. They
# stay out of the hash, so raising max_epochs extends a run instead of
# forking one, and moving a registry does not orphan its runs. The same
# lists as the JAX package's: the ids must agree.
_VOLATILE_TOP = ("registry_dir", "preset", "use_wandb", "run_id", "mode", "debug", "perf")
_VOLATILE_TRAINER = (
    "max_epochs",
    "max_steps",
    "val_every_n_epochs",
    "devices",
    "save_checkpoints",
    "log_every_n_steps",
    "watch_gradients",
    "early_stopping_patience",
    "num_sanity_val_steps",
    # layout, not science: they enter only through effective_train_batch
    "accumulate_grad_batches",
    "fold_accumulation_into_batch",
    "spatial_shards",
    "spatial_axis",
)
_VOLATILE_DATAMODULE = ("eval_batch_size", "num_workers", "data_dir", "batch_size")
_VOLATILE_MODEL = ("remat",)


def _data_axis_size(config: Dict[str, Any]) -> int:
    """The data-parallel axis that scales the global batch: ``trainer.devices``
    over ``trainer.spatial_shards``. ``devices`` auto is the world size of
    the process group (1 outside one), whatever cards the host holds: a
    host with several cards does not fork the run id, and a launcher's
    world is hashed as an explicit ``trainer.devices`` would be."""
    from dyffusion_tpu_torch.parallel import distributed

    tr = config.get("trainer") or {}
    devices = tr.get("devices", "auto")
    n = distributed.world_size() if devices in ("auto", -1, None) else max(int(devices), 1)
    return max(n // max(int(tr.get("spatial_shards", 1) or 1), 1), 1)


def identity_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """The subset of the config that defines run identity, plus the global
    train batch (per-device batch x data axis x accumulation) and, with the
    EMA on, its updates per effective batch (the EMA updates once per
    micro-batch, so the accumulation layout changes its trajectory)."""
    cfg = {k: v for k, v in config.items() if k not in _VOLATILE_TOP}
    for section, volatile in (
        ("trainer", _VOLATILE_TRAINER),
        ("datamodule", _VOLATILE_DATAMODULE),
        ("model", _VOLATILE_MODEL),
    ):
        if isinstance(cfg.get(section), dict):
            cfg[section] = {k: v for k, v in cfg[section].items() if k not in volatile}
    per_device = (config.get("datamodule") or {}).get("batch_size")
    acc = int((config.get("trainer") or {}).get("accumulate_grad_batches", 1) or 1)
    if per_device is not None:
        cfg["effective_train_batch"] = int(per_device) * _data_axis_size(config) * acc
    if (config.get("module") or {}).get("use_ema"):
        cfg["ema_updates_per_effective_batch"] = acc
    return cfg


def get_run_id(config: Dict[str, Any]) -> str:
    """``<group>_seed<seed>_<8 hex of the identity hash>``."""
    group = get_group_name(config)
    seed = config.get("seed", 0)
    digest = hashlib.sha256(json.dumps(identity_config(config), sort_keys=True, default=str).encode()).hexdigest()[:8]
    return f"{group}_seed{seed}_{digest}"
