"""Config system: experiment presets + dotted overrides.

Counterpart of ``dyffusion_tpu/config.py`` for the presets the port runs:
``{synthetic, navier_stokes, spring_mesh}_{interpolation, dyffusion}``. A
preset is the base layer deep-merged with a dataset layer, a method layer
and the preset's own tweaks; the physical systems read their archives from
``datamodule.data_dir`` (a free key of the datamodule section). Overrides
use the same ``a.b.c=value`` grammar (Python literals, ``true``/``false``/
``null``, a ``+`` prefix for intentionally new keys).

The training path reads ``module.{optimizer, scheduler, use_ema, ema_decay,
train_dtype}``, ``trainer.{max_epochs, max_steps, gradient_clip_val,
accumulate_grad_batches, fold_accumulation_into_batch, val_every_n_epochs,
early_stopping_patience, log_every_n_steps, precision, save_checkpoints}``,
``model.remat`` and ``diffusion.{lambda_reconstruction,
lambda_reconstruction2, train_interpolator_dtype, loss_function,
interpolator_run_id, interpolator_use_ema}``; the driver reads
``registry_dir``, ``run_id``, ``use_wandb``, ``matmul_precision`` (or
``torch_matmul_precision``) and ``jax_debug_nans`` (``debug=true`` sets it:
autograd anomaly detection). ``perf=parity`` is accepted; ``perf=measured``
(the JAX package's per-preset execution-layout recipes) is not ported.
A config the port accepts resolves to the same dict as the JAX package's.
"""
from __future__ import annotations

import ast
import copy
import difflib
from typing import Any, Dict, List, Optional, Tuple

_BASE: Dict[str, Any] = {
    "seed": 7,
    "registry_dir": "runs",
    "experiment": None,
    "datamodule": {"name": "synthetic", "window": 1, "horizon": 8, "batch_size": 16},
    "model": {"name": "unet_resnet", "dim": 32, "with_time_emb": True},
    "diffusion": None,
    "module": {
        "num_predictions": 20,
        "num_predictions_test": 50,
        "prediction_inputs_noise": 0.0,
        "enable_inference_dropout": True,
        "loss_function": "mse",
        "use_ema": False,
        "ema_decay": 0.9999,
        "optimizer": {"name": "adamw", "lr": 3e-4, "weight_decay": 1e-5},
        "scheduler": None,
        "monitor": None,
    },
    "trainer": {"max_epochs": 10, "gradient_clip_val": 1.0, "val_every_n_epochs": 1},
}

_DATASETS: Dict[str, Dict[str, Any]] = {
    "synthetic": {
        "datamodule": {"name": "synthetic", "horizon": 8, "window": 1, "batch_size": 16},
        "model": {"name": "unet_resnet", "dim": 32, "dim_mults": [1, 2]},
    },
    # the physical systems read their archives from datamodule.data_dir
    "spring_mesh": {
        "datamodule": {
            "name": "physical-systems", "physical_system": "spring-mesh",
            "batch_size": 64, "eval_batch_size": 16, "horizon": 134,
            "prediction_horizon": 804, "window": 1,
        },
        "model": {"name": "cnn_simple", "dim": 64, "net_normalization": "batch_norm"},
        "module": {"optimizer": {"name": "adamw", "lr": 4e-4, "weight_decay": 1e-4}},
        "trainer": {"max_epochs": 300, "gradient_clip_val": 1.0, "accumulate_grad_batches": 1},
    },
    "navier_stokes": {
        "datamodule": {
            "name": "physical-systems", "physical_system": "navier-stokes",
            "batch_size": 32, "eval_batch_size": 4, "horizon": 16,
            "prediction_horizon": 64, "window": 1,
        },
        "model": {
            "name": "unet_simple", "dim": 64, "outer_sample_mode": "bilinear",
            "upsample_dims": [256, 256], "dropout": 0.15,
        },
        "module": {"optimizer": {"name": "adamw", "lr": 3e-4, "weight_decay": 1e-4}},
        "trainer": {"max_epochs": 200, "gradient_clip_val": 1.0, "accumulate_grad_batches": 2},
    },
}

_METHODS: Dict[str, Dict[str, Any]] = {
    "interpolation": {
        "experiment": "interpolation",
        "model": {"with_time_emb": True},
    },
    "dyffusion": {
        "experiment": "dyffusion",
        "model": {"with_time_emb": True},
        "diffusion": {
            "name": "dyffusion",
            "loss_function": "l1",
            "interpolator_run_id": None,
            "interpolator_use_ema": False,
            "lambda_reconstruction": 0.5,
            "lambda_reconstruction2": 0.5,
            "forward_conditioning": "data",
            "schedule": "before_t1_only",
            "additional_interpolation_steps": 0,
            "additional_interpolation_steps_factor": 0,
            "interpolate_before_t1": True,
            "time_encoding": "dynamics",
            "enable_interpolator_dropout": True,
            "sampling_type": "cold",
            "sampling_schedule": None,
            "refine_intermediate_predictions": False,
            "use_cold_sampling_for_last_step": False,
            "timesteps": "${datamodule.horizon}",
        },
    },
}

# dataset x method tweaks of the presets above (the JAX package's _COMBO)
_COMBO: Dict[str, Dict[str, Any]] = {
    "navier_stokes_dyffusion": {
        "diffusion": {"refine_intermediate_predictions": True, "forward_conditioning": "none"},
    },
    "spring_mesh_dyffusion": {
        "diffusion": {
            "refine_intermediate_predictions": True,
            "forward_conditioning": "data",
            "use_cold_sampling_for_last_step": False,
        },
    },
    "spring_mesh_interpolation": {"model": {"dropout": 0.05}},
}

# closed namespaces: an unknown key there is a typo, not a pass-through
_TOP_LEVEL_KEYS = {
    "seed", "registry_dir", "experiment", "preset", "datamodule", "model",
    "diffusion", "module", "trainer", "debug", "run_id", "jax_debug_nans",
    "matmul_precision", "torch_matmul_precision", "use_wandb", "perf",
}
_PERF_MODES = ("parity", "measured")
_TRAINER_KEYS = {
    "max_epochs", "max_steps", "val_every_n_epochs", "save_checkpoints",
    "devices", "spatial_shards", "spatial_axis", "precision",
    "gradient_clip_val", "accumulate_grad_batches",
    "early_stopping_patience", "fold_accumulation_into_batch",
    "log_every_n_steps", "watch_gradients",
}
_MODULE_KEYS = {
    "ema_decay", "enable_inference_dropout", "eval_dtype",
    "fold_members_into_batch", "horizon", "loss_function", "monitor",
    "num_predictions", "num_predictions_test", "optimizer",
    "prediction_horizon", "prediction_inputs_noise", "scheduler",
    "train_dtype", "use_ema", "window",
}


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def list_presets() -> List[str]:
    return sorted(f"{d}_{m}" for d in _DATASETS for m in _METHODS)


def get_config(preset: Optional[str] = None, overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """Compose base + dataset + method layers, apply dotted overrides, then
    resolve interpolations."""
    cfg = copy.deepcopy(_BASE)
    if preset:
        dataset = next((d for d in sorted(_DATASETS, key=len, reverse=True) if preset.startswith(d)), None)
        if dataset is None:
            raise ValueError(f"Unknown preset '{preset}'. Known: {list_presets()}")
        method = preset[len(dataset):].lstrip("_") or "interpolation"
        if method not in _METHODS:
            raise ValueError(f"Unknown method '{method}' in preset '{preset}'. Methods: {sorted(_METHODS)}")
        cfg = deep_merge(cfg, _DATASETS[dataset])
        cfg = deep_merge(cfg, _METHODS[method])
        cfg = deep_merge(cfg, _COMBO.get(preset, {}))
        cfg["preset"] = preset
    # perf=<mode> selects an execution-layout recipe; the last token wins
    rest, perf = [], None
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        if key.strip().lstrip("+") == "perf":
            perf = val.strip()
            if perf not in _PERF_MODES:
                raise ValueError(f"unknown perf mode '{perf}' (choose from {list(_PERF_MODES)})")
        else:
            rest.append(ov)
    if perf == "measured":
        raise NotImplementedError("perf=measured (the per-preset execution-layout recipes) is not ported yet (ROADMAP A11)")
    if perf:
        cfg["perf"] = perf
    extra_ok = set()
    for ov in rest:
        key, was_plus = apply_override(cfg, ov)
        if was_plus:
            extra_ok.add(key)
    return resolve(cfg, extra_ok=extra_ok)


def apply_override(cfg: Dict[str, Any], override: str) -> Tuple[str, bool]:
    """Apply one 'a.b.c=value' override. Returns (dotted key, had '+' prefix)."""
    key, eq, raw = override.partition("=")
    if not eq:
        raise ValueError(f"override '{override}' must look like key=value")
    key = key.strip()
    allow_new = key.startswith("+")
    if allow_new:
        key = key[1:]
    low = raw.strip().lower()
    if low in ("true", "false"):
        value = low == "true"
    elif raw.strip() in ("null", "None"):
        value = None
    else:
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
    node = cfg
    parts = key.split(".")
    for p in parts[:-1]:
        if node.get(p) is None:
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value
    return key, allow_new


def validate_config(cfg: Dict[str, Any], extra_ok=()) -> None:
    """Reject unknown keys in the closed namespaces (top level, trainer.*,
    module.*) with a did-you-mean hint."""
    extra_ok = set(extra_ok)

    def exempt(dotted: str) -> bool:
        return any(e == dotted or e.startswith(dotted + ".") for e in extra_ok)

    def check(prefix: str, keys, allowed) -> None:
        for k in keys:
            dotted = f"{prefix}{k}"
            if k not in allowed and not exempt(dotted):
                hint = difflib.get_close_matches(k, allowed, n=1)
                did = f" — did you mean '{prefix}{hint[0]}'?" if hint else ""
                raise ValueError(
                    f"unknown config key '{dotted}'{did} (prefix the override with '+' to add a new key)"
                )

    check("", cfg.keys(), _TOP_LEVEL_KEYS)
    check("trainer.", (cfg.get("trainer") or {}).keys(), _TRAINER_KEYS)
    check("module.", (cfg.get("module") or {}).keys(), _MODULE_KEYS)


def resolve(cfg: Dict[str, Any], extra_ok=()) -> Dict[str, Any]:
    """Resolve ``${a.b}`` interpolations and the consistency rules: debug
    mode (a two-step run without checkpoints, two members, anomaly
    detection); DYffusion timesteps == horizon; module window/horizon mirror
    the datamodule."""
    validate_config(cfg, extra_ok=extra_ok)

    def lookup(path: str):
        node: Any = cfg
        for p in path.split("."):
            node = node[p]
        return node

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and node.startswith("${") and node.endswith("}"):
            return lookup(node[2:-1])
        return node

    cfg = walk(cfg)
    if cfg.get("debug"):
        cfg["trainer"] = deep_merge(
            cfg.get("trainer", {}),
            {"max_epochs": 1, "max_steps": 2, "val_every_n_epochs": 1, "save_checkpoints": False},
        )
        cfg["module"] = deep_merge(cfg.get("module", {}), {"num_predictions": 2, "num_predictions_test": 2})
        cfg["jax_debug_nans"] = True
    diff = cfg.get("diffusion")
    if diff and diff.get("name") == "dyffusion":
        diff["timesteps"] = cfg["datamodule"]["horizon"]
    cfg.setdefault("module", {})
    cfg["module"]["window"] = cfg["datamodule"].get("window", 1)
    cfg["module"]["horizon"] = cfg["datamodule"]["horizon"]
    cfg["module"]["prediction_horizon"] = cfg["datamodule"].get("prediction_horizon")
    return cfg
