"""Local run-registry queries (counterpart of
``dyffusion_tpu/utils/registry_api.py``), over the files the trainer writes:
``<registry>/<run_id>/{config.json, meta.json, metrics.jsonl, best, last}``.
The files are the JAX package's, so these read either package's runs.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def list_runs(registry_dir: str) -> List[str]:
    """Every run id in the registry (a directory holding ``config.json``)."""
    if not os.path.isdir(registry_dir):
        return []
    return sorted(
        d for d in os.listdir(registry_dir)
        if os.path.isdir(os.path.join(registry_dir, d))
        and os.path.exists(os.path.join(registry_dir, d, "config.json"))
    )


def get_run_config(registry_dir: str, run_id: str) -> Dict[str, Any]:
    with open(os.path.join(registry_dir, run_id, "config.json")) as f:
        return json.load(f)


def get_run_meta(registry_dir: str, run_id: str) -> Dict[str, Any]:
    path = os.path.join(registry_dir, run_id, "meta.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def get_run_metrics(registry_dir: str, run_id: str) -> List[Dict[str, Any]]:
    """The run's metric stream, one dict per JSONL record."""
    path = os.path.join(registry_dir, run_id, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def filter_runs(
    registry_dir: str,
    group_contains: Optional[str] = None,
    seed: Optional[int] = None,
    experiment: Optional[str] = None,
) -> List[str]:
    """Run ids whose name contains ``group_contains`` and whose config has
    the given seed and experiment type."""
    out = []
    for rid in list_runs(registry_dir):
        if group_contains and group_contains not in rid:
            continue
        cfg = get_run_config(registry_dir, rid)
        if seed is not None and cfg.get("seed") != seed:
            continue
        if experiment is not None and cfg.get("experiment") != experiment:
            continue
        out.append(rid)
    return out


def get_runs_summary(registry_dir: str, run_ids: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """One row per run: id, experiment, dataset, seed, best score and its
    monitor, best and last step."""
    rows = []
    for rid in run_ids or list_runs(registry_dir):
        cfg = get_run_config(registry_dir, rid)
        meta = get_run_meta(registry_dir, rid)
        rows.append(
            {
                "run_id": rid,
                "experiment": cfg.get("experiment"),
                "dataset": cfg.get("datamodule", {}).get("name"),
                "seed": cfg.get("seed"),
                "monitor": meta.get("best_monitor"),
                "best_score": meta.get("best_score"),
                "best_step": meta.get("best_step"),
                "last_step": meta.get("last_step"),
            }
        )
    return rows


def metrics_of_runs_to_arrays(registry_dir: str, run_ids: List[str], metric: str) -> Dict[str, List]:
    """{run id: [(step, value), ...]} of one metric over several runs."""
    return {
        rid: [(r["step"], r[metric]) for r in get_run_metrics(registry_dir, rid) if metric in r]
        for rid in run_ids
    }
