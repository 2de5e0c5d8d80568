"""Command line of the port (counterpart of ``dyffusion_tpu/train.py``):

    python -m dyffusion_tpu_torch.train experiment=synthetic_interpolation \
        trainer.max_epochs=3 datamodule.horizon=8
    python -m dyffusion_tpu_torch.train experiment=synthetic_dyffusion \
        diffusion.interpolator_run_id=<stage-1 run id>
    python -m dyffusion_tpu_torch.train mode=test run_id=<run id>

Any ``key.subkey=value`` override is accepted; ``experiment=<preset>``
picks a preset (``dyffusion_tpu_torch.config.list_presets``). Training
prints one JSON line ``{"best", "monitor", "run_dir"}``; ``mode=test``
reloads a finished run by ``run_id`` from ``registry_dir`` and prints its
test metrics (the test-size ensemble). The same arguments give the same
``config.json`` and run id as the JAX package's command.

``--device=<d>`` picks the torch device (default ``cuda``; ``--device=cpu``
runs on the CPU); it is not part of the config. Without CUDA the default
raises.

Data parallelism: ``trainer.devices=N`` (N > 1) outside a process group
starts N local ranks (``torch.multiprocessing``, ``MASTER_ADDR=localhost``
and a free port), each running this same command; ``mode=test`` reads N
from the run's stored config (and the overrides). Under a launcher
(``torchrun``, which sets ``WORLD_SIZE``) the command joins the launcher's
group, and ``trainer.devices`` must be ``auto`` or the world size. Rank 0
alone prints the final JSON line.

Spatial sharding: ``trainer.devices=N trainer.spatial_shards=K`` (K
dividing N and the grid's H, or its W with ``trainer.spatial_axis=w``),
in training as in ``mode=test``, starts N ranks as above, a grid of N/K
data indices by K slabs; each model group of K ranks splits the grid of
its rows. ``datamodule.batch_size`` is per data index, as without a shard,
so the run id is that of the N/K-rank data-parallel run.

Sweeps: ``-m``/``--multirun`` expands every comma-valued override into the
cartesian product of runs, each under its own run id; commas inside
brackets stay literal (``model.dim_mults=(1,2)`` is one value).
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import sys
import tempfile
from typing import Any, Dict, List, Optional

from dyffusion_tpu_torch.config import apply_override, get_config, list_presets
from dyffusion_tpu_torch.interface import reload_and_test, run_experiment
from dyffusion_tpu_torch.parallel import distributed
from dyffusion_tpu_torch.training.checkpoint import CheckpointManager, find_run_dir


def _split_sweep_values(value: str) -> List[str]:
    """Split on top-level commas only: ``1e-4,3e-4`` sweeps, but bracketed
    tuples and lists such as ``(1,2)`` stay one value."""
    parts, depth, cur = [], 0, ""
    for ch in value:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    return parts


def expand_multirun(args: List[str]) -> List[List[str]]:
    """One argument list per run: the cartesian product of the
    comma-valued ``key=value`` arguments, each swept argument kept at its
    place, in lexicographic sweep order."""
    sweep_keys: List[str] = []
    sweep_vals: List[List[str]] = []
    positions: List[int] = []
    for i, arg in enumerate(args):
        k, eq, v = arg.partition("=")
        vals = _split_sweep_values(v) if eq else [v]
        if len(vals) > 1:
            sweep_keys.append(k)
            sweep_vals.append(vals)
            positions.append(i)
    if not sweep_keys:
        return [args]
    combos = []
    for combo in itertools.product(*sweep_vals):
        run_args = list(args)
        for pos, k, v in zip(positions, sweep_keys, combo):
            run_args[pos] = f"{k}={v}"
        combos.append(run_args)
    return combos


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _requested_ranks(config: Dict[str, Any]) -> int:
    devices = (config.get("trainer") or {}).get("devices", "auto")
    return 1 if devices in ("auto", -1, None) else int(devices)


def _rank_main(rank: int, world: int, port: int, argv: List[str], device: str, result: str) -> None:
    """One rank of :func:`spawn_ranks`: the launcher's environment, then
    the command; rank 0 writes its result to ``result``."""
    import torch

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        value = main(argv, device=device)
        if rank == 0:
            with open(result, "w") as f:
                json.dump(value, f)
    finally:
        if distributed.active():
            torch.distributed.destroy_process_group()


def spawn_ranks(world: int, argv: List[str], device: str) -> float:
    """Run the command ``argv`` on ``world`` local ranks (new processes,
    joined; a rank that fails ends the others and raises here); returns
    rank 0's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dyffusion_ranks_") as tmp:
        result = os.path.join(tmp, "result.json")
        mp.spawn(_rank_main, args=(world, _free_port(), argv, device, result), nprocs=world, join=True)
        with open(result) as f:
            return float(json.load(f))


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> float:
    """Run the command ``argv`` (default ``sys.argv[1:]``); returns the best
    monitored score (training) or ``test/crps`` (``mode=test``).
    ``--device=<d>`` in ``argv`` overrides ``device``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    for arg in [a for a in argv if a.startswith("--device=")]:
        device = arg.split("=", 1)[1]
        argv.remove(arg)
    if "-m" in argv or "--multirun" in argv:
        argv = [a for a in argv if a not in ("-m", "--multirun")]
        combos = expand_multirun(argv)
        if len(combos) > 1:
            results = []
            for i, run_args in enumerate(combos):
                print(f"[multirun {i + 1}/{len(combos)}] {' '.join(run_args)}")
                results.append({"args": run_args, "best": main(run_args, device=device)})
            finite = [r for r in results if r["best"] == r["best"]]
            best = min((r["best"] for r in finite), default=float("nan"))  # every preset monitor minimizes
            print(json.dumps({"multirun": len(combos), "best": best, "results": results}))
            return best
    preset, mode, run_id, registry = None, "train", None, "runs"
    overrides = []
    for arg in argv:
        if arg.startswith("experiment="):
            preset = arg.split("=", 1)[1]
        elif arg.startswith("mode="):
            mode = arg.split("=", 1)[1]
        elif arg.startswith("run_id="):
            run_id = arg.split("=", 1)[1]
        elif arg in ("--help", "-h"):
            print(__doc__)
            print("presets:", ", ".join(list_presets()))
            return 0.0
        else:
            overrides.append(arg)
            if arg.startswith("registry_dir="):
                registry = arg.split("=", 1)[1]

    if mode == "test":
        if not run_id:
            raise ValueError("mode=test requires run_id=<id>")
        config = CheckpointManager(find_run_dir(registry, run_id), monitor="val/crps").load_config()
        for ov in overrides:
            apply_override(config, ov)
    else:
        config = get_config(preset, overrides)
    ranks = _requested_ranks(config)
    if ranks > 1 and distributed.launcher_world() is None:
        return spawn_ranks(ranks, argv + [f"--device={device}"], device)

    if mode == "test":
        metrics = reload_and_test(registry, run_id, overrides, device=device)
        if distributed.rank() == 0:
            print(json.dumps(metrics))
        return metrics.get("test/crps", float("nan"))

    trainer, best = run_experiment(config, device=device)
    if distributed.rank() == 0:
        print(json.dumps({"best": best, "monitor": trainer.monitor,
                          "run_dir": trainer.ckpt.run_dir if trainer.ckpt else None}))
    return best


def cli() -> int:
    """Console-script entry (``dyffusion-tpu-torch``): any finished run exits
    0; a raised exception exits non-zero."""
    main()
    return 0


if __name__ == "__main__":
    main()
