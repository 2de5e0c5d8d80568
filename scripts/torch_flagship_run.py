"""The JAX flagship run (``docs/FLAGSHIP_RUN.md``, ``runs_flagship/``) on the
port, through its CLI, on one GPU:

    python scripts/torch_flagship_run.py [--registry build/flagship_registry]

Stage 1 (``experiment=synthetic_interpolation``), stage 2
(``experiment=synthetic_dyffusion diffusion.interpolator_run_id=<stage 1>``)
and ``mode=test`` (50 members), each a ``dyffusion_tpu_torch.train.main``
call with the arguments of ``scripts/flagship_run.py``: the SST workload,
24 synthetic trajectories of 60 frames, train batch 64, eval batch 6, 25
epochs with validation every 5. Before each stage trains, it checks that its
resolved config equals the recorded ``runs_flagship/<id>/config.json``
(but for ``registry_dir``) and that its run id is the recorded directory's
name. Prints, and writes to ``chiprun_out/torch_flagship.json``: the card
and its power limit, each stage's wall time, best val CRPS (with the JAX
record's), val CRPS per validation of both packages, and the test metrics.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dyffusion_tpu_torch import train  # noqa: E402
from dyffusion_tpu_torch.config import get_config  # noqa: E402
from dyffusion_tpu_torch.utils import registry_api  # noqa: E402
from dyffusion_tpu_torch.utils.naming import get_run_id  # noqa: E402
from dyffusion_tpu_torch.utils.workloads import SST_FAST_EVAL, sst_overrides  # noqa: E402

RECORDED = os.path.join(REPO, "runs_flagship")
EPOCHS = 25


def val_curve(registry: str, run_id: str):
    return [(r["step"], r["val/crps"]) for r in registry_api.get_run_metrics(registry, run_id) if "val/crps" in r]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--registry", default=os.path.join(REPO, "build", "flagship_registry"))
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "torch_flagship.json"))
    args = ap.parse_args()
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    # the TF32 setting in force: the recorded configs leave matmul_precision unset
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    common = sst_overrides([
        "datamodule.n_traj=24", "datamodule.n_time=60", "datamodule.batch_size=64",
        "datamodule.eval_batch_size=6", "module.num_predictions_test=50", *SST_FAST_EVAL,
        f"registry_dir={args.registry}", f"trainer.max_epochs={EPOCHS}", f"trainer.val_every_n_epochs={EPOCHS // 5}",
    ])
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "stages": {}}
    id1 = None
    for stage, preset in ((1, "synthetic_interpolation"), (2, "synthetic_dyffusion")):
        overrides = common + ([f"diffusion.interpolator_run_id={id1}"] if stage == 2 else [])
        config = get_config(preset, overrides)
        run_id = get_run_id(config)
        with open(os.path.join(RECORDED, run_id, "config.json")) as f:
            recorded = json.load(f)
        mine = json.loads(json.dumps(config))
        if {**mine, "registry_dir": None} != {**recorded, "registry_dir": None}:
            raise AssertionError(f"stage {stage}: the config differs from the recorded one")
        t = time.perf_counter()
        best = train.main([f"experiment={preset}", *overrides])
        wall = time.perf_counter() - t
        jax_meta = registry_api.get_run_meta(RECORDED, run_id)
        result["stages"][stage] = {
            "run_id": run_id, "wall_s": wall, "best_val_crps": best,
            "meta": registry_api.get_run_meta(args.registry, run_id),
            "jax_best_val_crps": jax_meta["best_score"], "ratio_to_jax": best / jax_meta["best_score"],
            "val_crps": val_curve(args.registry, run_id), "jax_val_crps": val_curve(RECORDED, run_id),
        }
        print(json.dumps({"stage": stage, **result["stages"][stage]}))
        id1 = run_id
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train.main(["mode=test", f"run_id={id1}", f"registry_dir={args.registry}"])
    result["test"] = {"wall_s": time.perf_counter() - t, **json.loads(out.getvalue().strip().splitlines()[-1])}
    print(json.dumps({"stage": "test", **result["test"]}))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
