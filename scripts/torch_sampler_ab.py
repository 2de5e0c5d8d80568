#!/usr/bin/env python3
"""Time the port's eager DDPM and MCVD samplers of several checkouts on one
GPU, in turns.

    python3 scripts/torch_sampler_ab.py TREE [TREE ...]

For each TREE (a checkout of the repo, e.g. the parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists, and this one),
in the order given (parent, change, change, parent for an A/B), one
process builds ``synthetic_ddpm`` and ``synthetic_mcvd`` at the SST width
of ``[baselines]`` (``utils.workloads.sst_baseline_overrides``, random
weights from the preset's seed) with a 200-step sampler, serves one
warm-up request of one row (20 members) and times three more (host clock,
each ending in ``torch.cuda.synchronize()``). It also times the host cost
of one elementwise CUDA op with a Python float, a 0-dim CPU tensor and a
0-dim CPU view as its scalar (2000 launches, no sync between them). Prints
one JSON line per process. These requests are launch-bound: the numbers
are the host's cost per sampler step.
"""
from __future__ import annotations

import subprocess
import sys

CHILD = r'''
import json, sys, time
import numpy as np
import torch

sys.path.insert(0, sys.argv[1])
from dyffusion_tpu_torch import config, interface, serving
from dyffusion_tpu_torch.utils.workloads import sst_baseline_overrides

out = {}
for preset in ("synthetic_ddpm", "synthetic_mcvd"):
    overrides = sst_baseline_overrides(["datamodule.n_traj=5", "datamodule.n_time=9", "datamodule.batch_size=4",
                                        "datamodule.eval_batch_size=2", "diffusion.timesteps=200",
                                        "trainer.save_checkpoints=False"])
    cfg = config.get_config(preset, overrides)
    dm = interface.get_datamodule(cfg)
    dm.setup()
    exp, _, _, eval_fns, _ = interface.build_experiment(cfg, dm, device="cuda")
    predict, specs, _ = serving.build_experiment_predict_fn(exp, eval_fns, dm, None)
    rng = np.random.default_rng(0)
    batch = {k: rng.standard_normal((1,) + s.shape[1:]).astype(s.dtype) for k, s in specs.items()}
    predict(batch, 0)
    torch.cuda.synchronize()
    seconds = []
    for _ in range(3):
        t = time.perf_counter()
        predict(batch, 0)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    out[preset] = seconds
x = torch.randn(20, 8, 60, 60, device="cuda")
scalars = {"python float": 0.5, "cpu 0-dim": torch.tensor(0.5), "cpu 0-dim view": torch.ones(4)[1]}
for name, s in scalars.items():
    x * s
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        x * s
    out[name + " us"] = (time.perf_counter() - t) / 2000 * 1e6
    torch.cuda.synchronize()
print(json.dumps(out))
'''


def main(trees) -> int:
    if not trees:
        raise SystemExit(__doc__)
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, tree], capture_output=True, text=True)
        report = proc.stdout.strip().splitlines()[-1] if proc.returncode == 0 else proc.stderr[-3000:]
        print(tree, report, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
