#!/usr/bin/env python3
"""Time ``torch.export`` of the SST sampler on the host's CPU: trace, save,
load and ``module()``.

    python3 scripts/torch_export_timing.py [--static]

Builds the SST DYffusion sampler (``utils/workloads.py``: horizon 7, k=25,
``Unet`` mults (1,2,4), 20 members, bf16, folded) at a narrow width (dim 8
on 16x16: the graph has the full-width sampler's nodes, since width and
grid change no node) on the CPU with random weights, exports it with
``serving.export_experiment`` (a symbolic batch, or a pinned one with
``--static``), saves it under ``build/``, loads it with
``torch.export.load`` (plain, then with ``serving._cached_type_hints``) and
builds its module. Prints one JSON line: seconds of each step, the graph's
nodes and B1 nodes, the file's bytes. These are host costs; no device runs.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    import torch

    from dyffusion_tpu_torch import config, interface, serving
    from dyffusion_tpu_torch.utils.workloads import SST_FAST_EVAL, sst_overrides

    if argv not in ([], ["--static"]):
        raise SystemExit("usage: python3 scripts/torch_export_timing.py [--static]")
    static = argv == ["--static"]
    overrides = sst_overrides(["datamodule.spatial=(16,16)", "model.dim=8", "datamodule.n_traj=5",
                               "datamodule.n_time=13", "datamodule.batch_size=6", "datamodule.eval_batch_size=6",
                               *SST_FAST_EVAL, "trainer.save_checkpoints=False"])
    c1 = config.get_config("synthetic_interpolation", overrides)
    dm = interface.get_datamodule(c1)
    dm.setup()
    _, interpolator, _, _, _ = interface.build_experiment(c1, dm, device="cpu")
    c2 = config.get_config("synthetic_dyffusion", overrides)
    exp, _, _, eval_fns, _ = interface.build_experiment(c2, dm, interpolator=interpolator, device="cpu")

    out = {}
    t = time.perf_counter()
    exported, manifest = serving.export_experiment(exp, eval_fns, dm, None, polymorphic_batch=not static)
    out["export"] = time.perf_counter() - t
    out["nodes"], out["b1"] = manifest["graph"]["nodes"], manifest["graph"]["b1_nodes"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", f"sst_{'static' if static else 'symbolic'}.pt2")
    t = time.perf_counter()
    torch.export.save(exported, path)
    out["save"], out["bytes"] = time.perf_counter() - t, os.path.getsize(path)
    t = time.perf_counter()
    torch.export.load(path)
    out["load"] = time.perf_counter() - t
    t = time.perf_counter()
    with serving._cached_type_hints():
        loaded = torch.export.load(path)
    out["load_cached_hints"] = time.perf_counter() - t
    t = time.perf_counter()
    loaded.module()
    out["module"] = time.perf_counter() - t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
