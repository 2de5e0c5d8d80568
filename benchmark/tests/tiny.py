"""A copy of the benchmark with tiny configurations and cells added as
files only (the way a later change adds them), for CPU tests."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_SST = ["datamodule.spatial=(16,16)", "datamodule.channels=1", "datamodule.horizon=4", "model.dim=8",
            "model.dim_mults=(1,2)", "model.block_dropout=0.3", "model.attn_dropout=0.1",
            "module.num_predictions=3", "diffusion.additional_interpolation_steps=3",
            "module.eval_dtype=float32", "module.fold_members_into_batch=True", "module.train_dtype=float32",
            "datamodule.n_traj=2", "datamodule.n_time=12", "trainer.save_checkpoints=False"]


def tiny_config() -> dict:
    """sst_dyffusion cut to a CPU test's size (widths included), in float32."""
    conf = json.loads((REPO / "benchmark/configs/sst_dyffusion.json").read_text())
    conf = copy.deepcopy(conf)
    conf.update(name="sst_tiny", overrides=TINY_SST, grid=[16, 16])
    ref = conf["reference"]
    ref.update(horizon=4, k=3, low_eps={"serve": [False, False], "train": [False, False]})
    for net in ref["model"].values():
        net.update(dim=8, dim_mults=[1, 2])
    # float32 on both sides agrees to about 1e-6 on the CPU; the fp8 control reads 0.1 to 1
    conf["limits"] = {"serve": {"step_gap": 1e-3, "worst_step": 1e-3, "start_gap": 1e-3},
                      "train": {"loss_gap": 1e-3, "grad_gap": 1e-3, "update_gap": 1e-2}}
    return conf


def tiny_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and the benchmark folder, plus the
    configuration ``sst_tiny`` and the cells ``tiny-serve`` and
    ``tiny-train`` added as files and entries."""
    root = Path(tmp)
    shutil.copytree(REPO / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "benchmark/configs/sst_tiny.json").write_text(json.dumps(tiny_config()))
    (root / "benchmark/traffic/tiny-serve.json").write_text(json.dumps({"mode": "serve", "rows": 2, "pool": 2,
                                                                         "split": "predict"}))
    (root / "benchmark/traffic/tiny-train.json").write_text(json.dumps({"mode": "train", "rows": 4, "pool": 4,
                                                                         "checked_steps": 3}))
    bench["configs"].append({"name": "sst_tiny", "source": "test", "file": "benchmark/configs/sst_tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"] += [{"name": "tiny-serve", "config": "sst_tiny", "traffic": "tiny-serve", "chips": 1, "why": "t"},
                           {"name": "tiny-train", "config": "sst_tiny", "traffic": "tiny-train", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            mode = "serve" if any(w.endswith("serve") for w in m["workloads"]) else "train"
            m["workloads"].append(f"tiny-{mode}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
