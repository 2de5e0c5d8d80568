"""The system under test as a user builds it: the port's presets with the
configuration's overrides, its datamodule, stage 1's interpolator and stage
2's experiment or trainer, every network holding the benchmark's weights.

A configuration's ``data`` says what the datamodule reads: 'synthetic'
(generated by the datamodule itself) or 'navier_stokes' (an archive that
:func:`benchmark.inputs.write_ns_archive` writes under ``TMPDIR`` from the
run's seed, removed when the run ends).
"""
from __future__ import annotations

import tempfile
from typing import Dict, List

import torch

from benchmark import inputs
from benchmark.reference import model as ref_model


class System:
    """The port's objects of one run, on ``device``. ``extra``: overrides
    the traffic adds (batch sizes)."""

    def __init__(self, cell, run, extra: List[str]):
        from dyffusion_tpu_torch.config import get_config
        from dyffusion_tpu_torch.interface import build_experiment, get_datamodule

        conf, self.device = cell.config, run.device
        self._tmp = None
        overrides = list(conf["overrides"]) + list(extra)
        if conf["data"] == "navier_stokes":
            self._tmp = tempfile.TemporaryDirectory(prefix="benchmark_ns_")
            root = inputs.write_ns_archive(self._tmp.name, run.seed, tuple(conf["grid"]))
            overrides.append(f"datamodule.data_dir={root}")
        self.c1 = get_config(conf["stage1_preset"], overrides)
        self.c2 = get_config(conf["preset"], overrides)
        self.dm = get_datamodule(self.c1)
        self.dm.setup()
        specs = ref_model.param_specs(conf["reference"])
        self.weights: Dict[str, Dict[str, torch.Tensor]] = {
            net: inputs.make_weights(spec, run.seed, self.device, net) for net, spec in specs.items()}
        _, self.interpolator, _, _, _ = build_experiment(self.c1, self.dm, device=self.device)
        self.interpolator.load_state_dict(self.weights["interpolator"])

    def close(self) -> None:
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None


def sync(device: str) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def free_device_memory() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_numerics() -> None:
    """Full float32 in the reference: no TF32 in matmuls or convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def request_seed(seed: int, i: int) -> int:
    return inputs.sub_seed(seed, "request", i)
