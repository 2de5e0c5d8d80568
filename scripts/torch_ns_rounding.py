#!/usr/bin/env python3
"""Where float32 rounding moves a Navier-Stokes stage-2 gradient.

    python3 scripts/torch_ns_rounding.py [--device cpu] [--dim 8] [--rows 4] [--grid 64,128]

Builds NS's stage-1 and stage-2 trainers in one process at a small width,
on a fake archive at the real 221 x 42 grid (written into a temporary
directory), draws their weights as ``chip_smoke._spread_weights`` does, and
takes one stage-2 loss and its forecaster gradients at the first ``--rows``
rows of the first train batch (``chip_smoke._spatial_grads``), in float32
and in float64 (``chip_smoke._in_float64``). Prints:

- the gradients' largest float32-vs-float64 differences, each tensor
  against the larger of its own max|g| and 0.1 of the largest of all (as
  ``chip_smoke`` measures two ranks against one);
- for each encoder block's conv and norm of the forecaster, the difference
  of its output and of the gradients at its output and input, relative to
  the tensor's max|float64| (one line per call: the first is the train-mode
  pass's, the backward's are in reverse order);
- per ReLU / LeakyReLU call of the backbones (interpolator and forecaster),
  the elements whose input has another sign in float32 than in float64:
  there the gradient takes the other slope.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dyffusion_tpu_torch.config import get_config  # noqa: E402
from dyffusion_tpu_torch.data import write_fake_benchmark_dir  # noqa: E402
from dyffusion_tpu_torch.interface import build_trainer  # noqa: E402
from dyffusion_tpu_torch.models import unet_simple  # noqa: E402


class _Activations:
    """``torch.nn.functional`` for ``models/unet_simple.py``, keeping the
    input of every ReLU and LeakyReLU call."""

    def __init__(self):
        self.inputs = []

    def __getattr__(self, name):
        return getattr(F, name)

    def relu(self, x):
        self.inputs.append(x.detach().double())
        return F.relu(x)

    def leaky_relu(self, x, slope):
        self.inputs.append(x.detach().double())
        return F.leaky_relu(x, slope)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--grid", default="64,128", help="the working grid H,W (model.upsample_dims)")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="ns_rounding_") as data:
        write_fake_benchmark_dir(data, "navier-stokes", n_traj={"train": 1, "val": 1, "test": 1}, n_time=24,
                                 seed=chip_smoke.SEED)
        overrides = [f"datamodule.data_dir={data}", "trainer.devices=1", "datamodule.horizon=4",
                     "datamodule.prediction_horizon=8", f"datamodule.batch_size={args.rows}", f"model.dim={args.dim}",
                     f"model.upsample_dims=({args.grid})", "matmul_precision=highest"]
        stage1 = build_trainer(get_config("navier_stokes_interpolation", overrides), device=args.device)
        chip_smoke._spread_weights(stage1.experiment.model, chip_smoke.SEED + 1)
        trainer = build_trainer(get_config("navier_stokes_dyffusion", overrides),
                                interpolator=stage1.experiment.model, device=args.device)
        chip_smoke._spread_weights(trainer.experiment.model, chip_smoke.SEED + 2)
        model = trainer.experiment.model
        kept = {}

        def forward_hook(name):
            return lambda mod, inputs, out: kept.setdefault(f"{name} output", []).append(out.detach().double())

        def backward_hook(name):
            def hook(mod, grad_in, grad_out):
                kept.setdefault(f"{name} grad at output", []).append(grad_out[0].detach().double())
                kept.setdefault(f"{name} grad at input", []).append(grad_in[0].detach().double())
            return hook

        for i in range(len(model.input_ops)):
            for j, kind in ((0, "conv"), (1, "norm")):
                name = f"input_ops.{i}.ops.{j} ({kind})"
                op = model.input_ops[i].ops[j]
                op.register_forward_hook(forward_hook(name))
                op.register_full_backward_hook(backward_hook(name))
        runs = {}
        for precision in ("float32", "float64"):
            kept.clear()
            acts = unet_simple.F = _Activations()
            try:
                with chip_smoke._in_float64(trainer) if precision == "float64" else contextlib.nullcontext():
                    grads = chip_smoke._spatial_grads(trainer, False, rows=args.rows)
            finally:
                unet_simple.F = F
            runs[precision] = grads, {k: list(v) for k, v in kept.items()}, acts.inputs
    (g32, k32, a32), (g64, k64, a64) = runs["float32"], runs["float64"]
    top = max(float(w.abs().max()) for w in g64["grads"].values())
    worst = sorted(((float((g32["grads"][k] - w).abs().max()) / max(float(w.abs().max()), 0.1 * top), k)
                    for k, w in g64["grads"].items()), reverse=True)
    print(f"NS stage 2, dim {args.dim}, {args.rows} rows, working grid {args.grid}, on {args.device}: loss "
          f"float32 {g32['loss']:.9g}, float64 {g64['loss']:.9g}; gradients float32 vs float64, furthest off "
          f"(error / scale): " + ", ".join(f"{k} {e:.2e}" for e, k in worst[:6]))
    for name in sorted(k64):
        errs = [float((x - y).abs().max() / y.abs().max()) for x, y in zip(k32[name], k64[name])]
        print(f"  {name}: " + ", ".join(f"{e:.2e}" for e in errs))
    flips = [int(((x > 0) != (y > 0)).sum()) for x, y in zip(a32, a64)]
    sizes = [x.numel() for x in a64]
    print(f"ReLU / LeakyReLU calls {len(flips)}: inputs of another sign in float32, per call {flips} "
          f"({sum(flips)} of {sum(sizes)} elements; {np.mean([f > 0 for f in flips]):.2f} of the calls)")


if __name__ == "__main__":
    main()
