"""The SST-scale, Navier-Stokes and spring-mesh DYffusion workloads, the
MCVD NCSN++ workload, defined once for the port, and the train-step timing
idiom.

The same overrides as ``dyffusion_tpu/utils/workloads.py`` (reference
``configs/experiment/oisst_pacific_dyffusion.yaml``): 60x60 grid, C=1,
horizon 7, k=25 auxiliary steps, a dim-64 ResNet-attention UNet with mults
(1,2,4), block dropout 0.3, attention dropout 0.1, a 20-member ensemble.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

SST_CORE: Tuple[str, ...] = (
    "datamodule.spatial=(60,60)",
    "datamodule.channels=1",
    "datamodule.horizon=7",
    "model.dim=64",
    "model.dim_mults=(1,2,4)",
    "model.block_dropout=0.3",
    "model.attn_dropout=0.1",
    "module.num_predictions=20",
    "diffusion.additional_interpolation_steps=25",
)

SST_SHAPE: Dict[str, object] = {
    "C": 1, "spatial": 60, "dim": 64, "mults": [1, 2, 4], "horizon": 7, "k_aux": 25,
}

# the serving path's eval options: bf16 sampler, members folded into the batch
SST_FAST_EVAL: Tuple[str, ...] = (
    "module.eval_dtype=bfloat16",
    "module.fold_members_into_batch=True",
)


def sst_overrides(extra: Optional[Sequence[str]] = None) -> List[str]:
    """The SST workload plus caller-specific ``extra`` overrides (later
    entries win)."""
    return list(SST_CORE) + list(extra or ())


def sst_baseline_overrides(extra: Optional[Sequence[str]] = None) -> List[str]:
    """The SST workload for the baselines (time-conditioned, simultaneous,
    DDPM, LDM-DDPM, MCVD): :data:`SST_CORE` without DYffusion's auxiliary
    interpolation steps (a diffusion key the baselines do not have), plus
    ``extra``."""
    return [o for o in SST_CORE if not o.startswith("diffusion.")] + list(extra or ())


# The Navier-Stokes workload's model and physics (reference
# configs/experiment/navier_stokes.yaml and model/unet_simple_navier_stokes.yaml):
# 221x42 grid, C=3 plus 2 static condition channels, horizon 16, UNetSimple
# dim 64 with the 256x256 internal bilinear resample, dropout 0.15, 20
# members, stage 2 with refinement and forward_conditioning=none. The same
# overrides as the JAX package's (they address the synthetic datamodule; the
# navier_stokes presets set the same shapes).
NS_CORE: Tuple[str, ...] = (
    "datamodule.spatial=(221,42)",
    "datamodule.channels=3",
    "datamodule.conditional_channels=2",
    "datamodule.horizon=16",
    "model.name=unet_simple",
    "model.dim=64",
    "model.outer_sample_mode=bilinear",
    "model.upsample_dims=(256,256)",
    "model.dropout=0.15",
    "module.num_predictions=20",
    "diffusion.refine_intermediate_predictions=True",
    "diffusion.forward_conditioning=none",
)

NS_TRAIN: Tuple[str, ...] = (
    "datamodule.batch_size=32",
    "trainer.accumulate_grad_batches=2",
)


def ns_overrides(extra: Optional[Sequence[str]] = None) -> List[str]:
    """The Navier-Stokes workload (:data:`NS_CORE`) plus ``extra``."""
    return list(NS_CORE) + list(extra or ())


# The spring-mesh workload (reference configs/experiment/spring_mesh.yaml and
# model/cnn_simple.yaml): 10x10 grid, C=4 plus 1 condition channel, horizon
# 134, SimpleConvNet dim 64 with BatchNorm, dropout 0.2, 20 members, train
# batch 64, stage 2 with refinement.
SPRING_CORE: Tuple[str, ...] = (
    "datamodule.spatial=(10,10)",
    "datamodule.channels=4",
    "datamodule.conditional_channels=1",
    "datamodule.horizon=134",
    "model.name=cnn_simple",
    "model.dim=64",
    "model.net_normalization=batch_norm",
    "model.dropout=0.2",
    "module.num_predictions=20",
    "diffusion.refine_intermediate_predictions=True",
)

SPRING_TRAIN: Tuple[str, ...] = (
    "datamodule.batch_size=64",
    "trainer.accumulate_grad_batches=1",
)


def spring_overrides(extra: Optional[Sequence[str]] = None) -> List[str]:
    """The spring-mesh workload (:data:`SPRING_CORE`) plus ``extra``."""
    return list(SPRING_CORE) + list(extra or ())


# The MCVD NCSN++ workload: MCVD's own score network at its published width
# (reference MCVD configs/smmnist_DDPM_big5.yml: ngf 64, ch_mult [1,2,3,4],
# num_res_blocks 2, attn_resolutions [8,16,32], dropout 0.1; 64 head
# channels) on MCVD's native 64x64 grid, C=1, horizon 7 after a window of 1,
# 20 members (27,941,767 parameters). 64x64 rather than SST's 60x60: the FIR
# resampling ladder 60 -> 30 -> 15 -> 7 does not come back to 15.
NCSNPP_CORE: Tuple[str, ...] = (
    "datamodule.spatial=(64,64)",
    "datamodule.channels=1",
    "datamodule.horizon=7",
    "model.name=ncsnpp",
    "model.dim=64",
    "model.dim_mults=(1,2,3,4)",
    "model.num_res_blocks=2",
    "model.attn_resolutions=(8,16,32)",
    "model.n_head_channels=64",
    "model.dropout=0.1",
    "module.num_predictions=20",
)


def ncsnpp_overrides(extra: Optional[Sequence[str]] = None) -> List[str]:
    """The MCVD NCSN++ workload (:data:`NCSNPP_CORE`, for ``synthetic_mcvd``)
    plus ``extra``."""
    return list(NCSNPP_CORE) + list(extra or ())


def time_train_steps(step_fn, state, batch, steps: int = 20) -> float:
    """Seconds per train step of ``step_fn(state, batch) -> metrics``,
    averaged over ``steps`` after one warm-up step. The timing ends in
    ``torch.cuda.synchronize()`` (when the loss lies on a GPU) and a host
    read of the last loss."""

    def wait(metrics):
        if metrics["loss"].is_cuda:
            torch.cuda.synchronize(metrics["loss"].device)
        return float(metrics["loss"])

    wait(step_fn(state, batch))  # warm-up
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step_fn(state, batch)
    wait(metrics)
    return (time.perf_counter() - t0) / steps
