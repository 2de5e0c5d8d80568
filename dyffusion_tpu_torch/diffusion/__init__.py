from dyffusion_tpu_torch.diffusion.ddpm import GaussianDiffusionConfig, GaussianDiffusionEngine
from dyffusion_tpu_torch.diffusion.ddpm_latent import LatentDDPMConfig, LatentDDPMEngine, make_conditioned_apply
from dyffusion_tpu_torch.diffusion.dyffusion import (
    DyffusionConfig,
    DyffusionEngine,
    StepMapping,
    parse_sampling_schedule,
)
from dyffusion_tpu_torch.diffusion.mcvd import (
    McvdConfig,
    McvdEngine,
    anneal_langevin_dynamics,
    anneal_langevin_dynamics_consistent,
    anneal_langevin_dynamics_inpainting,
    anneal_langevin_dynamics_interpolation,
    get_sigmas,
    sparse_anneal_langevin_dynamics,
    sparse_anneal_langevin_dynamics_consistent,
)
from dyffusion_tpu_torch.diffusion.schedules import cosine_beta_schedule, linear_beta_schedule, make_beta_schedule

__all__ = [
    "DyffusionConfig",
    "DyffusionEngine",
    "GaussianDiffusionConfig",
    "GaussianDiffusionEngine",
    "LatentDDPMConfig",
    "LatentDDPMEngine",
    "McvdConfig",
    "McvdEngine",
    "StepMapping",
    "anneal_langevin_dynamics",
    "anneal_langevin_dynamics_consistent",
    "anneal_langevin_dynamics_inpainting",
    "anneal_langevin_dynamics_interpolation",
    "cosine_beta_schedule",
    "get_sigmas",
    "linear_beta_schedule",
    "make_beta_schedule",
    "make_conditioned_apply",
    "parse_sampling_schedule",
    "sparse_anneal_langevin_dynamics",
    "sparse_anneal_langevin_dynamics_consistent",
]
