from dyffusion_tpu_torch.diffusion.ddpm import GaussianDiffusionConfig, GaussianDiffusionEngine
from dyffusion_tpu_torch.diffusion.ddpm_latent import LatentDDPMConfig, LatentDDPMEngine, make_conditioned_apply
from dyffusion_tpu_torch.diffusion.dyffusion import (
    DyffusionConfig,
    DyffusionEngine,
    StepMapping,
    parse_sampling_schedule,
)
from dyffusion_tpu_torch.diffusion.mcvd import McvdConfig, McvdEngine, get_sigmas
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
    "cosine_beta_schedule",
    "get_sigmas",
    "linear_beta_schedule",
    "make_beta_schedule",
    "make_conditioned_apply",
    "parse_sampling_schedule",
]
