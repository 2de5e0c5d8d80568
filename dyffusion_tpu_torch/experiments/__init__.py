from dyffusion_tpu_torch.experiments.base import Experiment, ExperimentConfig, stack_window
from dyffusion_tpu_torch.experiments.forecasting import (
    DyffusionForecastingExperiment,
    ForecastingExperiment,
    SimultaneousForecastingExperiment,
    TimeConditionedForecastingExperiment,
)
from dyffusion_tpu_torch.experiments.interpolation import InterpolationExperiment

__all__ = [
    "DyffusionForecastingExperiment",
    "Experiment",
    "ExperimentConfig",
    "ForecastingExperiment",
    "InterpolationExperiment",
    "SimultaneousForecastingExperiment",
    "TimeConditionedForecastingExperiment",
    "stack_window",
]
