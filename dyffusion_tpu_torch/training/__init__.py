"""Training: optimizer, EMA, train state and the trainer."""
from dyffusion_tpu_torch.training.ema import ema_update, init_ema
from dyffusion_tpu_torch.training.optim import Optimizer, build_optimizer, clip_by_global_norm
from dyffusion_tpu_torch.training.state import TrainState
from dyffusion_tpu_torch.training.trainer import Trainer, make_train_step, metric_sums, mixed_precision_loss

__all__ = [
    "Optimizer",
    "TrainState",
    "Trainer",
    "build_optimizer",
    "clip_by_global_norm",
    "ema_update",
    "init_ema",
    "make_train_step",
    "metric_sums",
    "mixed_precision_loss",
]
