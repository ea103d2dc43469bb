from chemprop_tpu_torch.train.schedulers import build_noam_like_schedule, noam_lr
from chemprop_tpu_torch.train.trainer import Trainer, TrainState
from chemprop_tpu_torch.train.mab_trainer import MABTrainer

__all__ = ["MABTrainer", "TrainState", "Trainer", "build_noam_like_schedule", "noam_lr"]
