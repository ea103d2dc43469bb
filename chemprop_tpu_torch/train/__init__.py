from chemprop_tpu_torch.train.schedulers import noam_lr
from chemprop_tpu_torch.train.trainer import Trainer, TrainState

__all__ = ["TrainState", "Trainer", "noam_lr"]
