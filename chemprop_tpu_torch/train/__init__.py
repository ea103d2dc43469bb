from chemprop_tpu_torch.train.schedulers import noam_lr
from chemprop_tpu_torch.train.trainer import Trainer, TrainState
from chemprop_tpu_torch.train.mab_trainer import MABTrainer

__all__ = ["MABTrainer", "TrainState", "Trainer", "noam_lr"]
