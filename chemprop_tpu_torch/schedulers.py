"""The Noam-like learning-rate schedule at the top level (cf.
``chemprop_tpu/schedulers.py``): a re-export of
:func:`chemprop_tpu_torch.train.schedulers.build_noam_like_schedule`, a
``step -> rate`` function over the trainer's ``noam_lr``."""

from chemprop_tpu_torch.train.schedulers import build_noam_like_schedule

# the reference's name
build_NoamLike_LRSched = build_noam_like_schedule

__all__ = ["build_NoamLike_LRSched", "build_noam_like_schedule"]
