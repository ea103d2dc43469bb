"""The Noam-like learning-rate schedule (cf.
``chemprop_tpu/train/schedulers.py``): linear warm-up ``init_lr -> max_lr``
over ``warmup_steps``, exponential decay ``max_lr -> final_lr`` over
``cooldown_steps``, then ``final_lr``."""

from __future__ import annotations


def noam_lr(
    step: int,
    warmup_steps: int,
    cooldown_steps: int,
    init_lr: float,
    max_lr: float,
    final_lr: float,
) -> float:
    """The rate at ``step``, the number of updates made so far (the trainer
    reads it before an update, as optax reads its schedule)."""
    warmup_steps = max(1, int(warmup_steps))
    cooldown_steps = max(1, int(cooldown_steps))
    if step < warmup_steps:
        return init_lr + step * (max_lr - init_lr) / warmup_steps
    if step < warmup_steps + cooldown_steps:
        gamma = (step - warmup_steps) / cooldown_steps
        return max_lr * (final_lr / max_lr) ** gamma
    return final_lr
