"""The training runtime (cf. ``chemprop_tpu/train/trainer.py``): an eager
training step (masked loss -> backward -> clipping -> Adam at the Noam-like
rate) and a thin epoch loop, with the JAX package's numerics:

* the loss is the criterion over the finite targets, weighted per sample
  and divided by the number of finite targets;
* Adam is ``optax.adam``: b1 0.9, b2 0.999, eps 1e-8 added outside the root,
  both moments bias-corrected, and the rate read at the number of updates
  made before this one;
* clipping is optax's ``clip_by_global_norm``: ``g * max_norm / |g|`` only
  when ``|g| > max_norm``;
* randomness is an explicit ``torch.Generator`` made from ``seed``; the
  global generator is not used.

The step launches no atomics and no host synchronisation: losses stay on the
device until an epoch ends. Not ported yet: early stopping and best-epoch
tracking, validation metrics, checkpoints and resuming, tensorboard and
profiler output, frozen parameters, chained steps, meshes and Monte-Carlo
dropout."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from chemprop_tpu_torch.data.collate import TrainingBatch
from chemprop_tpu_torch.data.dataloader import DataLoader
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.train.schedulers import noam_lr
from chemprop_tpu_torch.utils.device import resolve_device, use_full_float32

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainState:
    """The trained model's parameters and batch-norm statistics are the
    module's own tensors (``params``/``batch_stats`` name them); ``mu`` and
    ``nu`` are Adam's moments in the order of ``params``."""

    params: dict[str, torch.nn.Parameter]
    batch_stats: dict[str, torch.Tensor]
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    step: int = 0


def _restore_order(preds: np.ndarray, loader) -> np.ndarray:
    order = loader.emitted_order() if hasattr(loader, "emitted_order") else None
    if order is None or len(order) != len(preds):
        return preds
    return preds[np.argsort(order, kind="stable")]


@dataclass
class Trainer:
    model: MPNN
    max_epochs: int = 50
    warmup_epochs: int = 2
    init_lr: float = 1e-4
    max_lr: float = 1e-3
    final_lr: float = 1e-4
    grad_clip: float | None = None
    seed: int = 0
    param_init: str = "lecun"
    device: str | torch.device | None = None

    state: TrainState | None = None
    history: list[dict] = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)  # raises where there is no GPU
        self.compute_dtype = self.model.message_passing.compute_dtype
        if self.compute_dtype == torch.float32:
            use_full_float32()

    # ------------------------------------------------------------------ setup
    def init_state(self, batch: TrainingBatch | None = None, steps_per_epoch: int = 1) -> TrainState:
        """Initialise the parameters from ``seed`` with ``param_init``, reset
        the batch-norm statistics, move the model to the device and make the
        optimizer's state. ``batch`` is accepted for the JAX signature's sake:
        the port's parameter shapes do not depend on it."""
        gen = torch.Generator().manual_seed(self.seed)
        init_parameters(self.model, self.param_init, gen)
        bn = self.model.bn
        if bn is not None:
            with torch.no_grad():
                bn.weight.fill_(1.0)
                bn.bias.zero_()
                bn.running_mean.zero_()
                bn.running_var.fill_(1.0)
        self.model.to(self.device)
        self._sched_args = (
            self.warmup_epochs * steps_per_epoch,
            max(1, (self.max_epochs - self.warmup_epochs) * steps_per_epoch),
            self.init_lr, self.max_lr, self.final_lr,
        )
        params = dict(self.model.named_parameters())
        stats = dict(self.model.bn.named_buffers(prefix="bn")) if bn is not None else {}
        self.state = TrainState(
            params=params,
            batch_stats=stats,
            mu=[torch.zeros_like(p) for p in params.values()],
            nu=[torch.zeros_like(p) for p in params.values()],
        )
        return self.state

    # ------------------------------------------------------------------ steps
    def loss(self, batch: TrainingBatch) -> torch.Tensor:
        """The training criterion on one batch (on the trainer's device)."""
        preds = self.model.train_step_preds(batch.bmg, is_training=True)
        mask = torch.isfinite(batch.Y)
        targets = torch.nan_to_num(batch.Y)
        return self.model.criterion(preds, targets, mask, batch.w[:, 0])

    def train_step(self, batch: TrainingBatch) -> torch.Tensor:
        """One update on ``batch``; returns the loss, still on the device."""
        st = self.state
        params = list(st.params.values())
        loss = self.loss(batch.to(self.device))
        grads = list(torch.autograd.grad(loss, params))
        if self.grad_clip:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.where(norm > self.grad_clip, self.grad_clip / norm, torch.ones_like(norm))
            torch._foreach_mul_(grads, scale)
        lr = noam_lr(st.step, *self._sched_args)
        t = st.step + 1
        with torch.no_grad():
            torch._foreach_mul_(st.mu, ADAM_B1)
            torch._foreach_add_(st.mu, grads, alpha=1 - ADAM_B1)
            torch._foreach_mul_(st.nu, ADAM_B2)
            torch._foreach_addcmul_(st.nu, grads, grads, value=1 - ADAM_B2)
            denom = torch._foreach_div(st.nu, 1 - ADAM_B2**t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            update = torch._foreach_div(st.mu, 1 - ADAM_B1**t)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(params, update, alpha=-lr)
        st.step = t
        return loss.detach()

    # ------------------------------------------------------------------- fit
    def fit(self, train_loader: DataLoader, val_loader: DataLoader | None = None) -> TrainState:
        steps_per_epoch = len(train_loader)
        if self.state is None:
            self.init_state(None, steps_per_epoch)
        first_epoch = len(self.history)
        for epoch in range(first_epoch, self.max_epochs):
            t0 = time.time()
            losses = [self.train_step(batch) for batch in train_loader]
            # one device -> host fetch per epoch
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            record = {
                "epoch": epoch,
                "train_loss": train_loss,
                "time_s": time.time() - t0,
                "lr": noam_lr(self.state.step, *self._sched_args),
            }
            if val_loader is not None:
                record["val_loss"] = self.evaluate(val_loader)
            self.history.append(record)
        return self.state

    @torch.inference_mode()
    def evaluate(self, loader: DataLoader) -> float:
        """The criterion over ``loader`` with the running statistics: the sum
        of the weighted losses over the number of finite targets."""
        criterion = self.model.criterion
        total = torch.zeros((), device=self.device)
        n = torch.zeros((), device=self.device)
        for host in loader:
            batch = host.to(self.device)
            preds = self.model.train_step_preds(batch.bmg, is_training=False)
            mask = torch.isfinite(batch.Y)
            k = mask.sum()
            total += criterion(preds, torch.nan_to_num(batch.Y), mask, batch.w[:, 0]) * k.clamp_min(1)
            n += k
        return float(total / n.clamp_min(1))

    # --------------------------------------------------------------- predict
    @torch.inference_mode()
    def predict(self, loader: DataLoader, use_batch_statistics: bool = False) -> np.ndarray:
        """Predictions over ``loader`` in dataset order, padding rows cut.
        ``use_batch_statistics`` normalises each batch with its own moments
        (the model as training leaves it) and leaves the output unscaled; the
        running statistics are not touched either way."""
        if self.state is None:
            raise RuntimeError("fit or init_state first")
        chunks = [
            (self.model(host.bmg.to(self.device), is_training=use_batch_statistics), host.pad_mask)
            for host in loader
        ]
        preds = np.concatenate([p.float().cpu().numpy()[m] for p, m in chunks], axis=0)
        return _restore_order(preds, loader)
