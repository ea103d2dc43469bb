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
* randomness is explicit ``torch.Generator``s made from ``seed``: one on the
  CPU for the initial parameters, one on the trainer's device for the
  dropout masks of the training steps (``TrainState.rng``); the global
  generator is not used. Evaluation and ``predict`` run with dropout off.

The step launches no atomics and no host synchronisation: losses stay on the
device until an epoch ends. ``fit`` tracks the best epoch by the JAX
package's rule: the score is the epoch's ``monitor`` (``val_loss`` with a
validation loader) or else its train loss; an epoch improves on the best by
more than ``min_delta`` in the direction of ``mode``; with ``patience`` the
fit stops once more than ``patience`` epochs in a row have not improved.
``best_variables`` holds a copy on the device of the best epoch's
parameters and batch-norm statistics (the last state when no epoch
improved), and ``predict`` and ``predict_mc_dropout`` compute with it, as in
the JAX package; ``evaluate`` computes with the current state, as the JAX
validation does. Every fit runs epochs ``start_epoch .. max_epochs - 1``
from the state it finds, as the JAX trainer's loop does.

With a validation loader each epoch records ``val_loss`` (the criterion on
the criterion-space predictions) and, for each of ``val_metrics``,
``val_<name>`` on ``val_step_preds`` over the real rows; a metric that fails
records NaN and the fit goes on. ``checkpoint_dir`` receives ``best.ckpt``
whenever an epoch improves and ``last.ckpt`` after every epoch, in the JAX
package's ``CPTPU001`` format (``models.serialize``): ``last.ckpt`` holds the
whole training state (Adam's moments and count in optax's layout, the step,
the next epoch, and the dropout generator's state under ``torch_rng``), from
which :meth:`Trainer.resume_from` continues as if never interrupted. JAX's
dropout key has no ``torch.Generator`` counterpart: resuming from a JAX file
seeds the generator from ``seed``. ``freeze`` takes a parameter's path in the
JAX package's tree (``"message_passing/W_i/kernel"``): the parameters it
names get no update and keep zero moments, and the clipping norm counts only
the others' gradients, as optax's ``multi_transform`` with ``set_to_zero``
around the clipped Adam does. Not ported yet: tensorboard and profiler
output, chained steps and meshes."""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from chemprop_tpu_torch.data.collate import TrainingBatch
from chemprop_tpu_torch.data.dataloader import DataLoader
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.models.load import jax_path
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.nn.metrics import ChempropMetric
from chemprop_tpu_torch.train.schedulers import noam_lr
from chemprop_tpu_torch.utils.device import resolve_device, use_full_float32

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# the key of the dropout generator's state in a last.ckpt
RNG_KEY = "torch_rng"

logger = logging.getLogger(__name__)


def jax_key(name: str) -> str:
    """The path string of the port's parameter ``name`` in the JAX package's
    parameter tree, the argument of ``Trainer.freeze``."""
    return "/".join(jax_path(name)[1])


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
    rng: torch.Generator | None = None  # the dropout masks of the training steps


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
    patience: int | None = None
    monitor: str = "val_loss"
    mode: str = "min"
    min_delta: float = 0.0
    checkpoint_dir: str | Path | None = None
    seed: int = 0
    # named validation metrics, recorded each epoch as val_<name>
    val_metrics: dict[str, ChempropMetric] = field(default_factory=dict)
    # a predicate on a parameter's JAX path: the parameters it names are frozen
    freeze: Callable[[str], bool] | None = None
    param_init: str = "lecun"
    device: str | torch.device | None = None

    # the first epoch of every fit, as in the JAX trainer: a second fit trains
    # max_epochs - start_epoch more epochs from the state the first one left
    start_epoch: int = 0
    state: TrainState | None = None
    history: list[dict] = field(default_factory=list)
    # the best epoch's parameters and batch-norm statistics by name, on the
    # device, and that epoch's index (-1: none improved)
    best_variables: dict[str, torch.Tensor] | None = None
    best_epoch: int = -1

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {self.mode!r}")
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
        self.best_variables, self.best_epoch = None, -1
        frozen = {n for n in params if self.freeze is not None and self.freeze(jax_key(n))}
        self._frozen = frozen
        self._trained = [i for i, n in enumerate(params) if n not in frozen]
        self.state = TrainState(
            params=params,
            batch_stats=stats,
            mu=[torch.zeros_like(p) for p in params.values()],
            nu=[torch.zeros_like(p) for p in params.values()],
            rng=self._generator(self.seed),
        )
        return self.state

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------ steps
    def loss(self, batch: TrainingBatch) -> torch.Tensor:
        """The training criterion on one batch (on the trainer's device)."""
        preds = self.model.train_step_preds(batch.bmg, batch.V_d, batch.X_d, is_training=True,
                                            generator=self.state.rng)
        mask = torch.isfinite(batch.Y)
        targets = torch.nan_to_num(batch.Y)
        return self.model.criterion(preds, targets, mask, batch.w[:, 0])

    def train_step(self, batch: TrainingBatch) -> torch.Tensor:
        """One update on ``batch``; returns the loss, still on the device. The
        frozen parameters take no part: no gradient, no moment, no update."""
        st = self.state
        every = list(st.params.values())
        params = [every[i] for i in self._trained]
        mu, nu = [st.mu[i] for i in self._trained], [st.nu[i] for i in self._trained]
        loss = self.loss(batch.to(self.device))
        grads = list(torch.autograd.grad(loss, params))
        if self.grad_clip:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.where(norm > self.grad_clip, self.grad_clip / norm, torch.ones_like(norm))
            torch._foreach_mul_(grads, scale)
        lr = noam_lr(st.step, *self._sched_args)
        t = st.step + 1
        with torch.no_grad():
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
            denom = torch._foreach_div(nu, 1 - ADAM_B2**t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            update = torch._foreach_div(mu, 1 - ADAM_B1**t)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(params, update, alpha=-lr)
        st.step = t
        return loss.detach()

    # ------------------------------------------------------------------- fit
    def _variables(self) -> dict[str, torch.Tensor]:
        """The state's parameters and batch-norm statistics by name."""
        return {**self.state.params, **self.state.batch_stats}

    def fit(self, train_loader: DataLoader, val_loader: DataLoader | None = None) -> TrainState:
        steps_per_epoch = len(train_loader)
        if self.state is None:
            self.init_state(None, steps_per_epoch)
        best_score = np.inf if self.mode == "min" else -np.inf
        self.best_variables, self.best_epoch = None, -1
        since_best = 0
        for epoch in range(self.start_epoch, self.max_epochs):
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
                record.update(self._validate(val_loader, bool(self.val_metrics)))
            self.history.append(record)
            score = record.get(self.monitor, train_loss)
            if (score < best_score - self.min_delta if self.mode == "min"
                    else score > best_score + self.min_delta):
                best_score, self.best_epoch, since_best = score, epoch, 0
                # a copy on the device: no host synchronisation
                with torch.no_grad():
                    self.best_variables = {k: v.detach().clone() for k, v in self._variables().items()}
                if self.checkpoint_dir is not None:
                    self._save_checkpoint("best")
            else:
                since_best += 1
            if self.checkpoint_dir is not None:
                self._save_checkpoint("last", epoch + 1)
            if self.patience is not None and since_best > self.patience:
                break
        if self.best_variables is None:
            self.best_variables = {k: v.detach().clone() for k, v in self._variables().items()}
        return self.state

    @contextlib.contextmanager
    def _best(self):
        """The model computes with ``best_variables`` inside the block (the
        state's own tensors are swapped back after it)."""
        best = self.best_variables
        if best is None:
            yield
            return
        live = self._variables()
        saved = {k: v.data for k, v in live.items()}
        try:
            for k, v in live.items():
                v.data = best[k]
            yield
        finally:
            for k, v in live.items():
                v.data = saved[k]

    def evaluate(self, loader: DataLoader) -> float:
        """The criterion over ``loader`` with the running statistics: the sum
        of the weighted losses over the number of finite targets."""
        return self._validate(loader, False)["val_loss"]

    @torch.inference_mode()
    def _validate(self, loader: DataLoader, metrics: bool) -> dict[str, float]:
        """``val_loss`` and, with ``metrics``, each of ``val_metrics`` as
        ``val_<name>`` over the real rows of ``loader`` (the JAX trainer's
        ``_run_validation``): the metrics take ``val_step_preds``, every row's
        weight 1 and the finite targets as the mask."""
        model, criterion = self.model, self.model.criterion
        total = torch.zeros((), device=self.device)
        n = torch.zeros((), device=self.device)
        chunks = []
        for host in loader:
            batch = host.to(self.device)
            # one fingerprint serves the criterion's and the metrics' heads
            Z = model.fingerprint(batch.bmg, batch.V_d, batch.X_d, False)
            preds = model.predictor.train_step(Z, False)
            mask = torch.isfinite(batch.Y)
            k = mask.sum()
            total += criterion(preds, torch.nan_to_num(batch.Y), mask, batch.w[:, 0]) * k.clamp_min(1)
            n += k
            if metrics:
                real = host.pad_mask
                val_preds = model.predictor.val_step(Z).float().cpu()
                chunks.append((val_preds[real], host.Y[real]))
        record = {"val_loss": float(total / n.clamp_min(1))}
        if chunks:
            preds, Y = (torch.cat(parts) for parts in zip(*chunks))
            mask, targets = torch.isfinite(Y), torch.nan_to_num(Y)
            for name, metric in self.val_metrics.items():
                try:
                    value = float(metric(preds, targets, mask, torch.ones(len(Y))))
                except Exception as e:  # a failed metric must not stop the fit
                    logger.warning(f"val metric {name} failed: {e}")
                    value = float("nan")
                record[f"val_{name}"] = value
        return record

    # ----------------------------------------------------------- checkpoints
    def _save_checkpoint(self, tag: str, next_epoch: int | None = None) -> None:
        """``best.ckpt`` (the best epoch's parameters and statistics) or
        ``last.ckpt`` (the whole training state; ``next_epoch`` is the epoch a
        resumed fit starts at)."""
        best = tag == "best" and self.best_variables is not None
        variables = serialize.to_jax_params(self.best_variables if best else self._variables())
        if tag == "last":
            st = self.state
            names = list(st.params)
            variables["opt_state"] = serialize.jax_opt_state(
                names, st.mu, st.nu, st.step, self._frozen, bool(self.grad_clip))
            variables["step"] = np.array(st.step, dtype=np.int32)
            variables[RNG_KEY] = st.rng.get_state().numpy()
            variables["epoch"] = np.int32(next_epoch)
        serialize.save_checkpoint(Path(self.checkpoint_dir) / f"{tag}.ckpt", self.model, variables)

    def resume_from(
        self, path: str | Path, batch: TrainingBatch | None, steps_per_epoch: int
    ) -> int:
        """Restore the whole training state from a ``last.ckpt`` (the port's
        or the JAX package's) and return the epoch to resume from. The
        parameters, batch-norm statistics, Adam's moments and the step are
        the file's; the dropout generator is the file's where the port wrote
        it, and made from ``seed`` for a JAX file. The file must hold moments
        for exactly the parameters this trainer does not freeze: a file
        written with another ``freeze``, or whose optimizer state does not
        match the model, raises."""
        _, restored = serialize.read_checkpoint(path)
        st = self.init_state(batch, steps_per_epoch)
        serialize.load_variables(self.model, restored)
        names = list(st.params)
        both = serialize.adam_moments(restored["opt_state"], names)
        for moments in both:
            absent = {n for n, m in zip(names, moments) if m is None}
            if absent != self._frozen:
                raise ValueError(
                    f"{path}: Adam's moments do not match this trainer's freeze: none for the "
                    f"trained {sorted(absent - self._frozen)}, some for the frozen "
                    f"{sorted(self._frozen - absent)}")
        with torch.no_grad():
            for dst, moments in zip((st.mu, st.nu), both):
                for t, m in zip(dst, moments):
                    if m is not None:  # a frozen parameter's moments stay zero
                        t.copy_(m)
        st.step = int(restored["step"])
        if RNG_KEY in restored:
            st.rng.set_state(torch.from_numpy(np.array(restored[RNG_KEY], dtype=np.uint8)))
        return int(restored.get("epoch", 0))

    # --------------------------------------------------------------- predict
    @torch.inference_mode()
    def predict(self, loader: DataLoader, use_batch_statistics: bool = False) -> np.ndarray:
        """Predictions over ``loader`` in dataset order, padding rows cut,
        from ``best_variables`` after a fit.
        ``use_batch_statistics`` normalises each batch with its own moments
        (the model as training leaves it) and leaves the output unscaled; the
        running statistics are not touched either way. As in the JAX package
        that mode also turns dropout on, with masks from a fixed seed."""
        if self.state is None:
            raise RuntimeError("fit or init_state first")
        gen = self._generator(0) if use_batch_statistics else None
        with self._best():
            return self._collect(loader, lambda b: self.model(
                b.bmg, b.V_d, b.X_d, is_training=use_batch_statistics, generator=gen))

    def _collect(self, loader: DataLoader, apply) -> np.ndarray:
        chunks = [(apply(host.to(self.device)), host.pad_mask) for host in loader]
        preds = np.concatenate([p.float().cpu().numpy()[m] for p, m in chunks], axis=0)
        return _restore_order(preds, loader)

    @torch.inference_mode()
    def predict_mc_dropout(
        self, loader: DataLoader, sampling_size: int = 10, seed: int = 0
    ) -> np.ndarray:
        """``sampling_size`` stochastic forward passes with the dropout layers
        on and everything else as in inference (Monte-Carlo dropout):
        ``[sampling_size, n, n_tasks]`` inference-space predictions in dataset
        order; the caller takes the mean and the variance over axis 0. The
        masks come from one generator made from ``seed``."""
        if self.state is None:
            raise RuntimeError("fit or init_state first")
        gen = self._generator(seed)
        with self._best():
            return np.stack([
                self._collect(loader,
                              lambda b: self.model.mc_dropout_preds(b.bmg, b.V_d, b.X_d, gen))
                for _ in range(sampling_size)
            ], axis=0)
