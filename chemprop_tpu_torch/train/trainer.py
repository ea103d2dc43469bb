"""The training runtime (cf. ``chemprop_tpu/train/trainer.py``): an eager
training step (masked loss -> backward -> clipping -> Adam at the Noam-like
rate) and a thin epoch loop, with the JAX package's numerics:

* the loss is the model's criterion over the finite targets, weighted per
  sample, with the batch's ``lt_mask`` and ``gt_mask`` (false where the
  batch has none);
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

Each epoch records ``epoch``, ``train_loss``, ``time_s``, ``edges_per_s``
(the real edges of the epoch's batches, of every component of a
multicomponent batch, counted on the host, over ``time_s``) and ``lr``, the JAX trainer's keys. With a validation loader it
also records ``val_loss`` (the criterion's streaming state over every batch,
on the criterion-space predictions) and, for each of ``val_metrics``,
``val_<name>`` on ``val_step_preds`` over the real rows (a multi-target
head's point prediction, channel 0), a collected metric from the gathered
arrays; a metric that fails records NaN and the fit goes on. ``checkpoint_dir`` receives ``best.ckpt``
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
around the clipped Adam does.

``log_every`` logs every ``log_every``-th epoch's record; ``tensorboard_dir``
receives each epoch's record as scalar events (``utils.tbevents``, the JAX
package's bytes), after its validation; ``profile_dir`` receives a Chrome
trace of ``torch.profiler`` over ``profile_steps`` steps of the first epoch
of a fit, from its second step on (the first builds the kernels), as the JAX
trainer traces with ``jax.profiler`` after its compile step.

``steps_per_dispatch`` is the JAX trainer's field, read as its ``fit`` reads
it (``max(1, int(...))``, so a value it refuses raises). There it chains that
many steps into one ``lax.scan`` dispatch; the port issues every step
eagerly whatever the value, so a fit with it trains the same steps in the
same order, to the same bits, as one without it. Chaining the steps into
one launch (a CUDA graph of the step) is a speed change of its own
(``ROADMAP.md`` section 1 item 1.4).

``fit`` moves each training batch to the device ahead of its step, as the
JAX trainer's ``_device_prefetch`` does (depth 2: batches k+1 and k+2 are
copied before batch k's step is issued; :class:`DevicePrefetch`). On CUDA a
host batch is pinned and copied on a stream of its own; the step's stream
waits for the copy on the device, not the host, so that the loader's collate
(its own thread), the pinning and the copies overlap the steps before. On
the CPU the batch is used as it is. Validation and ``predict`` move each
batch when they reach it, as in the JAX package.

``mesh`` (a ``parallel.sharding.Mesh``, one process per GPU; ``sharded`` is
accepted for the JAX signature's sake) makes every step the explicit per-rank
step of ``parallel/shard_train.py``: each rank trains on its whole-graph shard
of each batch (a loader with ``n_shards`` yields it; a plain batch is cut on
the host with ``partition_shards``), with the criterion's state, the
gradients and the batch-norm moments summed over the group. The JAX
package's ``mesh`` without ``sharded`` is GSPMD, which has no PyTorch
counterpart; both modes take this step, which the JAX package documents as
numerically identical to single-device training. The parameters are rank
0's (broadcast at ``init_state``); the dropout generator is the rank's
(``shard_train.rank_generator``). Validation sums the criterion's state and
gathers the predictions in shard order; ``predict`` gathers every rank's
rows into the loader's order on every rank. Only rank 0 writes checkpoints,
TensorBoard events and logs; the others wait at a barrier. Not ported yet:
chained steps."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from chemprop_tpu_torch.data.collate import Shard, TrainingBatch
from chemprop_tpu_torch.data.dataloader import DataLoader
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.models.load import jax_path
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.nn.batchnorm import BatchNorm
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.nn.metrics import ChempropMetric
from chemprop_tpu_torch.train.schedulers import noam_lr
from chemprop_tpu_torch.utils.device import resolve_device, use_full_float32
from chemprop_tpu_torch.utils.tbevents import ScalarEventWriter

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# the key of the dropout generator's state in a last.ckpt
RNG_KEY = "torch_rng"

logger = logging.getLogger(__name__)


def jax_key(name: str) -> str:
    """The path string of the port's parameter ``name`` in the JAX package's
    parameter tree, the argument of ``Trainer.freeze``."""
    return "/".join(jax_path(name)[1])


def adam_update(params: list[torch.Tensor], grads: list[torch.Tensor], mu: list[torch.Tensor],
                nu: list[torch.Tensor], step: int, lr: float) -> None:
    """One Adam update in place (``optax.adam``'s numbers): ``step`` is the
    number of updates made before this one."""
    t = step + 1
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
    # the message passing's masks of an edge-partitioned step, one per rank
    shard_rng: torch.Generator | None = None


def _targets(batch: TrainingBatch) -> tuple[torch.Tensor, ...]:
    """``(mask, targets, lt_mask, gt_mask)`` of a batch: the finite targets,
    the targets with 0 for the others, and the bounds (false where the batch
    has none)."""
    mask = torch.isfinite(batch.Y)
    lt = torch.zeros_like(mask) if batch.lt_mask is None else batch.lt_mask
    gt = torch.zeros_like(mask) if batch.gt_mask is None else batch.gt_mask
    return mask, torch.nan_to_num(batch.Y), lt, gt


class DevicePrefetch:
    """``feed(pairs)`` iterates ``(tag, host batch)`` pairs as ``(tag, device
    batch)``, each batch's copy to ``device`` issued ``depth`` batches before
    it is yielded (cf. ``_device_prefetch`` of
    ``chemprop_tpu/train/trainer.py``). On CUDA each host batch's tensors are
    pinned and copied on a copy stream, and an event is recorded after the
    copies; a yielded batch's tensors are ready on the current stream, which
    waits for that event on the device, and are recorded as used by it, so
    that the allocator does not hand their memory to a later copy while a
    step still reads it. A pinned source is held until its copy's event has
    completed (:meth:`release`). The tile tables are checked on the host and
    marked as they move (``BatchMolGraph.to``), so no kernel reads one back.
    On the CPU a batch is moved with ``to`` and nothing is pinned."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device, self.depth = device, depth
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._held: deque = deque()  # (event, pinned batch) of the copies issued

    def _put(self, host):
        if self._stream is None:
            return host.to(self.device), None
        self.release()
        pinned = pytree.tree_map_only(torch.Tensor, torch.Tensor.pin_memory, host)
        with torch.cuda.stream(self._stream):
            batch = pinned.to(self.device)
        copied = torch.cuda.Event()
        copied.record(self._stream)
        self._held.append((copied, pinned))
        return batch, copied

    def _ready(self, batch, copied):
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in pytree.tree_leaves(batch):
                if isinstance(t, torch.Tensor):
                    t.record_stream(stream)
        return batch

    def feed(self, pairs):
        issued: deque = deque()
        for tag, host in pairs:
            issued.append((tag, *self._put(host)))
            if len(issued) > self.depth:
                tag, batch, copied = issued.popleft()
                yield tag, self._ready(batch, copied)
        while issued:
            tag, batch, copied = issued.popleft()
            yield tag, self._ready(batch, copied)

    def release(self) -> None:
        """Drop the pinned sources whose copies have completed (an event's
        query does not wait)."""
        while self._held and self._held[0][0].query():
            self._held.popleft()


def _real_edges(batch) -> int:
    """The real edges of a host batch, of every component (a shard's own)."""
    host = batch.batch if isinstance(batch, Shard) else batch
    return sum(int(g.edge_mask.sum()) for g in host.graphs)


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
    # log every log_every-th epoch's record (0: none)
    log_every: int = 0
    # each epoch's record as TensorBoard scalar events
    tensorboard_dir: str | Path | None = None
    # a Chrome trace of steps 1 .. profile_steps of the first epoch of a fit
    profile_dir: str | Path | None = None
    profile_steps: int = 5
    # a parallel.sharding.Mesh: every step is the per-rank sharded step
    mesh: Any = None
    sharded: bool = False
    # the JAX trainer's training steps chained per device dispatch, read as
    # it reads them; the port issues every step eagerly whatever the value,
    # so a fit trains the same steps in the same order as without it
    # (ROADMAP.md section 3, steps_per_dispatch)
    steps_per_dispatch: int | None = None

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
        if self.sharded and self.mesh is None:
            raise ValueError("sharded=True requires a mesh")
        if self.mesh is not None and self.device is None:
            self.device = self.mesh.device
        self.device = resolve_device(self.device)  # raises where there is no GPU
        self.compute_dtype = self.model.message_passing.compute_dtype
        if self.compute_dtype == torch.float32:
            use_full_float32()

    # ------------------------------------------------------------------ setup
    def init_state(self, batch: TrainingBatch | None = None, steps_per_epoch: int = 1,
                   keep_parameters: bool = False) -> TrainState:
        """Initialise the parameters from ``seed`` with ``param_init``, reset
        the batch-norm statistics, move the model to the device and make the
        optimizer's state. With ``keep_parameters`` the model's own
        parameters and statistics (a loaded checkpoint's) are the state's, as
        the JAX trainer takes ``variables``. ``batch`` is accepted for the JAX
        signature's sake: the port's parameter shapes do not depend on it."""
        if not keep_parameters:
            init_parameters(self.model, self.param_init, torch.Generator().manual_seed(self.seed))
            with torch.no_grad():
                for bn in self.model.modules():
                    if isinstance(bn, BatchNorm):
                        bn.weight.fill_(1.0)
                        bn.bias.zero_()
                        bn.running_mean.zero_()
                        bn.running_var.fill_(1.0)
        self.model.to(self.device)
        if self.mesh is not None:
            from chemprop_tpu_torch.parallel.sharding import replicate

            # sync batch-norm moments across the group, and rank 0's state
            for bn in self.model.modules():
                if isinstance(bn, BatchNorm):
                    bn.mesh = self.mesh
            replicate(list(self.model.state_dict().values()), self.mesh)
        self._sched_args = (
            self.warmup_epochs * steps_per_epoch,
            max(1, (self.max_epochs - self.warmup_epochs) * steps_per_epoch),
            self.init_lr, self.max_lr, self.final_lr,
        )
        params = dict(self.model.named_parameters())
        # the batch norms' running statistics: buffers the JAX tree holds
        stats = {k: v for k, v in self.model.named_buffers()
                 if (jax_path(k) or ("",))[0] == "batch_stats"}
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
        if self.mesh is not None:
            from chemprop_tpu_torch.parallel.shard_train import rank_generator

            return rank_generator(seed, self.mesh.rank, self.device)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _writes(self) -> bool:
        """Whether this process writes the fit's files: rank 0 of a mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.group)

    # ------------------------------------------------------------------ steps
    def loss(self, batch: TrainingBatch) -> torch.Tensor:
        """The training criterion on one batch (on the trainer's device)."""
        preds = self.model.train_step_preds(batch.bmg, batch.V_d, batch.X_d, is_training=True,
                                            generator=self.state.rng)
        mask, targets, lt, gt = _targets(batch)
        return self.model.criterion(preds, targets, mask, batch.w[:, 0], lt, gt)

    def train_step(self, batch: TrainingBatch) -> torch.Tensor:
        """One update on ``batch``; returns the loss, still on the device. The
        frozen parameters take no part: no gradient, no moment, no update.
        ``batch`` lies on the host, or on the device where ``fit``'s
        :class:`DevicePrefetch` moved it: ``to`` then returns its tensors as
        they are, and its tile tables keep their host check's mark, so it is
        neither copied nor checked again."""
        st = self.state
        every = list(st.params.values())
        params = [every[i] for i in self._trained]
        mu, nu = [st.mu[i] for i in self._trained], [st.nu[i] for i in self._trained]
        if self.mesh is not None:
            from chemprop_tpu_torch.parallel.shard_train import local_shard, sharded_grads

            local = local_shard(batch, self.mesh).to(self.device)
            loss, grads = sharded_grads(self.model, local, params, self.mesh, st.rng)
        else:
            loss = self.loss(batch.to(self.device))
            grads = list(torch.autograd.grad(loss, params))
        if self.grad_clip:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.where(norm > self.grad_clip, self.grad_clip / norm, torch.ones_like(norm))
            torch._foreach_mul_(grads, scale)
        adam_update(params, grads, mu, nu, st.step, noam_lr(st.step, *self._sched_args))
        st.step += 1
        return loss.detach()

    # ------------------------------------------------------------------- fit
    def _shard(self, batch):
        """The host batch ``fit`` moves to the device: on a mesh the rank's
        ``Shard`` (cut on the host), else ``batch``."""
        if self.mesh is None:
            return batch
        from chemprop_tpu_torch.parallel.shard_train import as_shard

        return as_shard(batch, self.mesh)

    def _variables(self) -> dict[str, torch.Tensor]:
        """The state's parameters and batch-norm statistics by name."""
        return {**self.state.params, **self.state.batch_stats}

    def fit(self, train_loader: DataLoader, val_loader: DataLoader | None = None) -> TrainState:
        steps_per_epoch = len(train_loader)
        if not (self.sharded or self.mesh is not None or self.profile_dir is not None
                or self.steps_per_dispatch is None):
            max(1, int(self.steps_per_dispatch))  # a value the JAX trainer's fit refuses raises
        if self.state is None:
            self.init_state(None, steps_per_epoch)
        self.best_variables, self.best_epoch = None, -1
        tb = None
        if self.tensorboard_dir is not None and self._writes():
            tb = ScalarEventWriter(self.tensorboard_dir)
        try:
            self._fit_epochs(train_loader, val_loader, tb)
        finally:
            if tb is not None:
                tb.close()
        if self.best_variables is None:
            self.best_variables = {k: v.detach().clone() for k, v in self._variables().items()}
        return self.state

    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def _stop_profiler(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        path = Path(self.profile_dir)
        path.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path / "trace.json"))
        logger.info(f"wrote a torch.profiler trace to {path / 'trace.json'}")

    def _fit_epochs(self, train_loader, val_loader, tb: ScalarEventWriter | None) -> None:
        best_score = np.inf if self.mode == "min" else -np.inf
        since_best = 0
        prefetch = DevicePrefetch(self.device)
        for epoch in range(self.start_epoch, self.max_epochs):
            t0 = time.time()
            losses, n_edges = [], 0
            prof = None
            batches = prefetch.feed((_real_edges(host), self._shard(host)) for host in train_loader)
            for step_i, (edges, batch) in enumerate(batches):
                if self.profile_dir is not None and epoch == self.start_epoch and step_i == 1:
                    prof = self._profiler()
                    prof.start()
                n_edges += edges
                losses.append(self.train_step(batch))
                if prof is not None and step_i >= self.profile_steps:
                    self._stop_profiler(prof)
                    prof = None
            if prof is not None:
                self._stop_profiler(prof)
            # one device -> host fetch per epoch; every copy has completed then
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            prefetch.release()
            dt = time.time() - t0
            record = {
                "epoch": epoch,
                "train_loss": train_loss,
                "time_s": dt,
                "edges_per_s": n_edges / max(dt, 1e-9),
                "lr": noam_lr(self.state.step, *self._sched_args),
            }
            if val_loader is not None:
                record.update(self._validate(val_loader, bool(self.val_metrics)))
            self.history.append(record)
            if tb is not None:
                tb.add_scalars(record, step=epoch)
                tb.flush()
            if self.log_every and epoch % self.log_every == 0 and self._writes():
                logger.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                                     for k, v in record.items()))
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
                logger.info(f"early stopping at epoch {epoch} (best epoch {self.best_epoch})")
                break

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
        """The criterion over ``loader`` with the running statistics, from its
        streaming state over every batch."""
        return self._validate(loader, False)["val_loss"]

    @torch.inference_mode()
    def _validate(self, loader: DataLoader, metrics: bool) -> dict[str, float]:
        """``val_loss`` and, with ``metrics``, each of ``val_metrics`` as
        ``val_<name>`` over the real rows of ``loader`` (the JAX trainer's
        ``_run_validation``): the metrics take ``val_step_preds`` (channel 0
        of a multi-target head's), every row's weight 1, the finite targets
        as the mask and no bounds; a collected metric takes the arrays."""
        model, criterion = self.model, self.model.criterion
        state = criterion.init_state()
        chunks = []
        if self.mesh is not None:
            from chemprop_tpu_torch.parallel.shard_train import local_shard, sum_state
        for host in loader:
            if self.mesh is not None:
                host = local_shard(host, self.mesh)
            batch = host.to(self.device)
            # one fingerprint serves the criterion's and the metrics' heads
            Z = model.fingerprint(batch.bmg, batch.V_d, batch.X_d, False)
            preds = model.predictor.train_step(Z, False)
            mask, targets, lt, gt = _targets(batch)
            state = criterion.update_state(state, preds, targets, mask, batch.w[:, 0], lt, gt)
            if metrics:
                real = host.pad_mask
                val_preds = model.predictor.val_step(Z).float().cpu()
                chunks.append((val_preds[real], host.Y[real]))
        if self.mesh is not None:
            # the global batch's state; every rank's rows, in shard order
            state = sum_state(state, self.mesh)
            if metrics:
                chunks = self._gather(chunks)
        record = {"val_loss": float(criterion.compute(state))}
        if chunks:
            preds, Y = (torch.cat(parts) for parts in zip(*chunks))
            if preds.ndim == 3 and model.n_targets > 1:  # the point prediction
                preds = preds[..., 0]
            mask, targets = torch.isfinite(Y), torch.nan_to_num(Y)
            no_bounds = torch.zeros_like(mask)
            for name, metric in self.val_metrics.items():
                try:
                    if metric.needs_collection:
                        value = metric.compute_from_arrays(preds.numpy(), Y.numpy(), mask.numpy())
                    else:
                        value = metric.compute(metric.update_state(
                            metric.init_state(), preds, targets, mask, torch.ones(len(Y)),
                            no_bounds, no_bounds))
                    value = float(value)
                except Exception as e:  # a failed metric must not stop the fit
                    logger.warning(f"val metric {name} failed: {e}")
                    value = float("nan")
                record[f"val_{name}"] = value
        return record

    def _gather(self, chunks: list) -> list:
        """Every rank's list of chunks, rank by rank."""
        if self.mesh.size == 1:
            return chunks
        import torch.distributed as dist

        parts = [None] * self.mesh.size
        dist.all_gather_object(parts, chunks, group=self.mesh.group)
        return [c for part in parts for c in part]

    # ----------------------------------------------------------- checkpoints
    def _save_checkpoint(self, tag: str, next_epoch: int | None = None) -> None:
        if self._writes():
            self._write_checkpoint(tag, next_epoch)
        self._barrier()

    def _write_checkpoint(self, tag: str, next_epoch: int | None = None) -> None:
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
        """``[n, n_tasks(, k)]`` predictions over ``loader`` in dataset order,
        padding rows cut, from ``best_variables`` after a fit.
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
        if self.mesh is not None:
            from chemprop_tpu_torch.parallel.shard_train import as_shard, gather_rows

            parts = []
            for host in loader:
                shard = as_shard(host, self.mesh)
                n = len(shard.groups[shard.index])
                parts.append(gather_rows(apply(shard.batch.to(self.device))[:n], shard, self.mesh))
            return _restore_order(np.concatenate(parts, axis=0), loader)
        chunks = [(apply(host.to(self.device)), host.pad_mask) for host in loader]
        preds = np.concatenate([p.float().cpu().numpy()[m] for p, m in chunks], axis=0)
        return _restore_order(preds, loader)

    @torch.inference_mode()
    def predict_mc_dropout(
        self, loader: DataLoader, sampling_size: int = 10, seed: int = 0
    ) -> np.ndarray:
        """``sampling_size`` stochastic forward passes with the dropout layers
        on and everything else as in inference (Monte-Carlo dropout):
        ``[sampling_size, n, n_tasks(, k)]`` inference-space predictions in dataset
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
