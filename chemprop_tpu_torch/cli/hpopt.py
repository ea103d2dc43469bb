"""``hpopt``: a search over the hyperparameters of ``train`` (cf.
``chemprop_tpu/cli/hpopt.py``), each trial a run of the port's ``train``
in this process, on the GPU unless ``--device`` says otherwise.

    python -m chemprop_tpu_torch.cli hpopt -i data.csv -o out --num-trials 10 \\
        [--search-parameter-keywords all] [--search-algorithm random|hyperopt|optuna] \\
        [--scheduler fifo|asha] [--device cpu] [--dtype bfloat16] ...

The flags are ``train``'s and the JAX package's own, the inert Ray knobs
included; the search space, the draws (numpy's, from
``--hyperopt-random-state-seed`` or ``--data-seed``), the tree-structured
Parzen estimator and both schedulers are the JAX package's, so that one seed
gives both packages the same trials. ``random`` draws every trial
independently; ``hyperopt`` and ``optuna`` are the estimator after
``--startup-trials`` random ones; ``asha`` runs every trial on a small epoch
budget (at least ``--raytune-grace-period``) and resumes the best ``1 / eta``
of each rung from its ``last.ckpt`` with ``eta`` times the budget. Each
trial trains one model into ``<out>/trial_<k>`` and scores its best
``val_loss`` (``train_loss`` without a validation set). The output directory
gets ``all_progress.json`` (every trial's config and score, with ASHA's
rung and epochs) and ``best_config.json`` (the best trial's arguments, with
``final_lr`` for the searched ratio), which retrains with
``train --config-path``; the last line printed is the best trial, its score
and its config.

A trial that raises scores ``inf``, as in the JAX package, and its traceback
is logged at warning level. A resumed ASHA trial continues from the epoch
after the last one it ran: the JAX package's ``last.ckpt`` records the
epochs run since its own start instead, so from a trial's second resume on
the two packages may run other epochs (``ROADMAP.md`` §3)."""

from __future__ import annotations

import argparse
import copy
import json
import logging
from pathlib import Path

import numpy as np

from chemprop_tpu_torch.cli.train import add_train_args, refuse_unported
from chemprop_tpu_torch.cli.utils.command import Subcommand
from chemprop_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

SEARCH_SPACE = {
    "depth": ("int", 2, 6),
    "message_hidden_dim": ("int_step", 200, 800, 100),
    "ffn_hidden_dim": ("int_step", 200, 800, 100),
    "ffn_num_layers": ("int", 1, 3),
    "dropout": ("choice", [0.0, 0.0, 0.05, 0.1, 0.2]),
    "max_lr": ("log", 1e-4, 1e-2),
    "final_lr_ratio": ("log", 1e-2, 1.0),
    "warmup_epochs": ("int", 1, 5),
    "batch_size": ("choice", [16, 32, 64, 128]),
    "aggregation": ("choice", ["mean", "sum", "norm"]),
    "activation": ("choice", ["relu", "leakyrelu", "prelu", "tanh", "elu"]),
}
# in the JAX package's order, the default of --search-parameter-keywords
BASIC = ["depth", "ffn_num_layers", "dropout", "message_hidden_dim", "ffn_hidden_dim"]
LEARNING_RATE = {"max_lr", "final_lr_ratio", "warmup_epochs"}


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    add_train_args(parser)
    g = parser.add_argument_group("Hpopt args")
    g.add_argument("--raytune-num-samples", "--num-trials", type=int, default=10,
                   dest="num_trials")
    g.add_argument(
        "--search-algorithm", "--raytune-search-algorithm",
        choices=["random", "hyperopt", "optuna"], default="hyperopt",
        help="random: independent draws; hyperopt and optuna: the sequential tree-structured "
        "Parzen estimator after --startup-trials random draws",
    )
    g.add_argument("--hyperopt-random-state-seed", type=int, default=None)
    g.add_argument("--startup-trials", "--hyperopt-n-initial-points", type=int, default=5,
                   help="the estimator's random trials before it proposes")
    g.add_argument("--search-parameter-keywords", nargs="+", default=list(BASIC),
                   help=f"subset of: {sorted(SEARCH_SPACE)} or 'all', 'basic', 'learning_rate'")
    g.add_argument("--hpopt-save-dir", type=Path, default=None)
    g.add_argument(
        "--scheduler", choices=["fifo", "asha"], default="fifo",
        help="fifo: every trial on the full budget; asha: successive halving, the best "
        "1 / eta of each rung resumed with eta times the budget",
    )
    g.add_argument("--asha-eta", "--raytune-reduction-factor", type=int, default=3,
                   dest="asha_eta", help="ASHA's reduction factor")
    g.add_argument("--raytune-trial-scheduler", choices=["FIFO", "AsyncHyperBand"], default=None,
                   help="the reference's spelling of --scheduler (FIFO: fifo, AsyncHyperBand: "
                   "asha)")
    g.add_argument("--raytune-grace-period", type=int, default=None,
                   help="ASHA: the least epochs a trial runs before it can be halved")
    # the reference's Ray cluster knobs, accepted as the JAX package accepts
    # them and inert: the trials run one after another in this process
    for flag in ("--raytune-num-workers", "--raytune-num-checkpoints-to-keep",
                 "--raytune-max-concurrent-trials", "--raytune-num-cpus", "--raytune-num-gpus"):
        g.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    g.add_argument("--raytune-use-gpu", action="store_true", help=argparse.SUPPRESS)
    g.add_argument("--raytune-temp-dir", default=None, help=argparse.SUPPRESS)
    return parser


def _expand_keywords(keywords: list[str]) -> list[str]:
    out: set[str] = set()
    for kw in keywords:
        if kw == "all":
            out |= set(SEARCH_SPACE)
        elif kw == "basic":
            out |= set(BASIC)
        elif kw == "learning_rate":
            out |= LEARNING_RATE
        elif kw in SEARCH_SPACE:
            out.add(kw)
        else:
            raise ValueError(f"unknown search keyword {kw!r}")
    return sorted(out)


def _sample(rng: np.random.Generator, keys: list[str]) -> dict:
    cfg = {}
    for k in keys:
        spec = SEARCH_SPACE[k]
        kind = spec[0]
        if kind == "int":
            cfg[k] = int(rng.integers(spec[1], spec[2] + 1))
        elif kind == "int_step":
            cfg[k] = int(rng.choice(np.arange(spec[1], spec[2] + 1, spec[3])))
        elif kind == "choice":
            cfg[k] = spec[1][int(rng.integers(len(spec[1])))]
        else:  # log
            cfg[k] = float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
    return cfg


class TPESampler:
    """The sequential tree-structured Parzen estimator of the JAX package
    (Bergstra et al. 2011), the default sampler behind the reference's
    hyperopt and optuna searches: the finite observations split into the best
    ``gamma`` share ("good") and the rest; each dimension draws candidates
    from a kernel density over the good values and keeps the one with the
    largest good-to-bad density ratio (a categorical one draws in proportion
    to the ratio). Deterministic for a given ``rng``."""

    def __init__(self, keys, rng, n_startup=5, gamma=0.25, n_candidates=24):
        self.keys = keys
        self.rng = rng
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.observations: list[tuple[dict, float]] = []

    def observe(self, cfg: dict, score: float) -> None:
        if np.isfinite(score):
            self.observations.append((cfg, score))

    def suggest(self) -> dict:
        if len(self.observations) < self.n_startup:
            return _sample(self.rng, self.keys)
        scores = np.array([s for _, s in self.observations])
        n_good = max(1, int(np.ceil(self.gamma * len(scores))))
        order = np.argsort(scores)
        good = [self.observations[i][0] for i in order[:n_good]]
        bad = [self.observations[i][0] for i in order[n_good:]] or good
        return {k: self._suggest_dim(k, good, bad) for k in self.keys}

    def _suggest_dim(self, key, good, bad):
        spec = SEARCH_SPACE[key]
        kind = spec[0]
        if kind == "choice":
            support = list(dict.fromkeys(spec[1]))
            idx = {v: i for i, v in enumerate(support)}
            ratio = (self._cat_probs([idx[c[key]] for c in good], len(support))
                     / self._cat_probs([idx[c[key]] for c in bad], len(support)))
            return support[int(self.rng.choice(len(support), p=ratio / ratio.sum()))]
        log_scale = kind == "log"
        xform = np.log if log_scale else (lambda x: np.asarray(x, dtype=float))
        lo, hi = xform(spec[1]), xform(spec[2])
        gx = xform([c[key] for c in good])
        bx = xform([c[key] for c in bad])
        sigma = max((hi - lo) / max(len(gx), 1), 1e-6 * (hi - lo) + 1e-12)
        cands = np.clip(gx[self.rng.integers(len(gx), size=self.n_candidates)]
                        + self.rng.normal(0, sigma, self.n_candidates), lo, hi)
        x = float(cands[int(np.argmax(self._kde(cands, gx, sigma) / self._kde(cands, bx, sigma)))])
        if log_scale:
            return float(np.exp(x))
        if kind == "int":
            return int(np.clip(round(x), spec[1], spec[2]))
        step = spec[3]  # int_step: onto the grid
        return int(np.clip(round((x - spec[1]) / step) * step + spec[1], spec[1], spec[2]))

    @staticmethod
    def _cat_probs(idxs, k):
        counts = np.bincount(idxs, minlength=k).astype(float) + 1.0  # Laplace
        return counts / counts.sum()

    @staticmethod
    def _kde(x, data, sigma):
        d = (x[:, None] - data[None, :]) / sigma
        return np.exp(-0.5 * d**2).mean(axis=1) / (sigma * np.sqrt(2 * np.pi)) + 1e-12


def _run_trial(args, out_dir: Path, trial: int, cfg: dict, epochs: int, resume: bool) -> float:
    """Train one trial, ``args`` with the config's values (``final_lr`` for
    ``final_lr_ratio``), one replicate of one model in
    ``<out_dir>/trial_<trial>``, to ``epochs`` epochs in all (resuming its
    whole training state from its ``last.ckpt`` where ``resume``); its best
    validation loss, or ``inf`` where the run raised."""
    from chemprop_tpu_torch.cli import train as train_cli

    targs = copy.deepcopy(args)
    for k, v in cfg.items():
        if k == "final_lr_ratio":
            targs.final_lr = v * targs.max_lr
        else:
            setattr(targs, k, v)
    targs.output_dir = out_dir / f"trial_{trial}"
    targs.num_replicates = 1
    targs.ensemble_size = 1
    targs.epochs = epochs
    last = sorted(targs.output_dir.rglob("last.ckpt"))
    if resume and last:
        targs.resume = last[0]
    logger.info(f"trial {trial}: epochs={epochs} resume={resume and bool(last)} {cfg}")
    try:
        train_cli.main(targs)
        history = json.loads(sorted(targs.output_dir.rglob("history.json"))[0].read_text())
        return min(h.get("val_loss", h["train_loss"]) for h in history)
    except Exception as e:  # a trial's failure scores it, the search goes on
        logger.warning(f"trial {trial} failed: {e}", exc_info=True)
        return float("inf")


def _asha(args, out_dir: Path, configs: list[dict], results: list[dict]):
    """Synchronous successive halving: every trial on the smallest budget,
    then the best ``1 / eta`` of each rung resumed with ``eta`` times the
    budget; ``(score, config, trial)`` of the best trial of the last rung."""
    eta = max(2, args.asha_eta)
    n_rungs = 0
    while eta ** (n_rungs + 1) <= args.num_trials and args.epochs // eta ** (n_rungs + 1) >= 1:
        n_rungs += 1
    survivors = list(range(args.num_trials))
    budget = max(1, args.epochs // eta**n_rungs)
    if args.raytune_grace_period is not None:  # a floor on the first rung's budget
        budget = min(args.epochs, max(budget, args.raytune_grace_period))
    rung = 0
    while True:
        scored = []
        for trial in survivors:
            score = _run_trial(args, out_dir, trial, configs[trial], budget, resume=rung > 0)
            scored.append((score, trial))
            results.append({"trial": trial, "rung": rung, "epochs": budget,
                            "config": configs[trial], "score": score})
        scored.sort(key=lambda t: t[0])
        if budget >= args.epochs or len(scored) == 1:
            return scored[0][0], configs[scored[0][1]], scored[0][1]
        survivors = [t for _, t in scored[: max(1, -(-len(scored) // eta))]]
        budget = min(args.epochs, budget * eta)
        rung += 1


def main(args) -> int:
    refuse_unported(args)
    resolve_device(args.device)  # raises where there is no GPU, before any trial
    out_dir = args.hpopt_save_dir or (args.output_dir or Path("chemprop_tpu_hpopt"))
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = _expand_keywords(args.search_parameter_keywords)
    seed = args.hyperopt_random_state_seed
    rng = np.random.default_rng(args.data_seed if seed is None else seed)
    sampler = (TPESampler(keys, rng, n_startup=args.startup_trials)
               if args.search_algorithm in ("hyperopt", "optuna") else None)
    # ASHA needs every trial's config first; the estimator proposes one
    # after another, so the draws of both come from one stream in this order
    configs = [_sample(rng, keys) for _ in range(args.num_trials)]
    if args.raytune_trial_scheduler is not None:
        args.scheduler = {"FIFO": "fifo", "AsyncHyperBand": "asha"}[args.raytune_trial_scheduler]

    results: list[dict] = []
    best = (np.inf, None, None)
    if args.scheduler == "asha":
        best = _asha(args, out_dir, configs, results)
    else:
        for trial in range(args.num_trials):
            cfg = sampler.suggest() if sampler is not None else configs[trial]
            score = _run_trial(args, out_dir, trial, cfg, args.epochs, resume=False)
            if sampler is not None:
                sampler.observe(cfg, score)
            results.append({"trial": trial, "config": cfg, "score": score})
            if score < best[0]:
                best = (score, cfg, trial)

    with open(out_dir / "all_progress.json", "w") as f:
        json.dump(results, f, indent=2)
    best_cfg = dict(best[1] or {})
    if "final_lr_ratio" in best_cfg:
        best_cfg["final_lr"] = best_cfg.pop("final_lr_ratio") * args.max_lr
    with open(out_dir / "best_config.json", "w") as f:
        json.dump(best_cfg, f, indent=2)
    print(json.dumps({"best_trial": best[2], "best_score": best[0], "best_config": best_cfg}))
    return 0


add_hpopt_args = add_args  # the JAX package's name


class HpoptSubcommand(Subcommand):
    """``hpopt`` on the command line: :func:`add_args` and :func:`main`."""

    COMMAND = "hpopt"
    HELP = "search the hyperparameters of train"
    add_args = staticmethod(add_args)
    func = staticmethod(main)
