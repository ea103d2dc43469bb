"""The argument groups that ``train`` shares with the other subcommands (cf.
``chemprop_tpu/cli/common.py``): the JAX package's flags under its names, so
that a run's ``config.json`` has its keys, and the port's own ``--device`` and
``--dtype``, and :func:`find_models`. ``--use-cuikmolmaker-featurization``
takes the native C++ featurizer in ``train``, and is parsed and not read
elsewhere, as in the JAX package; ``--accelerator`` is the JAX package's
platform choice, where the port takes ``--device``. ``--devices N`` trains
data-parallel over a process group of N ranks, one per GPU, launched by
``torchrun --nproc-per-node N -m chemprop_tpu_torch.cli train ...``
(:func:`select_mesh`)."""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import torch

from chemprop_tpu_torch.featurizers.molecule import MoleculeFeaturizerRegistry

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

logger = logging.getLogger(__name__)


def add_common_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group("Shared input args")
    # also accepted after the subcommand; the defaults themselves are
    # injected before parsing by cli.main._apply_config_defaults
    group.add_argument("--config-path", type=Path, help="JSON/TOML file of argument defaults")
    group.add_argument(
        "-i",
        "--data-path",
        type=Path,
        nargs="+",
        help="input CSV path(s). train accepts one, two, or three files "
        "(reference cli/train.py:126-133): one = train/val/test split; two = "
        "the first is train/val-split and the second is the test set; three = "
        "fixed train, val, test. Other subcommands take exactly one.",
    )
    group.add_argument(
        "-s", "--smiles-columns", nargs="+", help="SMILES column name(s); >1 = multicomponent"
    )
    group.add_argument(
        "--reaction-columns", nargs="+", help="reaction SMILES column name(s)"
    )
    group.add_argument("--no-header-row", action="store_true")
    group.add_argument(
        "--multi-hot-atom-featurizer-mode",
        default="v2",
        choices=["v1", "v2", "organic", "rigr"],
    )
    group.add_argument(
        "--rxn-mode",
        "--reaction-mode",
        default="reac_diff",
        choices=[
            "reac_prod",
            "reac_prod_balance",
            "reac_diff",
            "reac_diff_balance",
            "prod_diff",
            "prod_diff_balance",
        ],
    )
    group.add_argument("--keep-h", action="store_true")
    group.add_argument("--add-h", action="store_true")
    group.add_argument("--ignore-stereo", action="store_true")
    group.add_argument(
        "--reorder-atoms",
        action="store_true",
        help="reorder atoms by atom map numbers (cf. reference common.py:95)",
    )
    group.add_argument(
        "--molecule-featurizers",
        "--features-generators",
        nargs="+",
        choices=sorted(MoleculeFeaturizerRegistry.keys()),
        help="molecule featurizers whose vectors join the first SMILES column's X_d",
    )
    group.add_argument("--descriptors-path", type=Path, help=".npz of extra descriptors X_d")
    group.add_argument(
        "--descriptors-columns",
        nargs="+",
        help="input-CSV column names holding extra datapoint descriptors (e.g. temperature)",
    )
    # a single PATH (component 0) or (IDX PATH) pairs for multicomponent
    # inputs — reference per-component syntax (common.py:194-231)
    group.add_argument(
        "--atom-features-path", nargs="+",
        help=".npz extra atom features V_f: PATH, or IDX PATH pairs",
    )
    group.add_argument(
        "--bond-features-path", nargs="+",
        help=".npz extra bond features E_f: PATH, or IDX PATH pairs",
    )
    group.add_argument(
        "--atom-descriptors-path", nargs="+",
        help=".npz extra atom descriptors V_d: PATH, or IDX PATH pairs",
    )
    group.add_argument(
        "--bond-descriptors-path", nargs="+",
        help=".npz extra bond descriptors E_d (mol/atom/bond models only): "
        "PATH, or IDX PATH pairs",
    )
    group.add_argument("--no-descriptor-scaling", action="store_true")
    group.add_argument("--no-atom-feature-scaling", action="store_true")
    group.add_argument("--no-atom-descriptor-scaling", action="store_true")
    group.add_argument("--no-bond-feature-scaling", action="store_true")
    group.add_argument("--no-bond-descriptor-scaling", action="store_true")
    group.add_argument(
        "--use-cuikmolmaker-featurization",
        action="store_true",
        help="use the native C++ batch featurizer (chemprop_tpu_torch/csrc/featurizer.cpp) for "
        "accelerated atom/bond featurization (cuik-molmaker equivalent)",
    )
    group.add_argument("-n", "--num-workers", type=int, default=0)
    group.add_argument("-b", "--batch-size", type=int, default=64)
    group.add_argument(
        "--accelerator", default="auto",
        help="the JAX package's platform choice; the port takes --device (only 'auto')",
    )
    group.add_argument(
        "--devices",
        default="auto",
        help="ranks of data-parallel training, one GPU each, launched by torchrun "
        "--nproc-per-node N ('auto': the launch's world size)",
    )
    add_device_args(group)
    return parser


def add_device_args(group) -> None:
    """The port's ``--device`` and ``--dtype``."""
    group.add_argument("--device", help="torch device (default: cuda; raises without a GPU)")
    group.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                       help="message-passing compute dtype")


def check_devices(args) -> None:
    """Refuse the JAX package's platform option and a device count that is
    neither ``auto`` nor a positive number."""
    if getattr(args, "accelerator", "auto") not in (None, "auto"):
        raise ValueError("--accelerator is the JAX package's platform choice; "
                         "the port takes --device")
    devices = getattr(args, "devices", "auto")
    if devices not in (None, "auto") and (not str(devices).isdigit() or int(devices) < 1):
        raise ValueError(f"--devices takes 'auto' or a number of devices of at least 1, "
                         f"not {devices!r}")


def select_mesh(args, device: torch.device):
    """The process group of ``--devices N`` (``parallel.sharding.Mesh``), or
    None for one device. ``auto`` is the launch's world size (torchrun's
    ``WORLD_SIZE``, 1 without it). A launch of fewer processes than N runs
    on those it has, with a warning, as the JAX package clamps to its
    devices; a launch of more processes than N is refused."""
    devices = getattr(args, "devices", "auto")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    n = world if devices in (None, "auto") else int(devices)
    if n > world:
        logger.warning(f"requested {n} devices, only {world} available")
        n = world
    if n < world:
        raise ValueError(f"--devices {n} in a launch of {world} processes: launch "
                         f"torchrun --nproc-per-node {n}")
    if n <= 1:
        return None
    from chemprop_tpu_torch.parallel import make_mesh

    return make_mesh(device=device)


def find_models(model_paths: list[Path]) -> list[Path]:
    """Model files from ``--model-paths``: a ``.ckpt`` or ``.pt`` file as it
    is; a training output directory its ``best.ckpt`` (never the copy under
    ``checkpoints/``, nor ``last.ckpt``, which carries the optimizer's state
    for resuming); any other directory every ``*.ckpt`` and ``*.pt`` below
    it but ``last.ckpt``, sorted."""
    found = []
    for p in map(Path, model_paths):
        if p.suffix in (".ckpt", ".pt"):
            found.append(p)
        elif p.is_dir():
            if (p / "best.ckpt").exists():
                found.append(p / "best.ckpt")
            else:
                found.extend(f for f in sorted(list(p.rglob("*.ckpt")) + list(p.rglob("*.pt")))
                             if f.name != "last.ckpt")
        else:
            raise ValueError(f"cannot interpret model path {p}")
    return found
