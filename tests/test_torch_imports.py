"""The port stands alone: no module of ``chemprop_tpu_torch``, nor the root
``chip_smoke.py``, the port's profile and kernel scripts or its examples
(``examples_torch/``), imports JAX, flax, optax or the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "chemprop_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py",
    REPO / "experiments" / "torch_forward_profile.py",
    REPO / "experiments" / "torch_train_profile.py",
    REPO / "experiments" / "torch_grad_weight.py",
    REPO / "experiments" / "torch_fused_iter.py",
    REPO / "experiments" / "torch_premul.py",
    REPO / "experiments" / "torch_segment.py",
    REPO / "experiments" / "torch_bwd_nodes.py",
    REPO / "experiments" / "torch_iter_bwd.py",
    REPO / "experiments" / "torch_iter_bwd_parts.py",
    REPO / "experiments" / "torch_iter2.py",
    REPO / "experiments" / "torch_iter2_parts.py",
    REPO / "experiments" / "torch_message.py",
    REPO / "experiments" / "torch_message_parts.py",
    REPO / "experiments" / "torch_bwd_message.py",
    REPO / "experiments" / "torch_bwd_message_parts.py",
    REPO / "experiments" / "torch_head_fits.py",
    REPO / "experiments" / "torch_split_tiles.py",
    REPO / "experiments" / "torch_tanh_bits.py",
    REPO / "experiments" / "torch_cli_train_check.py",
    REPO / "experiments" / "torch_dispatch.py",
    REPO / "experiments" / "torch_row_gather.py",
] + sorted((REPO / "examples_torch").glob("*.py"))
# the JAX stack, and what the machine with the card does not have either
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chemprop_tpu", "sklearn", "pandas", "msgpack")
NEW_MODULES = (
    "ops/gather.py", "nn/metrics.py", "data/datapoints.py", "data/datasets.py",
    "data/samplers.py", "data/dataloader.py", "train/__init__.py", "train/schedulers.py",
    "train/trainer.py", "ops/options.py", "ops/grad_weight.py", "models/serialize.py",
    "utils/msgpack_codec.py", "nn/transforms.py", "uncertainty/__init__.py",
    "uncertainty/estimator.py", "uncertainty/calibrator.py", "uncertainty/evaluator.py",
    "cli/fingerprint.py", "cli/convert.py", "cli/hpopt.py",
    "chem/smarts.py", "chem/charges.py", "chem/estate.py", "chem/fragments.py",
    "chem/surface.py", "chem/descriptors.py", "featurizers/molecule.py",
    "featurizers/molgraph/reaction.py", "nn/message_passing/multi.py", "models/multi.py",
    "interpret.py", "callbacks/__init__.py", "schedulers.py", "exceptions.py", "conf.py",
    "featurizers/base.py", "featurizers/molgraph/cache.py", "data/molgraph.py", "utils/utils.py",
    "data/kmeans.py", "models/export.py", "featurizers/native.py",
    "ops/edge_partition.py", "parallel/__init__.py", "parallel/sharding.py",
    "parallel/distributed.py", "parallel/shard_train.py", "parallel/partitioned_mp.py",
    "cli/utils/__init__.py", "cli/utils/actions.py", "cli/utils/args.py",
    "cli/utils/command.py", "cli/utils/parsing.py", "cli/utils/utils.py",
)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    assert path.exists()
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_training_modules_are_covered():
    package = REPO / "chemprop_tpu_torch"
    names = {str(p.relative_to(package)) for p in PORT_FILES if package in p.parents}
    assert set(NEW_MODULES) <= names


def test_port_runs_without_jax_installed(tmp_path):
    """Importing every module of the port with jax, flax and chemprop_tpu
    made unimportable still works."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "chemprop_tpu_torch").rglob("*.py")
        if p.name != "__main__.py"
    )
    code = (
        "import sys, importlib\n"
        f"for name in {list(FORBIDDEN)!r}: sys.modules[name] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
