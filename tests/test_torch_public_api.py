"""The port's library API: every name of the JAX package's reference
exports (``tests/unit/test_public_api.py``'s ``REFERENCE_EXPORTS``, the
names the reference's package ``__init__``s import) resolves from
``chemprop_tpu_torch``, the native featurizer's (``ROADMAP.md`` section 1
item 5) included. The JAX package's own test of its ``schedulers`` and
``exceptions`` modules, ported."""

from __future__ import annotations

import importlib
import math

import pytest

from unit.test_public_api import REFERENCE_EXPORTS

# item 5, the native featurizer, was the last left out
ITEM_5 = {
    "data": {"CuikmolmakerDataset", "CuikmolmakerReactionDataset"},
    "featurizers": {"CuikmolmakerMolGraphFeaturizer", "CuikmolmakerCGRFeaturizer",
                    "BatchCuikMolGraph"},
}


@pytest.mark.parametrize("subpackage", sorted(REFERENCE_EXPORTS))
def test_reference_exports_resolve(subpackage):
    mod = importlib.import_module("chemprop_tpu_torch" + (f".{subpackage}" if subpackage else ""))
    missing = [n for n in REFERENCE_EXPORTS[subpackage] if not hasattr(mod, n)]
    assert not missing, f"chemprop_tpu_torch.{subpackage}: missing {missing}"


# the JAX package's own exports (its __all__), beyond the reference's
JAX_PACKAGES = ["callbacks", "chem", "cli", "data", "featurizers", "featurizers.molgraph",
                "models", "nn", "nn.message_passing", "parallel", "train", "uncertainty",
                "utils"]


@pytest.mark.parametrize("subpackage", JAX_PACKAGES)
def test_jax_package_exports_resolve(subpackage):
    jax_mod = importlib.import_module(f"chemprop_tpu.{subpackage}")
    mod = importlib.import_module(f"chemprop_tpu_torch.{subpackage}")
    missing = [n for n in jax_mod.__all__ if not hasattr(mod, n)]
    assert not missing, f"chemprop_tpu_torch.{subpackage}: missing {missing}"


def test_only_item_5_is_left_out():
    """Item 5's five names, the last left out, resolve where the JAX
    package exports them, and all 175 of the reference's do."""
    for subpackage, names in ITEM_5.items():
        jax_mod = importlib.import_module(f"chemprop_tpu.{subpackage}")
        mod = importlib.import_module(f"chemprop_tpu_torch.{subpackage}")
        assert names <= set(jax_mod.__all__) and names <= set(mod.__all__)
        assert all(hasattr(mod, n) for n in names)
    assert sum(map(len, REFERENCE_EXPORTS.values())) == 175


def test_schedulers_exports():
    from chemprop_tpu_torch.exceptions import InvalidShapeError
    from chemprop_tpu_torch.schedulers import build_NoamLike_LRSched  # noqa: F401

    with pytest.raises(ValueError):
        raise InvalidShapeError("x", (1, 2), (3, 4))


def test_schedule_matches_the_trainer_and_jax():
    """``build_NoamLike_LRSched`` is the trainer's rate (``noam_lr``), and
    the JAX package's optax schedule, step by step."""
    from chemprop_tpu.schedulers import build_NoamLike_LRSched as jax_schedule
    from chemprop_tpu_torch.schedulers import build_NoamLike_LRSched
    from chemprop_tpu_torch.train.schedulers import noam_lr

    args = (4, 10, 1e-4, 1e-3, 1e-5)
    port, jax_ = build_NoamLike_LRSched(*args), jax_schedule(*args)
    for step in range(20):
        assert port(step) == noam_lr(step, *args)
        assert math.isclose(port(step), float(jax_(step)), rel_tol=1e-6)


def test_top_level_package():
    import chemprop_tpu_torch

    assert chemprop_tpu_torch.__version__ == "0.1.0"
    assert "callbacks" in chemprop_tpu_torch.__all__
    assert chemprop_tpu_torch.callbacks.CallbackRegistry["myerson"]
    assert "inference path" not in chemprop_tpu_torch.__doc__


def test_base_classes_cover_the_port_classes():
    """Each base that the port exports is a base of the classes it names."""
    from chemprop_tpu_torch import nn

    assert all(issubclass(c, nn.Aggregation) for c in (
        nn.SumAggregation, nn.MeanAggregation, nn.NormAggregation, nn.AttentiveAggregation))
    assert all(issubclass(c, nn.MessagePassing) for c in (
        nn.BondMessagePassing, nn.AtomMessagePassing, nn.MABBondMessagePassing,
        nn.MABAtomMessagePassing))
    assert all(issubclass(c, nn.MABMessagePassing)
               for c in (nn.MABBondMessagePassing, nn.MABAtomMessagePassing))
    assert all(issubclass(c, nn.Predictor) for c in nn.PredictorRegistry.values())
    assert all(issubclass(c, nn.BinaryClassificationFFNBase)
               for c in (nn.BinaryClassificationFFN, nn.BinaryDirichletFFN))
    assert nn.ClassificationMixin is nn.BinaryClassificationFFNBase
    assert all(issubclass(c, nn.ChempropMetric) for c in nn.LossFunctionRegistry.values())


def test_utils_helpers():
    from chemprop_tpu_torch.utils import (
        batched, create_and_call_object, make_mol, parallel_execute, pretty_shape,
    )

    assert list(batched(range(5), 2)) == [[0, 1], [2, 3], [4]]
    assert pretty_shape((10, 4)) == "10 x 4"
    class Add:
        def __init__(self, a):
            self.a = a

        def __call__(self, b):
            return self.a + b

    assert create_and_call_object(Add, call_args=(2,), init_args=(1,)) == 3
    assert parallel_execute(abs, [-1, 2, -3]) == [1, 2, 3]
    assert make_mol("CCO").num_atoms == 3


def test_molgraph_caches_and_build_dataloader():
    """The cache facades hold the featurizer's graphs; ``build_dataloader``
    gives the port's loader with the reference's arguments."""
    import numpy as np

    from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
    from chemprop_tpu_torch.data import build_dataloader
    from chemprop_tpu_torch.featurizers import (
        GraphFeaturizer, MolGraphCache, MolGraphCacheOnTheFly, SimpleMoleculeMolGraphFeaturizer,
    )
    from chemprop_tpu_torch.utils import make_mol

    feat = SimpleMoleculeMolGraphFeaturizer()
    assert isinstance(feat, GraphFeaturizer)
    mols = [make_mol(s) for s in ("CCO", "c1ccccc1")]
    cached = MolGraphCache(mols, [None] * 2, [None] * 2, feat)
    lazy = MolGraphCacheOnTheFly(mols, [None] * 2, [None] * 2, feat)
    assert len(cached) == len(lazy) == 2
    for a, b in zip(cached, lazy):
        np.testing.assert_array_equal(a.V, b.V)
    ds = MoleculeDataset([MoleculeDatapoint(m, y=np.zeros(1)) for m in mols])
    loader = build_dataloader(ds, batch_size=1, shuffle=False)
    assert isinstance(loader, DataLoader) and len(loader) == 2
    np.testing.assert_array_equal(next(iter(loader)).bmg.V[:3].numpy(), cached[0].V)


def test_build_dataloader_featurises_in_workers():
    """``num_workers`` sets the dataset's ``n_workers``, as in the JAX
    package, and filling the cache then featurises in that many forked
    processes; run in a process of its own, without JAX's threads, which a
    fork would copy mid-flight."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import numpy as np\n"
        "from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset, "
        "build_dataloader\n"
        "smis = ['CCO', 'c1ccccc1', 'CC(=O)O']\n"
        "ds = lambda: MoleculeDataset([MoleculeDatapoint.from_smi(s) for s in smis])\n"
        "pooled = build_dataloader(ds(), batch_size=2, num_workers=2, shuffle=False)\n"
        "plain = ds()\n"
        "assert pooled.dataset.n_workers == 2 and not pooled.dataset.cache\n"
        "pooled.dataset.cache = True\n"
        "assert pooled.dataset.cache and len(pooled.dataset._cache) == 3\n"
        "for i in range(3):\n"
        "    for a, b in zip(pooled.dataset[i].mg, plain[i].mg):\n"
        "        np.testing.assert_array_equal(a, b)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["batch_shardings", "shard_batch", "host_local_array_to_global",
                                  "host_local_batch_to_global"])
def test_gspmd_names_state_their_divergence(name):
    """The JAX package's GSPMD names resolve in the port and raise, saying
    that each rank collates its own shard and runs the per-rank step."""
    from chemprop_tpu_torch.parallel import distributed, sharding

    fn = getattr(sharding, name, None) or getattr(distributed, name)
    with pytest.raises(NotImplementedError, match="each rank collates its own shard"):
        fn(None, None)
