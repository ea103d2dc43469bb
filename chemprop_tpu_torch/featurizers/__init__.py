from typing import TypeVar

from chemprop_tpu_torch.featurizers.atom import (
    AtomFeatureMode,
    MultiHotAtomFeaturizer,
    RIGRAtomFeaturizer,
    get_multi_hot_atom_featurizer,
)
from chemprop_tpu_torch.featurizers.base import GraphFeaturizer, VectorFeaturizer
from chemprop_tpu_torch.featurizers.bond import MultiHotBondFeaturizer, RIGRBondFeaturizer
from chemprop_tpu_torch.featurizers.molecule import (
    BinaryFeaturizerMixin,
    ChargeFeaturizer,
    CountFeaturizerMixin,
    MoleculeFeaturizerRegistry,
    MorganBinaryFeaturizer,
    MorganCountFeaturizer,
    MorganFeaturizerMixin,
    RDKit2DFeaturizer,
    V1RDKit2DFeaturizer,
    V1RDKit2DNormalizedFeaturizer,
)
from chemprop_tpu_torch.featurizers.molgraph import (
    CGRFeaturizer,
    CondensedGraphOfReactionFeaturizer,
    RxnMode,
    SimpleMoleculeMolGraphFeaturizer,
)
from chemprop_tpu_torch.featurizers.molgraph.cache import (
    MolGraphCache,
    MolGraphCacheFacade,
    MolGraphCacheOnTheFly,
)
from chemprop_tpu_torch.featurizers.native import (
    BatchCuikMolGraph,
    CuikmolmakerCGRFeaturizer,
    CuikmolmakerMolGraphFeaturizer,
)

# the JAX package's names of the protocols
Featurizer = VectorFeaturizer
MoleculeFeaturizer = VectorFeaturizer
S = TypeVar("S")
T = TypeVar("T")

__all__ = [
    "AtomFeatureMode",
    "BatchCuikMolGraph",
    "BinaryFeaturizerMixin",
    "CGRFeaturizer",
    "ChargeFeaturizer",
    "CondensedGraphOfReactionFeaturizer",
    "CountFeaturizerMixin",
    "CuikmolmakerCGRFeaturizer",
    "CuikmolmakerMolGraphFeaturizer",
    "Featurizer",
    "GraphFeaturizer",
    "MolGraphCache",
    "MolGraphCacheFacade",
    "MolGraphCacheOnTheFly",
    "MoleculeFeaturizer",
    "MoleculeFeaturizerRegistry",
    "MorganBinaryFeaturizer",
    "MorganCountFeaturizer",
    "MorganFeaturizerMixin",
    "MultiHotAtomFeaturizer",
    "MultiHotBondFeaturizer",
    "RDKit2DFeaturizer",
    "RIGRAtomFeaturizer",
    "RIGRBondFeaturizer",
    "RxnMode",
    "S",
    "SimpleMoleculeMolGraphFeaturizer",
    "T",
    "V1RDKit2DFeaturizer",
    "V1RDKit2DNormalizedFeaturizer",
    "VectorFeaturizer",
    "get_multi_hot_atom_featurizer",
]
