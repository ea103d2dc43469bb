from chemprop_tpu_torch.featurizers.atom import MultiHotAtomFeaturizer
from chemprop_tpu_torch.featurizers.bond import MultiHotBondFeaturizer
from chemprop_tpu_torch.featurizers.molgraph import SimpleMoleculeMolGraphFeaturizer

__all__ = [
    "MultiHotAtomFeaturizer",
    "MultiHotBondFeaturizer",
    "SimpleMoleculeMolGraphFeaturizer",
]
