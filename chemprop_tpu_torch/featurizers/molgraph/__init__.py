from chemprop_tpu_torch.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.featurizers.molgraph.reaction import (
    CGRFeaturizer,
    CondensedGraphOfReactionFeaturizer,
    RxnMode,
)

__all__ = [
    "CGRFeaturizer",
    "CondensedGraphOfReactionFeaturizer",
    "RxnMode",
    "SimpleMoleculeMolGraphFeaturizer",
]
