from chemprop_tpu_torch.nn.agg import (
    AttentiveAggregation, MeanAggregation, NormAggregation, SumAggregation,
)
from chemprop_tpu_torch.nn.batchnorm import BatchNorm
from chemprop_tpu_torch.nn.ffn import MLP, ConstrainerFFN
from chemprop_tpu_torch.nn.message_passing import (
    AtomMessagePassing, BondMessagePassing, MABAtomMessagePassing, MABBondMessagePassing,
)
from chemprop_tpu_torch.nn.predictors import (
    BinaryClassificationFFN,
    BinaryDirichletFFN,
    EvidentialFFN,
    MulticlassClassificationFFN,
    MulticlassDirichletFFN,
    MveFFN,
    PredictorRegistry,
    QuantileFFN,
    RegressionFFN,
    SpectralFFN,
)
from chemprop_tpu_torch.nn.transforms import GraphTransform, ScaleTransform, UnscaleTransform

__all__ = [
    "MLP",
    "AtomMessagePassing",
    "AttentiveAggregation",
    "BatchNorm",
    "BinaryClassificationFFN",
    "BinaryDirichletFFN",
    "BondMessagePassing",
    "ConstrainerFFN",
    "EvidentialFFN",
    "GraphTransform",
    "MABAtomMessagePassing",
    "MABBondMessagePassing",
    "MeanAggregation",
    "MulticlassClassificationFFN",
    "MulticlassDirichletFFN",
    "MveFFN",
    "NormAggregation",
    "PredictorRegistry",
    "QuantileFFN",
    "RegressionFFN",
    "ScaleTransform",
    "SpectralFFN",
    "SumAggregation",
    "UnscaleTransform",
]
