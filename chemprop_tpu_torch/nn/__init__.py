from chemprop_tpu_torch.nn.agg import MeanAggregation, NormAggregation, SumAggregation
from chemprop_tpu_torch.nn.batchnorm import BatchNorm
from chemprop_tpu_torch.nn.ffn import MLP
from chemprop_tpu_torch.nn.message_passing import BondMessagePassing
from chemprop_tpu_torch.nn.predictors import RegressionFFN
from chemprop_tpu_torch.nn.transforms import GraphTransform, ScaleTransform, UnscaleTransform

__all__ = [
    "MLP",
    "BatchNorm",
    "BondMessagePassing",
    "GraphTransform",
    "MeanAggregation",
    "NormAggregation",
    "RegressionFFN",
    "ScaleTransform",
    "SumAggregation",
    "UnscaleTransform",
]
