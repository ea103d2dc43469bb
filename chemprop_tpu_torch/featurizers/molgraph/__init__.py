from chemprop_tpu_torch.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer

__all__ = ["SimpleMoleculeMolGraphFeaturizer"]
