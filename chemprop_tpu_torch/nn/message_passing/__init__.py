from chemprop_tpu_torch.nn.message_passing.base import AtomMessagePassing, BondMessagePassing

__all__ = ["AtomMessagePassing", "BondMessagePassing"]
