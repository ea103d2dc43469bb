from chemprop_tpu_torch.nn.message_passing.base import AtomMessagePassing, BondMessagePassing
from chemprop_tpu_torch.nn.message_passing.multi import MulticomponentMessagePassing

__all__ = ["AtomMessagePassing", "BondMessagePassing", "MulticomponentMessagePassing"]
