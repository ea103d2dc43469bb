from chemprop_tpu_torch.nn.message_passing.base import BondMessagePassing

__all__ = ["BondMessagePassing"]
