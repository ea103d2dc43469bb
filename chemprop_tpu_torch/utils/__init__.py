from chemprop_tpu_torch.utils.device import resolve_device
from chemprop_tpu_torch.utils.utils import EnumMapping

__all__ = ["EnumMapping", "resolve_device"]
