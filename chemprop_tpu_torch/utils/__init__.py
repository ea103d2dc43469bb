from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.utils.device import resolve_device
from chemprop_tpu_torch.utils.registry import ClassRegistry, Factory
from chemprop_tpu_torch.utils.utils import (
    EnumMapping,
    batched,
    create_and_call_object,
    parallel_execute,
    pretty_shape,
)

__all__ = ["ClassRegistry", "EnumMapping", "Factory", "batched", "create_and_call_object",
           "make_mol", "parallel_execute", "pretty_shape", "resolve_device"]
