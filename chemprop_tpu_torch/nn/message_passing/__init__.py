from chemprop_tpu_torch.nn.message_passing.base import (
    AtomMessagePassing, BondMessagePassing, _MessagePassingBase,
)
from chemprop_tpu_torch.nn.message_passing.mol_atom_bond import (
    MABAtomMessagePassing, MABBondMessagePassing,
)
from chemprop_tpu_torch.nn.message_passing.multi import MulticomponentMessagePassing

__all__ = ["AtomMessagePassing", "BondMessagePassing", "MABAtomMessagePassing",
           "MABBondMessagePassing", "MulticomponentMessagePassing", "_MessagePassingBase"]
