from chemprop_tpu_torch.models.load import from_jax_params, load_model
from chemprop_tpu_torch.models.serialize import load_checkpoint, save_checkpoint, save_model
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.models.mol_atom_bond import MolAtomBondMPNN
from chemprop_tpu_torch.models.multi import MulticomponentMPNN

__all__ = ["MPNN", "MolAtomBondMPNN", "MulticomponentMPNN", "from_jax_params", "load_checkpoint",
           "load_model", "save_checkpoint", "save_model"]
