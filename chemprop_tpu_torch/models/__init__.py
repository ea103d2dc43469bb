from chemprop_tpu_torch.models.load import from_jax_params, load_model
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.models.multi import MulticomponentMPNN

__all__ = ["MPNN", "MulticomponentMPNN", "from_jax_params", "load_model"]
