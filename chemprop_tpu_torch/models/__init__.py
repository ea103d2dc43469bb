from chemprop_tpu_torch.models.load import from_jax_params, load_model
from chemprop_tpu_torch.models.model import MPNN

__all__ = ["MPNN", "from_jax_params", "load_model"]
