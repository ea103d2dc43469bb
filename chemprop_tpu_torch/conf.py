"""Global configuration defaults (cf. ``chemprop_tpu/conf.py``)."""

DEFAULT_ATOM_FDIM = 72
DEFAULT_BOND_FDIM = 14
DEFAULT_HIDDEN_DIM = 300
