"""ctypes bindings of the native C++ batch featurizer
(``chemprop_tpu_torch/csrc/featurizer.cpp``; cf.
``chemprop_tpu/featurizers/native.py``), the cuik-molmaker equivalent
(reference ``featurizers/molgraph/molecule.py:127-257``): one call
featurizes a whole SMILES list into pre-batched arrays, bit-identical to the
Python featurizer's (72 atom and 14 bond features, the V2 layout).

The library is built by ``g++`` at its first use (``ops.build.host_library``:
``chemprop_tpu_torch/_build/featurizer-<hash>.so``). Where the JAX package
falls back to Python featurization when the library cannot be built, the
port raises with the compiler's output: the caller asked for the native
path."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from chemprop_tpu_torch.ops.build import host_library
from chemprop_tpu_torch.types import MolGraph

_lib = None


class NativeBatch(NamedTuple):
    V: np.ndarray  # [n_atoms, 72] float32
    E: np.ndarray  # [n_edges, 14] float32
    src: np.ndarray  # [n_edges] int32
    dst: np.ndarray
    rev: np.ndarray
    batch: np.ndarray  # [n_atoms] int32 (mol index)
    atom_offsets: np.ndarray  # [n_mols + 1]
    edge_offsets: np.ndarray  # [n_mols + 1]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(host_library("featurizer")))
    lib.cptpu_featurize_batch.restype = ctypes.c_void_p
    lib.cptpu_featurize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
    ]
    lib.cptpu_featurize_rxn_batch.restype = ctypes.c_void_p
    lib.cptpu_featurize_rxn_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    for name in ("cptpu_atom_fdim", "cptpu_bond_fdim", "cptpu_error_index"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.cptpu_error_msg.argtypes = [ctypes.c_void_p]
    lib.cptpu_error_msg.restype = ctypes.c_char_p
    for name in ("cptpu_n_atoms", "cptpu_n_edges"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int64
    for name in ("cptpu_V", "cptpu_E"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_float)
    for name in ("cptpu_src", "cptpu_dst", "cptpu_rev", "cptpu_batch", "cptpu_atom_offsets",
                 "cptpu_edge_offsets"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int32)
    lib.cptpu_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _batch_from_handle(lib, h, inputs: list[str]) -> NativeBatch:
    err_idx = lib.cptpu_error_index(h)
    if err_idx >= 0:
        raise ValueError(f"failed to parse {inputs[err_idx]!r}: {lib.cptpu_error_msg(h).decode()}")
    n_atoms, n_edges = lib.cptpu_n_atoms(h), lib.cptpu_n_edges(h)
    d_v, d_e = lib.cptpu_atom_fdim(h), lib.cptpu_bond_fdim(h)

    def copy(ptr, shape, dtype):
        n = int(np.prod(shape))
        if n == 0:
            return np.zeros(shape, dtype=dtype)
        # one memcpy (string_at), where a ctypes array type of n elements
        # would take longer than the featurization
        raw = ctypes.string_at(ptr, n * np.dtype(dtype).itemsize)
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()

    n_mols = len(inputs)
    return NativeBatch(
        V=copy(lib.cptpu_V(h), (n_atoms, d_v), np.float32),
        E=copy(lib.cptpu_E(h), (n_edges, d_e), np.float32),
        src=copy(lib.cptpu_src(h), (n_edges,), np.int32),
        dst=copy(lib.cptpu_dst(h), (n_edges,), np.int32),
        rev=copy(lib.cptpu_rev(h), (n_edges,), np.int32),
        batch=copy(lib.cptpu_batch(h), (n_atoms,), np.int32),
        atom_offsets=copy(lib.cptpu_atom_offsets(h), (n_mols + 1,), np.int32),
        edge_offsets=copy(lib.cptpu_edge_offsets(h), (n_mols + 1,), np.int32),
    )


def _call(fn: str, inputs: list[str], *args) -> NativeBatch:
    lib = _load()
    arr = (ctypes.c_char_p * len(inputs))(*[s.encode() for s in inputs])
    h = getattr(lib, fn)(arr, len(inputs), *args)
    try:
        return _batch_from_handle(lib, h, inputs)
    finally:
        lib.cptpu_free(h)


def featurize_batch_native(smiles: list[str], keep_h: bool = False) -> NativeBatch:
    """SMILES -> the batch's featurized arrays (V2 atom features), in C++."""
    return _call("cptpu_featurize_batch", list(smiles), int(keep_h))


# RxnMode name -> the C++ mode code (kind * 2 + balanced)
_RXN_MODES = {
    "REAC_PROD": 0, "REAC_PROD_BALANCE": 1,
    "REAC_DIFF": 2, "REAC_DIFF_BALANCE": 3,
    "PROD_DIFF": 4, "PROD_DIFF_BALANCE": 5,
}


def featurize_rxn_batch_native(
    rxns: list[str], keep_h: bool = False, mode: str = "REAC_DIFF"
) -> NativeBatch:
    """Reaction SMILES (``"rct>agents>pdt"``) -> the batch's condensed graphs
    of reaction in ``mode``, in C++ (the cuik ``batch_reaction_featurizer``
    equivalent, reference ``featurizers/molgraph/reaction.py:338-470``)."""
    code = _RXN_MODES[str(mode).upper().replace("-", "_")]
    return _call("cptpu_featurize_rxn_batch", list(rxns), int(keep_h), code)


def molgraphs_from_native(nb: NativeBatch) -> list[MolGraph]:
    """A ``NativeBatch`` cut back into one ``MolGraph`` per molecule, as the
    Python featurizers give them (a dataset's cache)."""
    out = []
    for m in range(len(nb.atom_offsets) - 1):
        a0, a1 = int(nb.atom_offsets[m]), int(nb.atom_offsets[m + 1])
        e0, e1 = int(nb.edge_offsets[m]), int(nb.edge_offsets[m + 1])
        out.append(MolGraph(
            V=nb.V[a0:a1],
            E=nb.E[e0:e1],
            edge_index=np.stack([nb.src[e0:e1] - a0, nb.dst[e0:e1] - a0]),
            rev_edge_index=nb.rev[e0:e1] - e0,
        ))
    return out


class CuikmolmakerMolGraphFeaturizer:
    """Batch SMILES featurizer with the reference's cuik-molmaker wrapper's
    call (``featurizers/molgraph/molecule.py:127-257``): one call featurizes
    the whole list in C++ and returns the batch's arrays (a ``NativeBatch``,
    the ``BatchCuikMolGraph`` equivalent)."""

    def __init__(self, keep_h: bool = False):
        self.keep_h = keep_h

    def __call__(self, smiles: list[str]) -> NativeBatch:
        return featurize_batch_native(smiles, keep_h=self.keep_h)


class CuikmolmakerCGRFeaturizer:
    """Batch reaction featurizer (condensed graph of reaction) in C++ (the
    cuik ``batch_reaction_featurizer`` equivalent, reference
    ``featurizers/molgraph/reaction.py:338-470``)."""

    def __init__(self, mode: str = "REAC_DIFF", keep_h: bool = False):
        self.mode = mode
        self.keep_h = keep_h

    def __call__(self, rxns: list[str]) -> NativeBatch:
        return featurize_rxn_batch_native(rxns, keep_h=self.keep_h, mode=self.mode)


# the reference's name of the batch's arrays
BatchCuikMolGraph = NativeBatch
