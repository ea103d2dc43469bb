"""The port's splits, scaffold and graph keys, fingerprints, CSV parsing,
class-balance sampler and TensorBoard events against the JAX package's, on
the CPU."""

from __future__ import annotations

import csv
import math

import numpy as np
import pytest

from chemprop_tpu.chem import make_mol as jax_make_mol
from chemprop_tpu.chem.morgan import canonical_key as jax_canonical_key
from chemprop_tpu.chem.morgan_rdkit import rdkit_morgan_binary as jax_morgan
from chemprop_tpu.chem.scaffold import murcko_scaffold_key as jax_scaffold_key
from chemprop_tpu.chem.smiles_writer import write_smiles as jax_write_smiles
from chemprop_tpu.cli.parsing import parse_csv as jax_parse_csv
from chemprop_tpu.data.samplers import ClassBalanceSampler as JaxClassBalanceSampler
from chemprop_tpu.data.splitting import make_split_indices as jax_split
from chemprop_tpu.utils import tbevents as jax_tbevents
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.chem.morgan import canonical_key
from chemprop_tpu_torch.chem.morgan_rdkit import rdkit_morgan_binary
from chemprop_tpu_torch.chem.scaffold import murcko_scaffold_key
from chemprop_tpu_torch.chem.smiles_writer import write_smiles
from chemprop_tpu_torch.cli.parsing import parse_csv
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.data.samplers import ClassBalanceSampler
from chemprop_tpu_torch.data.splitting import make_split_indices
from chemprop_tpu_torch.utils import tbevents

SPLITS = ["random", "random_with_repeated_smiles", "scaffold_balanced", "kennard_stone"]
CSVS = ["regression/mol/mol.csv", "classification/mol.csv"]


def _smiles(path) -> list[str]:
    with open(path, newline="") as f:
        return [row[0] for row in csv.reader(f)][1:]


@pytest.fixture(scope="module")
def mols(data_dir):
    """Each CSV's molecules in both packages."""
    out = {}
    for name in CSVS:
        smis = _smiles(data_dir / name)
        out[name] = ([jax_make_mol(s) for s in smis], [make_mol(s) for s in smis])
    return out


@pytest.mark.parametrize("name", CSVS)
@pytest.mark.parametrize("split", SPLITS)
def test_split_indices_match_jax(mols, name, split):
    jmols, tmols = mols[name]
    want = jax_split(jmols, split, (0.8, 0.1, 0.1), seed=3, num_replicates=2)
    got = make_split_indices(tmols, split, (0.8, 0.1, 0.1), seed=3, num_replicates=2)
    assert got == want
    # two replicates, each a partition of the rows
    for tr, va, te in zip(*got):
        assert sorted(tr + va + te) == list(range(len(tmols)))


KEYS = {
    "murcko_scaffold_key": (jax_scaffold_key, murcko_scaffold_key),
    "canonical_key": (jax_canonical_key, canonical_key),
    "write_smiles": (jax_write_smiles, write_smiles),
    "rdkit_morgan_binary": (lambda m: jax_morgan(m, 2, 2048).tolist(),
                            lambda m: rdkit_morgan_binary(m, 2, 2048).tolist()),
}


@pytest.mark.parametrize("key", sorted(KEYS))
def test_keys_and_fingerprints_match_jax(smis, key):
    jax_fn, fn = KEYS[key]
    for s in smis:
        assert fn(make_mol(s)) == jax_fn(jax_make_mol(s)), s


PARSES = {
    "mol": ("regression/mol/mol.csv", {}),
    "tox21": ("classification/mol.csv", {}),
    "multiclass": ("classification/mol_multiclass.csv", {}),
    "multitask": ("regression/mol_multitask.csv", {}),
    "spectra": ("spectra.csv", {}),
    "bounded": ("regression/bounded.csv", {"bounded": True}),
    "splits_column": ("regression/mol/mol_with_splits.csv", {"splits_col": "split"}),
    "descriptor_columns": ("regression/mol/mol_with_descriptors.csv",
                           {"ignore_cols": ["temperature", "pressure"], "splits_col": "split"}),
    "targets_and_weights": ("regression/mol/mol_with_descriptors.csv",
                            {"target_cols": ["y"], "weight_col": "temperature"}),
    "no_header_row": ("regression/weights.csv", {"no_header_row": True}),
}


@pytest.mark.parametrize("case", sorted(PARSES))
def test_parse_csv_matches_jax(data_dir, case):
    path, kwargs = PARSES[case]
    kw = {"target_cols": None, **kwargs}
    args = (data_dir / path, None, None, kw.pop("target_cols"))
    want = jax_parse_csv(*args, **kw)
    got = parse_csv(*args, **kw)
    assert got[0] == want[0] and got[1] == want[1]  # SMILES and reaction columns
    np.testing.assert_array_equal(got[2], want[2])  # targets, NaN where missing
    assert np.isnan(got[2]).sum() == np.isnan(want[2]).sum()
    for g, w in zip(got[3:6], want[3:6]):  # weights, lt and gt masks
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    assert got[6:] == want[6:]  # splits, input and target columns


def test_parse_csv_reads_the_bounds(data_dir):
    _, _, Y, _, lt, gt, *_ = parse_csv(data_dir / "regression/bounded.csv", None, None, None,
                                       bounded=True)
    assert lt.any() and gt.any() and not (lt & gt).any()
    assert Y[0, 0] == -0.77 and lt[0, 0]


@pytest.mark.parametrize("shuffle", [False, True])
def test_class_balance_sampler_matches_jax(data_dir, shuffle):
    """Three epochs of Tox21's order (missing labels counted as the JAX
    sampler counts them)."""
    Y = parse_csv(data_dir / "classification/mol.csv", None, None, None)[2]
    want, got = JaxClassBalanceSampler(Y, 7, shuffle), ClassBalanceSampler(Y, 7, shuffle)
    assert len(got) == len(want)
    for _ in range(3):
        order = list(got)
        assert order == list(want)
        pos = np.asarray(Y).any(axis=1)
        assert all(pos[i] for i in order[::2]) and not any(pos[i] for i in order[1::2])


def test_dataloader_class_balance(data_dir):
    from chemprop_tpu_torch.cli.parsing import build_datasets, make_datapoints

    parsed = parse_csv(data_dir / "classification/mol.csv", None, None, None)
    ds = build_datasets(make_datapoints(*parsed[:6]))
    loader = DataLoader(ds, batch_size=32, class_balance=True, seed=0)
    assert loader.emitted_order() is None
    sampler = ClassBalanceSampler(ds.Y, 0, False)
    assert len(loader) == math.ceil(len(sampler) / 32)
    rows = [int(b.pad_mask.sum()) for b in loader]
    assert sum(rows) == len(sampler)


def test_event_file_bytes_match_jax(tmp_path, monkeypatch):
    """The same records at a fixed wall time give the JAX writer's bytes."""
    for module in (jax_tbevents, tbevents):
        monkeypatch.setattr(module.time, "time", lambda: 1234567890.25)
    records = [{"epoch": e, "train_loss": 1.5 / (e + 1), "time_s": 0.1, "lr": 1e-3,
                "val_loss": float("nan"), "note": "skipped"} for e in range(3)]
    paths = []
    for module, sub in ((jax_tbevents, "jax"), (tbevents, "port")):
        with module.ScalarEventWriter(tmp_path / sub) as w:
            for e, rec in enumerate(records):
                w.add_scalars(rec, step=e)
            w.add_scalar("big_step", 2.0, 2**40)
            paths.append(w.path)
    jax_bytes, port_bytes = (p.read_bytes() for p in paths)
    assert port_bytes == jax_bytes and len(port_bytes) > 200


def test_crc32c_known_value():
    # the CRC-32C check value (RFC 3720, B.4)
    assert tbevents._crc32c(b"123456789") == 0xE3069283
