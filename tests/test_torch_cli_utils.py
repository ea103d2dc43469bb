"""The port's ``cli.utils`` and its ``Subcommand``-built parser, against the
JAX package on the CPU.

* ``chemprop_tpu_torch.cli.utils`` exports every name of
  ``chemprop_tpu.cli.utils`` (and each module's ``__all__``); the helpers
  give JAX's results (``tests/unit/cli/test_cli_utils.py``'s cases, and
  ``format_probability_string`` on seeded arrays, equal strings);
* ``get_column_names``, ``build_data_from_files`` and
  ``build_MAB_data_from_files`` on the repo's CSVs and side files give
  JAX's columns, and datapoints with the same SMILES, targets, bounds,
  weights and extra inputs (equal within one float64 ulp, NaN where NaN:
  pandas's float parser, which JAX reads with, is not correctly rounded). JAX's
  ``build_MAB_data_from_files`` raises on every call (its arguments lack the
  loss), so the port's is held to JAX's own ``build_MAB_datapoints`` with
  the loss given;
* each CLI module has its ``*Subcommand`` and the JAX names of its parser
  function; ``construct_parser`` builds from them, ``--version`` prints the
  package's version, and every subcommand's options (flags, destinations,
  actions, nargs, defaults, constants, choices, types, required) equal the
  list taken from the parser before it was built from the classes
  (tests/data/torch_cli_options.json)."""

from __future__ import annotations

import argparse
import json

import numpy as np
import pytest

import chemprop_tpu.cli.utils as jutils
import chemprop_tpu_torch.cli.utils as tutils
from chemprop_tpu.cli.mab import build_MAB_datapoints as jax_build_MAB_datapoints
from chemprop_tpu_torch.cli import convert, fingerprint, hpopt, predict, serve, train
from chemprop_tpu_torch.cli.main import construct_parser

REG = "regression/mol/mol.csv"
MM = "regression/mol+mol/mol+mol.csv"
RXN = "regression/rxn+mol/rxn+mol.csv"


def test_every_jax_name_is_exported():
    assert set(jutils.__all__) <= set(tutils.__all__)
    for name in jutils.__all__:
        assert hasattr(tutils, name), name
    for module in ("actions", "args", "command", "parsing", "utils"):
        assert getattr(tutils, module).__all__ == getattr(jutils, module).__all__, module


def test_helpers_give_jax_results():
    for pkg in (jutils, tutils):
        assert pkg.parse_indices("0,1,2-4") == [0, 1, 2, 3, 4]
        assert pkg.parse_indices([3, 4]) == [3, 4]
        f = pkg.bounded(lo=0.0, hi=1.0)(float)
        assert f("0.5") == 0.5
        for bad in ("1.5", "-0.1"):
            with pytest.raises(ValueError):
                f(bad)
        with pytest.raises(ValueError):
            pkg.bounded()
        for arg in ("0.1", "negative_slope=0.1", "flag=true", "n=3", "name=elu"):
            assert pkg.activation_function_argument(arg) == \
                jutils.activation_function_argument(arg)
        assert pkg.args.uppercase("relu") == "RELU" and pkg.args.lowercase("ReLU") == "relu"
        made = pkg.parse_activation(lambda x, y=0: (x, y), [1.5, {"y": 2}])
        assert made == (1.5, 2)
        ns = argparse.Namespace(a=1)
        assert pkg.pop_attr(ns, "a") == 1 and not hasattr(ns, "a")
        assert pkg.pop_attr(ns, "a", 42) == 42 and pkg._pop_attr_d(ns, "a") is None
        with pytest.raises(AttributeError):
            pkg._pop_attr(ns, "a")
    probs = np.random.default_rng(0).dirichlet(np.ones(3), size=(4, 2))
    np.testing.assert_array_equal(tutils.format_probability_string(probs),
                                  jutils.format_probability_string(probs))


def test_lookup_action_and_subcommand_base():
    parser = argparse.ArgumentParser()
    parser.add_argument("--agg", action=tutils.LookupAction({"mean": 1, "sum": 2}),
                        default="mean")
    assert parser.parse_args([]).agg == "mean"
    assert parser.parse_args(["--agg", "sum"]).agg == "sum"
    with pytest.raises(SystemExit):
        parser.parse_args(["--agg", "bogus"])
    with pytest.raises(ValueError):
        parser.add_argument("--bad", action=tutils.LookupAction({"a": 1}), default="zzz")

    class Echo(tutils.Subcommand):
        COMMAND = "echo"

        @classmethod
        def add_args(cls, parser):
            parser.add_argument("--x", type=int, default=1)
            return parser

        @classmethod
        def func(cls, args):
            return args.x * 2

    parser = argparse.ArgumentParser()
    Echo.add(parser.add_subparsers())
    args = parser.parse_args(["echo", "--x", "21"])
    assert args.func(args) == 42
    with pytest.raises(TypeError):
        tutils.Subcommand()


@pytest.mark.parametrize("rel,kwargs", [
    (REG, {}),
    (MM, dict(smiles_cols=["smiles", "solvent"])),
    (RXN, dict(smiles_cols=["solvent_smiles"], rxn_cols=["rxn_smiles"])),
    ("classification/mol_multiclass.csv", dict(ignore_cols=["smiles"])),
    ("mol_atom_bond/regression.csv", dict(weight_col="weight")),
    (REG, dict(no_header_row=True)),
], ids=["mol", "mol_mol", "rxn_mol", "ignored", "weight", "no_header"])
def test_get_column_names_equals_jax(data_dir, rel, kwargs):
    assert tutils.get_column_names(data_dir / rel, **kwargs) == jutils.get_column_names(
        data_dir / rel, **kwargs)


def _value(x):
    return None if x is None else np.asarray(x, dtype=np.float64)


def _same_datapoints(got, want, fields):
    """Equal names, and each field of ``fields`` that the datapoints have
    equal within one float64 ulp (NaN where NaN): pandas's float parser,
    which the JAX package reads the CSVs with, is not correctly rounded and
    may put a value one ulp from Python's ``float`` of the same cell."""
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert g.name == w.name
        for field in (f for f in fields if hasattr(g, f)):
            a, b = _value(getattr(g, field)), _value(getattr(w, field))
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)), field
                ok = np.isnan(a) | (np.abs(a - b) <= np.spacing(np.fmax(np.abs(a), np.abs(b))))
                assert ok.all(), (field, a, b)


# (CSV, keyword arguments with side files under the CSV's folder)
FILES = {
    "mol": (REG, {}),
    "mol_extras": (REG, dict(p_descriptors="descriptors.npz", p_atom_feats="atom_features.npz",
                             p_bond_feats="bond_features.npz",
                             p_atom_descs="atom_descriptors.npz")),
    "mol_mol": (MM, dict(smiles_cols=["smiles", "solvent"], p_descriptors="descriptors.npz",
                         p_atom_feats={0: "atom_features_0.npz"},
                         p_bond_feats={0: "bond_features_0.npz"})),
    "rxn_mol": (RXN, dict(smiles_cols=["solvent_smiles"], rxn_cols=["rxn_smiles"])),
    "bounded": ("mol_atom_bond/bounded.csv", dict(
        smiles_cols=["smiles"], target_cols=["mol_y1", "mol_y2"], weight_col="weight",
        bounded=True)),
    "weights": ("mol_atom_bond/regression.csv", dict(
        target_cols=["mol_y1", "mol_y2"], weight_col="weight", keep_h=True)),
}
SIDE_FILES = ("p_descriptors", "p_atom_feats", "p_bond_feats", "p_atom_descs")


@pytest.mark.parametrize("case", sorted(FILES))
def test_build_data_from_files_equals_jax(data_dir, case):
    rel, kwargs = FILES[case]
    folder = (data_dir / rel).parent
    kwargs = {k: ({i: folder / p for i, p in v.items()} if isinstance(v, dict) else folder / v)
              if k in SIDE_FILES else v for k, v in kwargs.items()}
    got = tutils.build_data_from_files(data_dir / rel, **kwargs)
    want = jutils.build_data_from_files(data_dir / rel, **kwargs)
    assert len(got) == len(want) >= 1
    fields = ("y", "weight", "lt_mask", "gt_mask", "x_d", "V_f", "E_f", "V_d")
    for comp_got, comp_want in zip(got, want, strict=True):
        assert [type(d).__name__ for d in comp_got] == [type(d).__name__ for d in comp_want]
        _same_datapoints(comp_got, comp_want, fields)


# the MAB CSVs and their arguments (keyword names of build_MAB_data_from_files)
MAB = {
    "regression": ("regression.csv", dict(
        target_cols=["mol_y1", "mol_y2"], atom_target_cols=["atom_y1", "atom_y2"],
        bond_target_cols=["bond_y1", "bond_y2"], weight_col="weight", keep_h=True,
        reorder_atoms=True)),
    "constrained": ("constrained_regression.csv", dict(
        target_cols=["mol_y"], atom_target_cols=["atom_y1", "atom_y2"],
        bond_target_cols=["bond_y1", "bond_y2"], keep_h=True, reorder_atoms=True,
        p_constraints="constrained_regression_constraints.csv",
        p_descriptors="descriptors.npz", p_atom_feats="atom_features_descriptors.npz",
        p_bond_feats="bond_features_descriptors.npz")),
    "bounded": ("bounded.csv", dict(
        target_cols=["mol_y1", "mol_y2"], atom_target_cols=["atom_y1", "atom_y2"],
        bond_target_cols=["bond_y1", "bond_y2"], weight_col="weight", keep_h=True,
        bounded=True)),
}


@pytest.mark.parametrize("case", sorted(MAB))
def test_build_mab_data_from_files_equals_jax_parsing(data_dir, case):
    name, kwargs = MAB[case]
    folder = data_dir / "mol_atom_bond"
    kwargs = {k: folder / v if k.startswith("p_") else v for k, v in kwargs.items()}
    bounded = kwargs.pop("bounded", False)
    with pytest.raises(AttributeError, match="loss_function"):
        jutils.build_MAB_data_from_files(folder / name, **kwargs)
    got = tutils.build_MAB_data_from_files(folder / name, bounded=bounded, **kwargs)
    args = argparse.Namespace(
        data_path=folder / name, smiles_columns=None, target_columns=kwargs.get("target_cols"),
        atom_target_columns=kwargs.get("atom_target_cols"),
        bond_target_columns=kwargs.get("bond_target_cols"),
        weight_column=kwargs.get("weight_col"), constraints_path=kwargs.get("p_constraints"),
        constraints_to_targets=None, descriptors_path=kwargs.get("p_descriptors"),
        atom_features_path=kwargs.get("p_atom_feats"),
        bond_features_path=kwargs.get("p_bond_feats"), atom_descriptors_path=None,
        bond_descriptors_path=None, keep_h=kwargs.get("keep_h", False), add_h=False,
        ignore_stereo=False, reorder_atoms=kwargs.get("reorder_atoms", False),
        loss_function="bounded-mse" if bounded else None)
    want = jax_build_MAB_datapoints(args)[0]
    _same_datapoints(got, want, (
        "y", "weight", "lt_mask", "gt_mask", "x_d", "V_f", "E_f", "V_d", "E_d", "atom_y",
        "bond_y", "atom_constraints", "bond_constraints", "atom_lt_mask", "atom_gt_mask",
        "bond_lt_mask", "bond_gt_mask"))


SUBCOMMANDS = {
    "train": (train, "TrainSubcommand", "add_train_args"),
    "predict": (predict, "PredictSubcommand", "add_predict_args"),
    "fingerprint": (fingerprint, "FingerprintSubcommand", "add_fingerprint_args"),
    "convert": (convert, "ConvertSubcommand", "add_convert_args"),
    "serve": (serve, "ServeSubcommand", "add_serve_args"),
    "hpopt": (hpopt, "HpoptSubcommand", "add_hpopt_args"),
}


@pytest.mark.parametrize("name", list(SUBCOMMANDS))
def test_each_module_has_its_subcommand(name):
    module, cls_name, jax_name = SUBCOMMANDS[name]
    cmd = getattr(module, cls_name)
    assert issubclass(cmd, tutils.Subcommand) and cmd.COMMAND == name
    assert cmd.add_args is module.add_args is getattr(module, jax_name)
    assert cmd.func is module.main
    parser = argparse.ArgumentParser()
    sub = cmd.add(parser.add_subparsers(dest="mode"))
    assert [a.dest for a in sub._actions] == [
        a.dest for a in module.add_args(argparse.ArgumentParser())._actions]


def _options(parser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: [{"flags": list(a.option_strings), "dest": a.dest,
                    "action": type(a).__name__, "nargs": a.nargs, "default": repr(a.default),
                    "const": repr(a.const),
                    "choices": None if a.choices is None else [repr(c) for c in a.choices],
                    "type": getattr(a.type, "__name__", repr(a.type)), "required": a.required}
                   for a in sp._actions if not isinstance(a, argparse._HelpAction)]
            for name, sp in sub.choices.items()}


def test_parser_built_from_the_classes_keeps_every_option(data_dir):
    parser = construct_parser()
    got = _options(parser)
    want = json.loads((data_dir / "torch_cli_options.json").read_text())
    assert list(got) == ["train", "predict", "fingerprint", "convert", "serve", "hpopt"]
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    for name, (module, cls_name, _) in SUBCOMMANDS.items():
        args = sub.choices[name].parse_args(
            {"convert": ["-i", "x.pt"], "serve": ["--model-paths", "x.ckpt"]}.get(
                name, ["-i", "x.csv"] + (["--model-paths", "x"] if name in (
                    "predict", "fingerprint") else [])))
        assert args.func == getattr(module, cls_name).func


def test_version(capsys):
    from chemprop_tpu_torch import __version__

    with pytest.raises(SystemExit) as exit_:
        construct_parser().parse_args(["--version"])
    assert exit_.value.code == 0
    assert capsys.readouterr().out.strip() == __version__
