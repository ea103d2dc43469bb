"""The port's command-line parser against the JAX package's, on the CPU:
every subcommand has the same options, each with the same flags, default,
``nargs`` and choices, apart from the port's own ``--device`` and
``--dtype``. Fault (j) of ``ROADMAP.md``: ``--molecule-featurizers`` takes
the registry's names as its choices, so that an unknown name exits with
argparse's status 2 and "invalid choice" before any file is read."""

from __future__ import annotations

import argparse

import pytest

from chemprop_tpu.cli.main import construct_parser as jax_parser
from chemprop_tpu_torch.cli.main import construct_parser, main
from chemprop_tpu_torch.featurizers.molecule import MoleculeFeaturizerRegistry

PORT_ONLY = ("device", "dtype")
FEATURIZER_SUBCOMMANDS = ("train", "predict", "fingerprint", "hpopt")


def _options(parser) -> dict:
    """``{subcommand: {dest: (flags, default, nargs, choices)}}``."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (sorted(a.option_strings), repr(a.default), a.nargs,
                            None if a.choices is None else [repr(c) for c in a.choices])
                   for a in sp._actions if not isinstance(a, argparse._HelpAction)}
            for name, sp in sub.choices.items()}


JAX_OPTIONS, PORT_OPTIONS = _options(jax_parser()), _options(construct_parser())


@pytest.mark.parametrize("name", sorted(JAX_OPTIONS))
def test_subcommand_options_equal_jax(name):
    want, got = JAX_OPTIONS[name], PORT_OPTIONS[name]
    assert set(got) - set(want) == {d for d in PORT_ONLY if d in got}
    assert set(want) <= set(got)
    for dest, option in want.items():
        assert got[dest] == option, dest


@pytest.mark.parametrize("name", FEATURIZER_SUBCOMMANDS)
def test_molecule_featurizers_take_the_registry_choices(name):
    flags, _, nargs, choices = PORT_OPTIONS[name]["molecule_featurizers"]
    assert flags == ["--features-generators", "--molecule-featurizers"] and nargs == "+"
    assert choices == [repr(k) for k in sorted(MoleculeFeaturizerRegistry.keys())]


@pytest.mark.parametrize("name", FEATURIZER_SUBCOMMANDS)
def test_an_unknown_featurizer_exits_2_before_reading(tmp_path, capsys, name):
    missing = tmp_path / "absent.csv"  # a read would fail on it with another error
    argv = [name, "-i", str(missing), "--molecule-featurizers", "morgan_binary", "bogus",
            "--device", "cpu"]
    if name in ("predict", "fingerprint"):
        argv += ["--model-paths", str(tmp_path / "absent.ckpt")]
    with pytest.raises(SystemExit) as exit_:
        main(argv)
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice: 'bogus'" in err and "absent" not in err
