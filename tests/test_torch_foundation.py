"""``train --from-foundation`` with a name or a missing path: both command
lines raise ``FileNotFoundError`` saying that only a local checkpoint path is
taken (no foundation model is fetched), and the port raises it before it
reads any data."""

from __future__ import annotations

import pytest

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu_torch.cli.main import main as port_main


@pytest.mark.parametrize("source", ["chemeleon", "missing/model.pt"])
def test_missing_foundation_raises_as_in_jax(data_dir, tmp_path, source):
    argv = ["train", "-i", str(data_dir / "regression/mol/mol.csv"), "--epochs", "1",
            "--from-foundation", source]
    messages = []
    for main, out, extra in ((jax_main, tmp_path / "jax", []),
                             (port_main, tmp_path / "port", ["--device", "cpu"])):
        with pytest.raises(FileNotFoundError) as err:
            main([*argv, "-o", str(out), *extra])
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "expects a local checkpoint path" in messages[1] and source in messages[1]
    assert not (tmp_path / "port").exists()
