"""Interpret a trained model with Myerson values: exact per-atom attributions
of the prediction (the game-theoretic contribution of each atom over
connected subgraphs), every subgraph scored on the GPU. The port's twin of
``examples/interpreting_with_myerson_values.py`` (reference
``chemprop/callbacks/interpret.py:25``).

Run: python examples_torch/interpreting_with_myerson_values.py [--device cuda] [--quick]
"""

import numpy as np

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("interpret")
    mol_csv = head(DATA / "regression" / "mol" / "mol.csv", out, args.quick)
    run_cli([
        "train", "-i", mol_csv, "--epochs", epochs(2, args.quick), "--batch-size", "64",
        "-o", out,
    ], args.device)

    from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset
    from chemprop_tpu_torch.interpret import MyersonExplainer
    from chemprop_tpu_torch.models import load_model

    model, _ = load_model(next(out.rglob("best.ckpt")), args.device)
    ds = MoleculeDataset([MoleculeDatapoint.from_smi("CC(=O)Oc1ccccc1C(=O)O", y=np.zeros(1))])
    mg = ds[0].mg
    phi = MyersonExplainer(model, device=args.device).explain(mg)
    print("aspirin per-atom Myerson values:", np.round(phi.reshape(-1), 3))
    assert phi.shape[0] == mg.V.shape[0]


if __name__ == "__main__":
    main()
