"""Extract property rationales with Monte Carlo Tree Search: small
substructures whose predicted property stays high when the rest of the
molecule is deleted (Jin et al., arXiv:2002.03244), their subgraphs scored in
padded batches on the GPU. The port's twin of
``examples/interpreting_with_mcts.py`` (the reference's
``examples/interpreting_monte_carlo_tree_search.ipynb``), through
``chemprop_tpu_torch.interpret.MCTSRationaleExplainer``.

Run: python examples_torch/interpreting_with_mcts.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("interpret_mcts")
    mol_csv = head(DATA / "regression" / "mol" / "mol.csv", out, args.quick)
    run_cli([
        "train", "-i", mol_csv, "--epochs", epochs(2, args.quick), "--batch-size", "64",
        "-o", out,
    ], args.device)

    from chemprop_tpu_torch.interpret import MCTSRationaleExplainer
    from chemprop_tpu_torch.models import load_model

    model, _ = load_model(next(out.rglob("best.ckpt")), args.device)
    explainer = MCTSRationaleExplainer(
        model,
        n_rollout=10,      # MCTS rollouts per molecule
        max_atoms=20,      # rationale must have at most this many atoms
        min_atoms=8,       # stop deleting below this size
        prop_delta=-1e9,   # keep all found substructures (demo model);
                           # set a real threshold for a trained property
        c_puct=10.0,       # exploration constant
        device=args.device,
    )

    smiles = [row["smiles"] for row in csv.DictReader(open(mol_csv))][:3]
    rows = []
    for smi in smiles:
        rationales = explainer.explain(smi)[:3]
        print(f"{smi}:")
        for r in rationales:
            print(f"  score={r['score']:+.3f} n_atoms={r['n_atoms']:2d} {r['smiles']}")
            assert np.isfinite(r["score"])
        rows.append((smi, rationales))
    assert any(r for _, r in rows), "expected rationales for the demo molecules"


if __name__ == "__main__":
    main()
