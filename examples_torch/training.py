"""Train a regression D-MPNN from Python and predict with it, on the GPU.

The port's twin of ``examples/training.py`` (the reference's
``examples/training.ipynb`` + ``predicting.ipynb``: ``MPNN`` on the
100-molecule lipophilicity set) through ``chemprop_tpu_torch``'s library API:
datapoints -> dataset -> DataLoader -> Trainer, with target standardization
baked into the prediction head as an output transform.

Run: python examples_torch/training.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, out_dir, parse_args

from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.data.splitting import make_split_indices, split_data_by_indices
from chemprop_tpu_torch.models import MPNN
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN, UnscaleTransform
from chemprop_tpu_torch.train import Trainer


def main(argv=None):
    args = parse_args(__doc__, argv)
    rows = list(csv.reader(open(DATA / "regression" / "mol" / "mol.csv")))[1:]
    if args.quick:
        rows = rows[:40]
    dps = [MoleculeDatapoint.from_smi(smi, y=np.array([float(y)])) for smi, y in rows]

    # seeded 80/10/10 random split (reference data/splitting.py semantics)
    train_idx, val_idx, test_idx = make_split_indices(
        [d.mol for d in dps], "random", (0.8, 0.1, 0.1), seed=0
    )
    (train_dps,), (val_dps,), (test_dps,) = split_data_by_indices(
        dps, train_idx, val_idx, test_idx
    )

    train = MoleculeDataset(train_dps)
    scaler = train.normalize_targets()  # fit on train only
    val = MoleculeDataset(val_dps)
    val.normalize_targets(scaler)
    test = MoleculeDataset(test_dps)
    for ds in (train, val, test):
        ds.cache = True  # precompute MolGraphs once

    model = MPNN(
        message_passing=BondMessagePassing(),  # d_h=300, depth=3 (reference defaults)
        agg=MeanAggregation(),
        predictor=RegressionFFN(
            output_transform=UnscaleTransform.from_standard_scaler(scaler)
        ),
    )
    n_epochs = 2 if args.quick else 10
    trainer = Trainer(model, max_epochs=n_epochs, checkpoint_dir=out_dir("training") / "ckpts",
                      device=args.device)
    trainer.fit(
        DataLoader(train, batch_size=64, shuffle=True, seed=0),
        val_loader=DataLoader(val, batch_size=64),
    )

    preds = trainer.predict(DataLoader(test, batch_size=64))  # unscaled units
    y = np.array([d.y for d in test_dps]).reshape(-1)
    rmse = float(np.sqrt(np.mean((preds.reshape(-1) - y) ** 2)))
    print(f"test RMSE after {n_epochs} epochs: {rmse:.3f}")
    assert np.isfinite(rmse)


if __name__ == "__main__":
    main()
