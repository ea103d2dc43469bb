"""The loader's isolation of oversized molecules (more than 385 directed
edges, the JAX message kernel's widest window) against the JAX package's on
the CPU, and every consumer that puts rows back in dataset order: the index
batches, ``emitted_order`` and ``len`` of every kind of loader; the
predictions and Monte-Carlo dropout samples of a fixed-order ``predict``; the
mol-atom-bond tables (``restore_mab_order``, ``_regroup_rows``,
``MABTrainer.predict``); ``fingerprint`` of a molecule and of a mol-atom-bond
checkpoint; and a two-epoch shuffled fit. The giants are the JAX tests'
(``"C" * 250`` and ``"C1(CCCCC1)" * 40``), placed in the middle of the
rows. Small size: 16 small molecules, d_h = 32 or 64."""

from __future__ import annotations

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.models.mol_atom_bond import MolAtomBondMPNN as JaxMABMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn.message_passing.mol_atom_bond import MABBondMessagePassing as JaxMABBondMP
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train import mab_trainer as jax_mab_trainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch import data as tdata
from chemprop_tpu_torch.data.collate import Shard
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.models import MPNN, from_jax_params, serialize
from chemprop_tpu_torch.models.mol_atom_bond import MolAtomBondMPNN
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.nn.message_passing import MABBondMessagePassing
from chemprop_tpu_torch.train import Trainer
from chemprop_tpu_torch.train import mab_trainer

SMALL = ["CCO", "c1ccccc1", "CCN", "CC(=O)O"] * 4
GIANTS = ("C" * 250, "C1(CCCCC1)" * 40)  # 498 and 480 directed edges


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mixed_smiles(n_giants: int) -> list[str]:
    """The 16 small molecules with ``n_giants`` giants in the middle."""
    giants = [GIANTS[k % 2] for k in range(n_giants)]
    return SMALL[:8] + giants + SMALL[8:]


def make_datasets(n_giants: int, x_d: bool = True):
    """Each package's dataset of the mixed rows: target ``i % 2`` (the class
    balance's two classes), ``x_d`` the row's index (where ``x_d``), cache
    on."""
    pair = []
    for pkg in (jdata, tdata):
        ds = pkg.MoleculeDataset([
            pkg.MoleculeDatapoint.from_smi(s, y=np.array([float(i % 2)]),
                                           x_d=np.array([float(i)]) if x_d else None)
            for i, s in enumerate(mixed_smiles(n_giants))])
        ds.cache = True
        pair.append(ds)
    return tuple(pair)


_DATASETS: dict = {}


def datasets(n_giants: int):
    """``make_datasets``, made once for each count and never modified."""
    if n_giants not in _DATASETS:
        _DATASETS[n_giants] = make_datasets(n_giants)
    return _DATASETS[n_giants]


def recorded(loader):
    """``loader`` whose collated index batches are listed in ``loader.made``."""
    make, loader.made = loader._make_batch, []

    def made(idxs):
        loader.made.append(list(idxs))
        return make(idxs)

    loader._make_batch = made
    return loader


def real_rows(batch, n_shards: int) -> list[list[float]]:
    """The row indices (``x_d``) in each shard of a JAX batch or a port
    ``Shard`` / batch, padding cut."""
    if isinstance(batch, Shard):
        return [batch.batch.X_d[:, 0][torch.from_numpy(batch.batch.pad_mask)].tolist()]
    if not n_shards:
        return [np.asarray(batch.X_d)[:, 0][np.asarray(batch.pad_mask)].tolist()]
    X = np.asarray(batch.X_d)[..., 0]
    mask = np.asarray(batch.pad_mask).reshape(X.shape)
    return [X[k][mask[k]].tolist() for k in range(n_shards)]


@pytest.mark.parametrize("n_shards", [0, 2])
@pytest.mark.parametrize("giants", ["none", "one", "batch_plus_one"])
@pytest.mark.parametrize("batch_size", [1, 4, 8])
@pytest.mark.parametrize("drop_last", [False, True], ids=["keep_last", "drop_last"])
@pytest.mark.parametrize("kind", ["fixed", "shuffled", "class_balance"])
def test_loader_batches_match_jax(kind, drop_last, batch_size, giants, n_shards):
    """The same index batches in two epochs, the same ``emitted_order`` and
    ``len``, and the same rows in each batch (each shard's with shards)."""
    n_giants = {"none": 0, "one": 1, "batch_plus_one": batch_size + 1}[giants]
    jds, tds = datasets(n_giants)
    kw = dict(batch_size=batch_size, drop_last=drop_last, prefetch=0, n_shards=n_shards,
              shuffle=kind == "shuffled", class_balance=kind == "class_balance",
              seed=0 if kind != "fixed" else None)
    jl = recorded(jdata.DataLoader(jds, **kw))
    tls = [recorded(tdata.DataLoader(tds, **kw, shard_index=k)) for k in range(max(n_shards, 1))]
    assert len(tls[0]) == len(jl)
    if kind == "fixed":
        want = jl.emitted_order()
        got = tls[0].emitted_order()
        np.testing.assert_array_equal(got, want)
        assert sorted(want.tolist()) == sorted(range(len(jds))) or drop_last
    else:
        assert tls[0].emitted_order() is None and jl.emitted_order() is None
    for _ in range(2):  # a shuffled loader draws another order each epoch
        jrows = [real_rows(b, n_shards) for b in jl]
        trows = [[real_rows(b, n_shards)[0] for b in tl] for tl in tls]
        assert all(tl.made == jl.made for tl in tls)
        for j, batch in enumerate(jrows):
            assert [t[j] for t in trows] == batch
        for loader in (jl, *tls):
            loader.made = []
    giant_rows = {i for i, s in enumerate(mixed_smiles(n_giants)) if s in GIANTS}
    for idxs in tls[0]._index_batches() if kind == "fixed" else []:
        # a batch is all giants or holds none
        assert {i in giant_rows for i in idxs} in ({True}, {False})


def test_isolation_emits_one_batch_more_than_len_in_both_packages():
    """Five small molecules and a giant in batches of 4: the small ones fill
    one batch and leave one, the giant makes a third, where ``len`` (the JAX
    formula, which ``fit`` hands the Noam schedule) counts two. A fault of
    the JAX package that the port keeps (ROADMAP.md section 3)."""
    smis = ["CCO", "CCN", "C" * 250, "CCC", "CCCl", "CCBr"]
    loaders = [pkg.DataLoader(pkg.MoleculeDataset([pkg.MoleculeDatapoint.from_smi(
        s, y=np.zeros(1)) for s in smis]), batch_size=4, prefetch=0) for pkg in (jdata, tdata)]
    for loader in loaders:
        assert len(loader) == 2
        assert list(loader._index_batches()) == [[0, 1, 3, 4], [5], [2]]


def test_isolation_reads_the_datum_mol_only():
    """Reactions have no ``.mol``: never isolated, as in the JAX loader; and
    ``_isolate_oversized = False`` turns it off in both."""
    rxn = "[CH3:1][OH:2]>>[CH2:1]=[OH+:2]"
    for pkg in (jdata, tdata):
        ds = pkg.ReactionDataset([pkg.ReactionDatapoint.from_smi(rxn, y=np.zeros(1))] * 3)
        assert list(pkg.DataLoader(ds, batch_size=2)._index_batches()) == [[0, 1], [2]]
    jds, tds = datasets(1)
    for ds, pkg in ((jds, jdata), (tds, tdata)):
        loader = pkg.DataLoader(ds, batch_size=8)
        loader._isolate_oversized = False
        assert list(loader._index_batches())[1] == list(range(8, 16))


# ----------------------------------------------------------------- predict
D_H = 64


def _models(batch_norm: bool, depth: int = 3):
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=D_H, depth=depth), agg=JaxMean(),
                     predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H), batch_norm=batch_norm)
    model = MPNN(BondMessagePassing(d_h=D_H, depth=depth), MeanAggregation(),
                 RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
                 batch_norm=batch_norm)
    return jmodel, model


def _carried(jds, steps_per_epoch: int, n_steps: int = 0, batch_norm: bool = True):
    """Both trainers with JAX's initial parameters, after ``n_steps`` JAX
    steps on the first batch of 8 (which move the batch-norm statistics off
    their defaults, so that inference reads them)."""
    jmodel, model = _models(batch_norm)
    jtrainer = JaxTrainer(jmodel, max_epochs=2, warmup_epochs=1, seed=3)
    jb = next(iter(jdata.DataLoader(jds, batch_size=8, prefetch=0)))
    state = jtrainer.init_state(jb, steps_per_epoch)
    for _ in range(n_steps):
        state, _ = jax.jit(jtrainer._train_body())(state, jb)
    jtrainer.state = state
    trainer = Trainer(model, max_epochs=2, warmup_epochs=1, seed=3, device="cpu")
    trainer.init_state(None, steps_per_epoch)
    model.load_state_dict(from_jax_params(state.params, state.batch_stats or None))
    return jtrainer, trainer, {"params": state.params, "batch_stats": state.batch_stats}


def test_predict_and_mc_dropout_in_dataset_order():
    """A fixed-order ``predict`` over rows with two giants in the middle, in
    batches of 8, is its batches' outputs put back in dataset order, bit for
    bit; it equals the same model's predictions one molecule at a time
    within 1e-6 (f32 on the CPU: a product over 8 rows and over 1 may round
    apart, by 4.5e-08 here), and JAX's ``predict`` from the same weights
    within PERF.md's f32 limit (rtol 1e-5, atol 1e-4); each Monte-Carlo
    dropout sample (dropout 0: the prediction) too."""
    jds, tds = make_datasets(2, x_d=False)
    jtrainer, trainer, variables = _carried(jds, 3, n_steps=1)
    loader = tdata.DataLoader(tds, batch_size=8)
    got = trainer.predict(loader)
    with torch.inference_mode():
        emitted = np.concatenate([trainer.model(b.bmg, b.V_d, b.X_d).numpy()[b.pad_mask]
                                  for b in loader])
    order = loader.emitted_order()
    assert order.tolist() == [*range(8), *range(10, 18), 8, 9]
    np.testing.assert_array_equal(got, emitted[np.argsort(order)])
    one = trainer.predict(tdata.DataLoader(tds, batch_size=1))
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6)
    want = jtrainer.predict(jdata.DataLoader(jds, batch_size=8, prefetch=0), variables)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    samples = trainer.predict_mc_dropout(loader, sampling_size=2)
    np.testing.assert_array_equal(samples, np.stack([got, got]))


# -------------------------------------------------------------- mol-atom-bond
MAB_SMALL = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "CCCCO"]


def _mab_points(pkg):
    def dp(smi):
        mol = make_mol(smi, keep_h=False, add_h=False)
        return pkg.MolAtomBondDatapoint.from_smi(smi, y=np.array([1.0]),
                                                 atom_y=np.zeros((mol.num_atoms, 1)),
                                                 bond_y=np.zeros((mol.num_bonds, 1)))

    smis = MAB_SMALL[:2] + [GIANTS[1]] + MAB_SMALL[2:]  # JAX's mixed dataset
    ds = pkg.MolAtomBondDataset([dp(s) for s in smis])
    ds.cache = True
    return ds


@pytest.fixture(scope="module")
def mab_pair():
    """Each package's mixed MAB dataset and model, the port's weights seeded
    and carried to JAX."""
    d = 32
    model = MolAtomBondMPNN(
        MABBondMessagePassing(d_h=d), MeanAggregation(),
        mol_predictor=RegressionFFN(n_tasks=1, input_dim=d, hidden_dim=d),
        atom_predictor=RegressionFFN(n_tasks=1, input_dim=d, hidden_dim=d),
        bond_predictor=RegressionFFN(n_tasks=1, input_dim=2 * d, hidden_dim=d))
    init_parameters(model, "lecun", torch.Generator().manual_seed(7))
    jmodel = JaxMABMPNN(
        message_passing=JaxMABBondMP(d_h=d), agg=JaxMean(),
        mol_predictor=JaxRegressionFFN(n_tasks=1, input_dim=d, hidden_dim=d),
        atom_predictor=JaxRegressionFFN(n_tasks=1, input_dim=d, hidden_dim=d),
        bond_predictor=JaxRegressionFFN(n_tasks=1, input_dim=2 * d, hidden_dim=d))
    params = serialize.to_jax_params(dict(model.named_parameters()))["params"]
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    return model, jmodel, variables, _mab_points(tdata), _mab_points(jdata)


def _tables(rng, counts, order):
    """Tables of per-molecule groups as the loader emitted them in
    ``order``: 3 mol columns, group sizes ``counts``, 2 columns each."""
    n = len(order)
    return (rng.standard_normal((n, 3)),
            rng.standard_normal((int(np.asarray(counts)[order].sum()), 2)))


@pytest.mark.parametrize("case", ["permuted", "drop_last", "identity", "untiled", "zero_atoms"])
def test_regroup_rows_matches_jax(case):
    rng = np.random.default_rng(5)
    counts = [3, 1, 4, 2, 5]
    order = {"permuted": [0, 1, 3, 4, 2], "drop_last": [0, 1, 3], "identity": [0, 1, 2, 3, 4],
             "untiled": [4, 0, 1, 2, 3], "zero_atoms": [1, 2, 0, 3, 4]}[case]
    if case == "zero_atoms":
        counts = [max(1, c) for c in [0, 2, 0, 1, 3]]  # one zero node row each
    order = np.asarray(order)
    _, arr = _tables(rng, counts, order)
    if case == "untiled":
        arr = arr[:-1]
    got = mab_trainer._regroup_rows(arr, order, counts)
    np.testing.assert_array_equal(got, jax_mab_trainer._regroup_rows(arr, order, counts))
    if case == "untiled":
        assert got is arr
    else:
        starts = np.concatenate([[0], np.cumsum(np.asarray(counts)[order])])
        pos = {int(i): k for k, i in enumerate(order)}
        want = np.concatenate([arr[starts[pos[i]]:starts[pos[i] + 1]] for i in sorted(pos)])
        np.testing.assert_array_equal(got, want)


class _Loader:
    def __init__(self, dataset, order):
        self.dataset, self._order = dataset, order

    def emitted_order(self):
        return None if self._order is None else np.asarray(self._order)


@pytest.mark.parametrize("case", ["isolated", "drop_last", "identity", "none"])
def test_restore_mab_order_matches_jax(mab_pair, case):
    """The port's ``restore_mab_order`` returns JAX's arrays on the same
    loader order and tables, the no-op cases returned untouched."""
    *_, tds, jds = mab_pair
    order = {"isolated": [0, 1, 3, 4, 5, 2], "drop_last": [0, 1, 3, 4],
             "identity": list(range(6)), "none": None}[case]
    rng = np.random.default_rng(11)
    emitted = order if order is not None else list(range(6))
    atoms = [max(1, d.mol.num_atoms) for d in tds.data]
    bonds = [d.mol.num_bonds for d in tds.data]
    mol = rng.standard_normal((len(emitted), 1))
    atom = rng.standard_normal((sum(atoms[i] for i in emitted), 1))
    bond = rng.standard_normal((sum(bonds[i] for i in emitted), 2))
    got = mab_trainer.restore_mab_order(_Loader(tds, order), mol, atom, bond)
    want = jax_mab_trainer.restore_mab_order(_Loader(jds, order), mol, atom, bond)
    for g, w, x in zip(got, want, (mol, atom, bond)):
        np.testing.assert_array_equal(g, w)
        if case in ("identity", "none"):
            assert g is x
    assert mab_trainer.restore_mab_order(_Loader(tds, order), None, None, None) == (None,) * 3


@pytest.mark.parametrize("drop_last", [False, True], ids=["keep_last", "drop_last"])
def test_mab_predict_in_dataset_order(mab_pair, drop_last):
    """``MABTrainer.predict`` over JAX's mixed dataset (the giant third of
    six) in batches of 4 equals the port's batch-size-1 predictions, in
    ascending dataset order under ``drop_last``, and JAX's ``predict`` on the
    same loader within 2e-4 (the JAX test's limit)."""
    model, jmodel, variables, tds, jds = mab_pair
    trainer = mab_trainer.MABTrainer(model, device="cpu")
    trainer.init_state(None, 1, keep_parameters=True)
    got = trainer.predict(tdata.DataLoader(tds, batch_size=4, drop_last=drop_last))
    one = trainer.predict(tdata.DataLoader(tds, batch_size=1))
    want = jax_mab_trainer.MABTrainer(jmodel).predict(
        jdata.DataLoader(jds, batch_size=4, prefetch=0, drop_last=drop_last), variables)
    keep = [0, 1, 3, 4] if drop_last else list(range(6))
    atoms = np.concatenate([[0], np.cumsum([d.mol.num_atoms for d in tds.data])])
    bonds = np.concatenate([[0], np.cumsum([d.mol.num_bonds for d in tds.data])])
    ref = (one[0][keep], np.concatenate([one[1][atoms[i]:atoms[i + 1]] for i in keep]),
           np.concatenate([one[2][bonds[i]:bonds[i + 1]] for i in keep]))
    for kind, g, r, w in zip(("mol", "atom", "bond"), got, ref, want):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=kind)
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=kind)
    samples = trainer.predict_mc_dropout(tdata.DataLoader(tds, batch_size=4), sampling_size=1)
    for kind, s, r in zip(("mol", "atom", "bond"), samples, one):
        np.testing.assert_allclose(s[0], r, rtol=1e-5, atol=1e-6, err_msg=kind)


# --------------------------------------------------------------- fingerprint
@pytest.fixture
def made_batches(monkeypatch):
    """Every index batch either package's loader collates, by package."""
    made = {"jax": [], "port": []}
    for name, cls in (("jax", jdata.DataLoader), ("port", tdata.DataLoader)):
        make = cls._make_batch

        def record(self, idxs, _make=make, _name=name):
            made[_name].append(list(idxs))
            return _make(self, idxs)

        monkeypatch.setattr(cls, "_make_batch", record)
    return made


def _giant_csv(path, data_dir, n: int = 12, mab: bool = False):
    with open(data_dir / "regression/mol/mol.csv", newline="") as f:
        rows = list(csv.reader(f))[: n + 1]
    rows.insert(1 + n // 2, [GIANTS[1], "0.5"])
    if mab:
        rows = [["smiles"]] + [[r[0]] for r in rows[1:]]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def test_fingerprint_rows_in_jax_order(data_dir, tmp_path, made_batches):
    """``fingerprint`` of the reference checkpoint on 12 rows of mol.csv with
    a giant in the middle, in batches of 4: JAX's batches, JAX's rows in
    JAX's order within 1e-5."""
    in_csv = _giant_csv(tmp_path / "in.csv", data_dir)
    ckpt = data_dir / "example_model_v2_regression_mol.pt"
    jax_ckpt = tmp_path / "model.ckpt"
    assert jax_main(["convert", "-i", str(ckpt), "-o", str(jax_ckpt)]) in (0, None)
    outs = {"port": tmp_path / "p.csv", "jax": tmp_path / "j.csv"}
    assert port_main(["fingerprint", "-i", str(in_csv), "--model-paths", str(ckpt), "-o",
                      str(outs["port"]), "-b", "4", "--device", "cpu"]) == 0
    assert jax_main(["fingerprint", "-i", str(in_csv), "--model-paths", str(jax_ckpt), "-o",
                     str(outs["jax"]), "-b", "4"]) in (0, None)
    assert made_batches["port"] == made_batches["jax"]
    assert [6] in made_batches["port"]  # the giant, alone
    tables = {}
    for k, path in outs.items():
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        tables[k] = rows[0], [r[0] for r in rows[1:]], np.array(
            [[float(x) for x in r[1:]] for r in rows[1:]])
    assert tables["port"][:2] == tables["jax"][:2]
    assert tables["port"][1][6] == GIANTS[1]
    np.testing.assert_allclose(tables["port"][2], tables["jax"][2], rtol=1e-5, atol=1e-5)


def test_mab_fingerprint_rows_in_jax_order(data_dir, tmp_path, made_batches):
    """``fingerprint`` of the reference mol-atom-bond regression checkpoint on
    the same rows: JAX's batches, and each kind's table equal to JAX's in
    dataset order (the atom and bond rows grouped by molecule) within
    2e-4."""
    in_csv = _giant_csv(tmp_path / "in.csv", data_dir, mab=True)
    ckpt = data_dir / "mol_atom_bond/example_models/regression.pt"
    jax_ckpt = tmp_path / "mab.ckpt"
    assert jax_main(["convert", "-i", str(ckpt), "-o", str(jax_ckpt)]) in (0, None)
    outs = {"port": tmp_path / "p.npz", "jax": tmp_path / "j.npz"}
    assert port_main(["fingerprint", "-i", str(in_csv), "--model-paths", str(ckpt), "-o",
                      str(outs["port"]), "-b", "4", "--device", "cpu"]) == 0
    assert jax_main(["fingerprint", "-i", str(in_csv), "--model-paths", str(jax_ckpt), "-o",
                     str(outs["jax"]), "-b", "4"]) in (0, None)
    assert made_batches["port"] == made_batches["jax"] and [6] in made_batches["port"]
    got, want = (dict(np.load(outs[k])) for k in ("port", "jax"))
    assert sorted(got) == sorted(want) == ["atom", "bond", "mol"]
    for kind in want:
        assert got[kind].shape == want[kind].shape, kind
        np.testing.assert_allclose(got[kind], want[kind], rtol=2e-4, atol=2e-4, err_msg=kind)


# ---------------------------------------------------------------------- fit
def test_shuffled_fit_with_giants_matches_jax():
    """Two epochs of a shuffled float32 fit, batches of 4, over the 16 small
    molecules and two giants, from JAX's initial parameters: the same
    batches, epoch losses at rtol 1e-5, and every parameter and batch-norm
    statistic within ``test_three_adam_steps_match_jax_f32``'s limits for the
    ten steps. Without batch norm: over the giants' batch of two graphs it
    turns the f32 rounding of one step into 0.6% of the second epoch's loss
    in either package."""
    jds, tds = make_datasets(2, x_d=False)
    for ds in (jds, tds):
        ds.normalize_targets()
    jl = jdata.DataLoader(jds, batch_size=4, shuffle=True, seed=0, prefetch=0)
    tl = tdata.DataLoader(tds, batch_size=4, shuffle=True, seed=0, prefetch=0)
    assert len(jl) == len(tl) == 5
    jtrainer, trainer, _ = _carried(jds, len(jl), batch_norm=False)
    next(iter(tl))  # JAX's fit draws its first batch (an epoch's shuffle) before epoch 0
    jtrainer.fit(jl)
    trainer.fit(tl)
    jlosses = [h["train_loss"] for h in jtrainer.history]
    tlosses = [h["train_loss"] for h in trainer.history]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = from_jax_params(jtrainer.state.params, jtrainer.state.batch_stats)
    got = {k: v.detach() for k, v in trainer.model.state_dict().items()}
    lrs = sum(noam_lr_host(k, 5, 5, 1e-4, 1e-3, 1e-4) for k in range(10))
    n_bad = n_all = 0
    for name in want:
        err = (got[name] - want[name]).abs()
        assert float(err.max()) <= 2 * lrs, name
        n_bad += int((err > 1e-6 + 1e-4 * want[name].abs()).sum())
        n_all += err.numel()
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)
