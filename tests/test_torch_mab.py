"""Mol-atom-bond (MAB) models of the port against the JAX package on the CPU
(its plain path, no interpret mode): every layer of the 14 reference
checkpoints (``H_0``, each iteration's ``H``, ``M_v``, ``H_v``, ``H_e`` and
each head's output, the constrainers', the bond descriptors' and the
transforms' included) in float32, ``MABAtomMessagePassing`` with seeded
weights carried across by ``from_jax_params``, the collate's tables against
``collate_mol_atom_bond_batch`` exactly, ``ConstrainerFFN`` on its own,
three Adam steps of a three-head model, ``CPTPU001`` files read by both
packages, and the kernels a MAB step launches (a rehearsal's counts: never
``ops.loop_readout``'s G and H). Small size: the 11 molecules of the
bundled CSVs, and d_h = 32 where the weights are seeded."""

from __future__ import annotations

import csv
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.cli import mab as jmab
from chemprop_tpu.cli.main import construct_parser as jax_parser
from chemprop_tpu.featurizers.molgraph.molecule import (
    SimpleMoleculeMolGraphFeaturizer as JaxFeaturizer,
)
from chemprop_tpu.models import serialize as jserialize
from chemprop_tpu.models.torch_convert import convert_model
from chemprop_tpu.nn.ffn import ConstrainerFFN as JaxConstrainer
from chemprop_tpu.nn.message_passing.mol_atom_bond import (
    MABAtomMessagePassing as JaxMABAtomMP,
)
from chemprop_tpu.train.mab_trainer import MABTrainer as JaxMABTrainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.cli import mab as tmab
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.data import DataLoader, MolAtomBondDatapoint, MolAtomBondDataset
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models import from_jax_params, load_model, serialize
from chemprop_tpu_torch.models.mol_atom_bond import MolAtomBondMPNN
from chemprop_tpu_torch.nn.ffn import ConstrainerFFN
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.message_passing import MABAtomMessagePassing
from chemprop_tpu_torch.ops import LAUNCHES
from chemprop_tpu_torch.train.mab_trainer import MABTrainer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the rehearsal that counts the card's launches)

MODELS = "mol_atom_bond/example_models"
CHECKPOINTS = ["QM_descriptors.pt", "atomic_regression_atom_mapped.pt", "classification.pt",
               "multiclass.pt", "regression.pt", "regression_constrained.pt",
               "regression_mve.pt", "regression_no_atom.pt", "regression_no_bond.pt",
               "regression_no_mol.pt", "regression_only_atom.pt", "regression_only_bond.pt",
               "regression_only_mol.pt", "regression_with_extras.pt"]
D_H = 32
THREE_LRS = sum(noam_lr_host(k, 2, 1, 1e-4, 1e-3, 1e-4) for k in range(3))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smiles(path: Path, n: int | None = None) -> list[str]:
    with open(path, newline="") as f:
        return [row[0] for row in list(csv.reader(f))[1:]][:n]


def _npz(path: Path) -> list[np.ndarray]:
    with np.load(path) as f:
        arrays = [f[k] for k in f.files]
    if len(arrays) == 1 and arrays[0].ndim == 2:
        return [np.asarray(a, np.float64) for a in arrays[0]]
    return [np.asarray(a, np.float64) for a in arrays]


def _inputs(data_dir: Path, ckpt: str) -> tuple[list[str], dict, dict, dict]:
    """A checkpoint's molecules as the JAX package's tests predict them:
    (SMILES, ``from_smi`` options, per-molecule extras, per-molecule
    constraints)."""
    mab = data_dir / "mol_atom_bond"
    smis = _smiles(mab / "regression.csv")
    opts, extras, cons = dict(keep_h=True), {}, {}
    if ckpt == "atomic_regression_atom_mapped.pt":
        smis = _smiles(mab / "atomic_regression_atom_mapped.csv", 64)
        opts["reorder_atoms"] = True
    elif ckpt == "QM_descriptors.pt":
        opts = dict(add_h=True)
    elif ckpt == "regression_with_extras.pt":
        opts["reorder_atoms"] = True
        extras = dict(x_d=_npz(mab / "descriptors.npz"),
                      V_f=_npz(mab / "atom_features_descriptors.npz"),
                      E_f=_npz(mab / "bond_features_descriptors.npz"),
                      V_d=_npz(mab / "atom_features_descriptors.npz"),
                      E_d=_npz(mab / "bond_features_descriptors.npz"))
    elif ckpt == "regression_constrained.pt":
        smis = _smiles(mab / "constrained_regression.csv")
        with open(mab / "constrained_regression_constraints.csv", newline="") as f:
            c = np.array([[float(x) for x in r] for r in list(csv.reader(f))[1:]])
        cons = dict(atom_constraints=list(c[:, :2]),
                    bond_constraints=list(np.stack([np.full(len(c), np.nan), c[:, 2]], 1)))
    return smis, opts, extras, cons


def _batches(data_dir: Path, ckpt: str, batch_size: int = 64):
    """The first batch of each package over the same molecules."""
    smis, opts, extras, cons = _inputs(data_dir, ckpt)

    def points(cls):
        return [cls.from_smi(s, **opts, **{k: v[i] for k, v in {**extras, **cons}.items()})
                for i, s in enumerate(smis)]

    widths = {}
    if extras:
        widths = dict(extra_atom_fdim=extras["V_f"][0].shape[1],
                      extra_bond_fdim=extras["E_f"][0].shape[1])
    jds = jdata.MolAtomBondDataset(points(jdata.MolAtomBondDatapoint), JaxFeaturizer(**widths))
    tds = MolAtomBondDataset(points(MolAtomBondDatapoint),
                             SimpleMoleculeMolGraphFeaturizer(**widths))
    jb = next(iter(jdata.DataLoader(jds, batch_size=batch_size, shuffle=False, prefetch=0)))
    tb = next(iter(DataLoader(tds, batch_size=batch_size)))
    return jb, tb


def _close(got, want, rows=None, name="", rtol=1e-5, atol=1e-6):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    got = got[..., : want.shape[-1]] if want.ndim == got.ndim else got
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_reference_checkpoint_layers_match_jax(data_dir, ckpt):
    """Every layer and head of a reference checkpoint, loaded by each
    package from the same file, on the same batch in float32."""
    jmodel, jvars, _ = convert_model(data_dir / MODELS / ckpt)
    model, _ = load_model(data_dir / MODELS / ckpt, "cpu")
    jb, tb = _batches(data_dir, ckpt)
    nodes, edges = tb.bmg.node_mask.numpy(), tb.bmg.edge_mask.numpy()
    n_mols = len(tb.pad_mask[tb.pad_mask])

    (jH_v, jH_e), state = jmodel.apply(
        jvars, jb.bmg, jb.V_d, jb.E_d, False, method=lambda m, *a: m.message_passing(*a),
        mutable=["intermediates"])
    taps: dict = {}
    LAUNCHES.clear()
    with torch.inference_mode():
        H_v, H_e = model.message_passing(tb.bmg, tb.V_d, tb.E_d, taps=taps)
        preds = model(tb.bmg, tb.V_d, tb.E_d, tb.X_d, tb.constraints)
    assert sum(LAUNCHES.values()) == 0  # the CPU takes the plain versions
    inter = state["intermediates"]["message_passing"]
    assert len(taps["H"]) == len(inter["H"]) == 2  # depth 3: two iterations
    for name in ("H_0", "H", "M_v"):
        if name == "M_v" and H_v is None:
            assert "M_v" not in taps and "M_v" not in inter
            continue
        for p, j in zip(taps[name], inter[name], strict=True):
            _close(p, j, nodes if name == "M_v" else edges, name)
    for got, want, rows, name in ((H_v, jH_v, nodes, "H_v"), (H_e, jH_e, edges, "H_e")):
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.dtype == torch.float32 and got.shape[1] % 128 == 0
            _close(got, want, rows, name)
    want = jmodel.apply(jvars, jb.bmg, jb.V_d, jb.E_d, jb.X_d, jb.constraints, is_training=False)
    for kind, got, w, rows in zip(("mol", "atom", "bond"), preds, want,
                                  (slice(0, n_mols), nodes, edges)):
        assert (got is None) == (w is None), kind
        if got is not None:
            assert got.shape == w.shape, kind
            _close(got, w, rows, kind)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edges_only", [False, True], ids=["both", "edges_only"])
def test_atom_mab_message_passing_matches_jax(data_dir, dtype, edges_only):
    """``MABAtomMessagePassing`` with a bias, atom and bond descriptors and
    seeded weights carried across by ``from_jax_params``: both embeddings
    and the taps; without vertex embeddings neither M_v nor W_vo."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    _, tb = _batches(data_dir, "regression.pt")
    jb, _ = _batches(data_dir, "regression.pt")
    rng = np.random.default_rng(3)
    V_d = (rng.standard_normal((tb.bmg.V.shape[0], 3)) * tb.bmg.node_mask.numpy()[:, None]
           ).astype(np.float32)
    E_d = (rng.standard_normal((tb.bmg.E.shape[0], 2)) * tb.bmg.edge_mask.numpy()[:, None]
           ).astype(np.float32)
    kw = dict(d_h=D_H, bias=True, d_vd=3, d_ed=2, return_vertex_embeddings=not edges_only)
    jmp = JaxMABAtomMP(compute_dtype=jdt, **kw)
    variables = jmp.init(jax.random.PRNGKey(0), jb.bmg, jnp.asarray(V_d), jnp.asarray(E_d), False)
    variables = jax.tree_util.tree_map(lambda x: x + 0.05 if x.ndim == 1 else x, variables)
    (jH_v, jH_e), state = jmp.apply(variables, jb.bmg, jnp.asarray(V_d), jnp.asarray(E_d), False,
                                    mutable=["intermediates"])
    mp = MABAtomMessagePassing(compute_dtype=tdt, **kw)
    sd = from_jax_params({"message_passing": variables["params"]})
    mp.load_state_dict({k.removeprefix("message_passing."): v for k, v in sd.items()})
    taps: dict = {}
    H_v, H_e = mp(tb.bmg, torch.from_numpy(V_d), torch.from_numpy(E_d), taps=taps)
    nodes, edges = tb.bmg.node_mask.numpy(), tb.bmg.edge_mask.numpy()
    inter = state["intermediates"]
    assert ("W_vo" in variables["params"]) == (H_v is not None) == (not edges_only)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=0.05, atol=0.1)
    for name in ("H_0", "H", "M_v"):
        for p, j in zip(taps.get(name, ()), inter.get(name, ()), strict=True):
            _close(p, j, nodes if name == "M_v" else edges, name, **tol)
    if H_v is not None:
        _close(H_v, jH_v, nodes, "H_v", **tol)
    _close(H_e, jH_e, edges, "H_e", **tol)


def _train_args(parse, data_dir: Path, name: str, *extra: str):
    """``train``'s arguments of one of the bundled MAB CSVs."""
    mab = data_dir / "mol_atom_bond"
    argv = ["train", "-i", str(mab / f"{name}.csv"), "--keep-h", "--reorder-atoms",
            "--message-hidden-dim", str(D_H), "--ffn-hidden-dim", "16", *extra]
    if name == "constrained_regression":
        argv += ["--mol-target-columns", "mol_y", "--atom-target-columns", "atom_y1", "atom_y2",
                 "--bond-target-columns", "bond_y1", "bond_y2", "--constraints-path",
                 str(mab / "constrained_regression_constraints.csv")]
    else:
        argv += ["--mol-target-columns", "mol_y1", "mol_y2", "--atom-target-columns", "atom_y1",
                 "atom_y2", "--bond-target-columns", "bond_y1", "bond_y2"]
    args = parse().parse_args(argv)
    args.data_path = Path(args.data_path[0]) if isinstance(args.data_path, list) else args.data_path
    args.target_columns = args.mol_target_columns
    return args


COLLATES = {
    "regression": (),
    "bounded": ("--loss-function", "bounded-mse", "--weight-column", "weight"),
    "constrained_regression": (),
    "extras": None,
}


@pytest.mark.parametrize("case", sorted(COLLATES))
def test_collate_matches_jax_exactly(data_dir, case):
    """The CSV through each package's MAB parsing and collate: every table
    of the batch equal, the graph's and the per-kind targets, weights,
    bounds, constraints, bond descriptors and sort permutation."""
    mab = data_dir / "mol_atom_bond"
    name = "regression" if case == "extras" else case
    extra = COLLATES[case] or (
        "--descriptors-path", str(mab / "descriptors.npz"),
        "--atom-descriptors-path", str(mab / "atom_features_descriptors.npz"),
        "--bond-descriptors-path", str(mab / "bond_features_descriptors.npz"))
    if case == "bounded":
        extra = (*extra, "-t", "regression")
    jargs, targs = (_train_args(p, data_dir, name, *extra) for p in (jax_parser, construct_parser))
    jdps, *jcols = jmab.build_MAB_datapoints(jargs)
    tdps, *tcols = tmab.build_MAB_datapoints(targs)
    assert jcols == tcols
    jds, tds = jdata.MolAtomBondDataset(jdps), MolAtomBondDataset(tdps)
    for kind in ("mol", "atom", "bond"):
        jds.normalize_targets(kind)
        tds.normalize_targets(kind)
    for key in ("X_d", "V_d", "E_d"):
        jds.normalize_inputs(key)
        tds.normalize_inputs(key)
    jb = next(iter(jdata.DataLoader(jds, batch_size=8, shuffle=False, prefetch=0)))
    tb = next(iter(DataLoader(tds, batch_size=8)))
    for f in ("V", "E", "src", "dst", "rev", "batch", "node_mask", "edge_mask"):
        np.testing.assert_array_equal(getattr(tb.bmg, f).numpy(), np.asarray(getattr(jb.bmg, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tb.edge_origin, np.asarray(jb.edge_origin))

    def same(got, want, name):
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)

    for name in ("V_d", "E_d", "X_d"):
        same(getattr(tb, name), getattr(jb, name), name)
    for name in ("Ys", "ws", "lt_masks", "gt_masks"):
        for k, (got, want) in enumerate(zip(getattr(tb, name), getattr(jb, name), strict=True)):
            same(got, want, f"{name}[{k}]")
    assert (tb.constraints is None) == (jb.constraints is None)
    for k, (got, want) in enumerate(zip(tb.constraints or (), jb.constraints or ())):
        same(got, want, f"constraints[{k}]")
    assert (case == "constrained_regression") == (tb.constraints is not None)
    assert (case == "bounded") == (tb.lt_masks[1] is not None)


def test_constrainer_matches_jax():
    """``ConstrainerFFN`` alone: NaN constraints in the first row switch a
    column off, the padding rows read the last molecule's sums."""
    rng = np.random.default_rng(5)
    fp = rng.standard_normal((9, 12)).astype(np.float32)
    preds = rng.standard_normal((9, 2)).astype(np.float32)
    batch = np.array([0, 0, 0, 1, 1, 2, 2, 2, 3], np.int32)  # row 8: the padding molecule
    cons = rng.standard_normal((3, 2)).astype(np.float32)
    cons[0, 1] = np.nan
    jc = JaxConstrainer(n_constraints=2, fp_dim=12, hidden_dim=8)
    variables = jc.init(jax.random.PRNGKey(2), fp, preds, batch, cons, False)
    want = jc.apply(variables, fp, preds, batch, cons, False)
    c = ConstrainerFFN(n_constraints=2, fp_dim=12, hidden_dim=8)
    sd = from_jax_params({"atom_constrainer": variables["params"]})
    c.load_state_dict({k.removeprefix("atom_constrainer."): v for k, v in sd.items()})
    got = c(*(torch.from_numpy(x) for x in (fp, preds, batch, cons)))
    _close(got, want)
    # the constrained column meets its sums, the other is left as it was
    sums = np.zeros((4, 2))
    np.add.at(sums, batch, got.detach().numpy())
    np.testing.assert_allclose(sums[:3, 0], cons[:, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.detach().numpy()[:, 1], preds[:, 1])


def _three_head_setup(data_dir: Path):
    """Each package's model, dataset and loader for the three-head
    regression CSV, the port's parameters seeded and carried to JAX."""
    targs = _train_args(construct_parser, data_dir, "regression", "--device", "cpu")
    jargs = _train_args(jax_parser, data_dir, "regression")
    tds = MolAtomBondDataset(tmab.build_MAB_datapoints(targs)[0])
    jds = jdata.MolAtomBondDataset(jmab.build_MAB_datapoints(jargs)[0])
    t_scalers = [tds.normalize_targets(k) for k in ("mol", "atom", "bond")]
    j_scalers = [jds.normalize_targets(k) for k in ("mol", "atom", "bond")]
    from chemprop_tpu.nn.transforms import UnscaleTransform as JaxUnscale
    from chemprop_tpu_torch.nn.transforms import UnscaleTransform

    model = tmab.build_MAB_model(targs, tds, [UnscaleTransform.from_standard_scaler(s)
                                              for s in t_scalers])
    jmodel = jmab.build_MAB_model(jargs, jds, [JaxUnscale.from_standard_scaler(s)
                                               for s in j_scalers])
    init_parameters(model, "lecun", torch.Generator().manual_seed(7))
    return model, jmodel, tds, jds


def test_three_adam_steps_of_three_heads_match_jax(data_dir):
    """Three steps of a molecule, atom and bond head in float32 from one set
    of parameters, batches of 4: the losses at rtol 1e-5, every parameter
    within twice the steps' rates and at rtol 1e-4 / atol 1e-6 for all but
    one element in a thousand (``test_three_adam_steps_match_jax_f32``'s
    limits)."""
    model, jmodel, tds, jds = _three_head_setup(data_dir)
    jbatches = list(jdata.DataLoader(jds, batch_size=4, shuffle=False, prefetch=0))[:3]
    tbatches = list(DataLoader(tds, batch_size=4))[:3]
    trainer = MABTrainer(model, max_epochs=3, warmup_epochs=2, seed=0, device="cpu")
    trainer.init_state(None, 1, keep_parameters=True)
    jtrainer = JaxMABTrainer(jmodel, max_epochs=3, warmup_epochs=2, seed=0)
    state = jtrainer.init_state(jbatches[0], 1)
    params = serialize.to_jax_params(dict(model.named_parameters()))["params"]
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          opt_state=jtrainer.tx.init(params))
    jstep = jax.jit(jtrainer._train_body())
    jlosses, tlosses = [], []
    for jb, tb in zip(jbatches, tbatches, strict=True):
        state, loss = jstep(state, jb)
        jlosses.append(float(loss))
        tlosses.append(float(trainer.train_step(tb)))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = from_jax_params(state.params)
    got = {k: v.detach() for k, v in model.named_parameters()}
    assert set(got) == set(want)
    n_bad = n_all = 0
    for name in want:
        err = (got[name] - want[name]).abs()
        assert float(err.max()) <= 2 * THREE_LRS, name
        n_bad += int((err > 1e-6 + 1e-4 * want[name].abs()).sum())
        n_all += err.numel()
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "batch_norm"])
def test_cptpu_files_read_by_both_packages(data_dir, tmp_path, batch_norm):
    """A port ``CPTPU001`` MAB file (with batch norm per head, statistics
    moved) loads in the JAX package with the same predictions, and JAX's
    file of a reference checkpoint loads in the port."""
    model, _, tds, jds = _three_head_setup(data_dir)
    if batch_norm:
        model = MolAtomBondMPNN(model.message_passing, model.agg, model.mol_predictor,
                                model.atom_predictor, model.bond_predictor, batch_norm=True)
        with torch.no_grad():
            for kind in ("mol", "atom", "bond"):
                bn = getattr(model, f"bn_{kind}")
                bn.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(1))
                bn.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
    path = tmp_path / "port.ckpt"
    serialize.save_model(path, model.eval(), ["mol_y1", "mol_y2", "atom_y1", "atom_y2",
                                              "bond_y1", "bond_y2"])
    jmodel, jvars, extra = jserialize.load_model(path)
    assert type(jmodel).__name__ == "MolAtomBondMPNN" and jmodel.batch_norm == batch_norm
    jb = next(iter(jdata.DataLoader(jds, batch_size=16, shuffle=False, prefetch=0)))
    tb = next(iter(DataLoader(tds, batch_size=16)))
    want = jmodel.apply(jvars, jb.bmg, jb.V_d, jb.E_d, jb.X_d, jb.constraints, is_training=False)
    again, cols = load_model(path, "cpu")
    with torch.inference_mode():
        for m in (model, again):
            got = m(tb.bmg, tb.V_d, tb.E_d, tb.X_d, tb.constraints)
            for g, w in zip(got, want, strict=True):
                _close(g, w, rows=slice(0, 11) if g.shape[0] == 16 else None)
    assert cols == extra["output_columns"]

    jax_file = tmp_path / "jax.ckpt"
    jmodel, jvars, _ = convert_model(data_dir / MODELS / "regression_constrained.pt")
    jserialize.save_model(jax_file, jmodel, jvars, [["mol_y"], ["atom_y1", "atom_y2"],
                                                     ["bond_y1", "bond_y2"]])
    port, cols = load_model(jax_file, "cpu")
    ref, _ = load_model(data_dir / MODELS / "regression_constrained.pt", "cpu")
    assert cols == [["mol_y"], ["atom_y1", "atom_y2"], ["bond_y1", "bond_y2"]]
    sd, ref_sd = port.state_dict(), ref.state_dict()
    assert set(sd) == set(ref_sd)
    for k in sd:
        torch.testing.assert_close(sd[k], ref_sd[k], rtol=0, atol=0, msg=k)


def test_reference_mab_batch_norm_is_refused(data_dir):
    """As the JAX converter refuses a reference MAB file with batch norm."""
    from chemprop_tpu_torch.models.load import build_model, load_checkpoint

    d = load_checkpoint(data_dir / MODELS / "regression.pt")
    d["hyper_parameters"]["batch_norm"] = True
    with pytest.raises(ValueError, match="batch norm is refused"):
        build_model(d["hyper_parameters"], d["state_dict"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_mab_step_never_takes_loop_readout(data_dir, dtype):
    """A rehearsal of a three-head training step counts what the card
    launches: the per-iteration kernels, M_v's segment sum and each
    iteration's transposed message, never G, H or D; the same model's plain
    MPNN step takes G and H (bf16), so the rehearsal sees them."""
    from chemprop_tpu_torch.models.model import MPNN

    model, _, tds, _ = _three_head_setup(data_dir)
    model.message_passing.compute_dtype = getattr(torch, dtype)
    trainer = MABTrainer(model, max_epochs=2, device="cpu")
    trainer.init_state(None, 1, keep_parameters=True)
    batch = next(iter(DataLoader(tds, batch_size=16)))
    with chip_smoke.rehearsal() as counts:
        trainer.train_step(batch)
    counts = dict(counts)
    for kernel in ("bwd_message_nodes", "bwd_message_premul", "fused_iter2", "iter_bwd"):
        assert counts.get(kernel, 0) == 0, (kernel, counts)
    first = "message" if dtype == "float32" else "fused_iter"
    assert counts[first] == 2 and counts["bwd_message"] == 2, counts
    # M_v's segment sum and the norm readout
    assert counts["sorted_segment_sum"] == 2, counts
    plain = MPNN(BondMessagePassing(d_h=D_H, compute_dtype=getattr(torch, dtype)),
                 MeanAggregation(), RegressionFFN(input_dim=D_H, hidden_dim=16))
    with chip_smoke.rehearsal() as counts:
        plain(batch.bmg, is_training=True).sum().backward()
    if dtype == "bfloat16":
        assert counts["bwd_message_nodes"] == counts["bwd_message_premul"] == 1, dict(counts)


def test_datapoints_and_dataset_normalisation_match_jax(data_dir):
    """Per-kind target scaling and the constraints' rescaling, ``E_d``'s
    scaling over every bond."""
    mab = data_dir / "mol_atom_bond"
    extra = ("--bond-descriptors-path", str(mab / "bond_features_descriptors.npz"))
    jargs = _train_args(jax_parser, data_dir, "constrained_regression", *extra)
    targs = _train_args(construct_parser, data_dir, "constrained_regression", *extra)
    jds = jdata.MolAtomBondDataset(jmab.build_MAB_datapoints(jargs)[0][:10])
    tds = MolAtomBondDataset(tmab.build_MAB_datapoints(targs)[0][:10])
    for kind in ("mol", "atom", "bond"):
        js, ts = jds.normalize_targets(kind), tds.normalize_targets(kind)
        np.testing.assert_allclose(ts.mean_, js.mean_, rtol=1e-12)
        np.testing.assert_allclose(ts.scale_, js.scale_, rtol=1e-12)
    js, ts = jds.normalize_inputs("E_d"), tds.normalize_inputs("E_d")
    np.testing.assert_allclose(ts.scale_, js.scale_, rtol=1e-12)
    for i in range(len(tds)):
        j, t = jds[i], tds[i]
        for a, b in zip((*t.ys, *t.constraints, t.E_d), (*j.ys, *j.constraints, j.E_d)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("options", [dict(depth_loop=True), dict(fused_bwd=True, grad_w=True)],
                         ids=["depth_loop", "fused_bwd_grad_w"])
def test_kernel_options_keep_the_mab_step(data_dir, options):
    """The opt-in kernels serve MAB behind the same options as the plain
    model: a bf16 step with ``depth_loop`` (the whole loop as one op, its
    backward F per iteration) or with ``fused_bwd`` and ``grad_w`` (E for the
    second iteration's backward) gives the default dispatch's loss and its
    gradients within bf16's rounding, and never G, H or D."""
    from chemprop_tpu_torch.ops.options import KernelOptions

    grads, counts = {}, {}
    for name, opts in (("default", {}), ("options", options)):
        model, _, tds, _ = _three_head_setup(data_dir)
        model.message_passing.compute_dtype = torch.bfloat16
        model.message_passing.kernel_options = KernelOptions(**opts)
        batch = next(iter(DataLoader(tds, batch_size=16)))
        trainer = MABTrainer(model, max_epochs=2, device="cpu")
        trainer.init_state(None, 1, keep_parameters=True)
        with chip_smoke.rehearsal() as c:
            loss = trainer.loss(batch)
            loss.backward()
        counts[name] = dict(c)
        grads[name] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()})
    # the same forward; the backward's bf16 products round at other places
    assert grads["options"][0] == grads["default"][0]
    for k, g in grads["default"][1].items():
        err = (grads["options"][1][k] - g).abs()
        assert float(err.max()) <= 0.05 * max(float(g.abs().max()), 1e-6), k
    for kernel in ("bwd_message_nodes", "bwd_message_premul", "fused_iter2"):
        assert counts["options"].get(kernel, 0) == 0, counts
    if "fused_bwd" in options:  # E for the second iteration, F for the first
        assert counts["options"]["iter_bwd"] == counts["options"]["bwd_message"] == 1, counts
