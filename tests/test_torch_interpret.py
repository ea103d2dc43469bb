"""The port's interpretation (``chemprop_tpu_torch.interpret``,
``chemprop_tpu_torch.callbacks``) against the JAX package's on the CPU.

One small model (d_h 32 padded to 128, depth 2, mean readout, batch norm,
regression head) with weights drawn by numpy from a seed, handed to both
packages (the port through ``from_jax_params``), per dtype. The JAX side
runs its plain CPU path (no interpret mode). Tolerances:

* per-subgraph predictions: float32 atol 1e-5 (both packages sum in f32,
  in other orders); bfloat16 the JAX package's bf16 parity envelope (rtol
  0.05, atol 0.1, ``test_torch_model.py``), since bf16 tables round at other
  places in the two frameworks;
* attributions: ``2 n`` times the per-subgraph limit, ``n`` the molecule's
  atoms: a marginal is a difference of two sums of at most ``n`` component
  predictions, and the Shapley weights of an atom sum to 1;
* clusters, rationale atom sets and SMILES exactly; rationale scores at the
  per-subgraph limit.

The three faults of the JAX package's MCTS callback (``ROADMAP.md`` section
3) are divergences by design, each with a test here."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from chemprop_tpu.callbacks import MCTSRationaleCallback as JaxMCTSCallback
from chemprop_tpu.chem import make_mol as jax_make_mol
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import (
    SimpleMoleculeMolGraphFeaturizer as JaxFeaturizer,
)
from chemprop_tpu.interpret import MCTSRationaleExplainer as JaxMCTS
from chemprop_tpu.interpret import MyersonExplainer as JaxMyerson
from chemprop_tpu.interpret import find_deletion_clusters as jax_clusters
from chemprop_tpu.interpret import subgraph_smiles as jax_subgraph_smiles
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu_torch.callbacks import (
    CallbackRegistry,
    MCTSRationaleCallback,
    MyersonExplainerCallback,
)
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.data.collate import batch_mol_graphs
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.interpret import (
    MCTSRationaleExplainer,
    MyersonExplainer,
    _submolgraph,
    check_explainable,
    find_deletion_clusters,
    subgraph_smiles,
    subgraph_pad,
)
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from test_torch_model import DTYPES, _numpy_variables

D_H = 32
# per-subgraph prediction limits (rtol, atol), by dtype
LIMITS = {"float32": (0.0, 1e-5), "bfloat16": (0.05, 0.1)}
EXACT_SMIS = ["CC(=O)OCC", "c1ccccc1O"]  # 6 and 7 heavy atoms
SAMPLED_SMI = "CC(N)C(=O)OCC"  # 8 heavy atoms, sampled with a threshold of 4
MCTS_SMI = "CCCc1ccccc1C(=O)O"


def _jax_model(jdt, batch_norm=True):
    return JaxMPNN(
        message_passing=JaxBondMP(d_h=D_H, depth=2, compute_dtype=jdt),
        agg=JaxMean(),
        predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H),
        batch_norm=batch_norm,
    )


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """``(dtype, jax model, variables, port model)`` on the same weights."""
    jdt, tdt = DTYPES[request.param]
    mg = JaxFeaturizer()(jax_make_mol("CCO"))
    jmodel = _jax_model(jdt)
    variables = _numpy_variables(
        jmodel.init(jax.random.PRNGKey(0), jax_batch([mg], JaxPadSpec(16, 16, 1)), None, None,
                    False), seed=3)
    model = MPNN(
        BondMessagePassing(d_v=mg.V.shape[1], d_e=mg.E.shape[1], d_h=D_H, depth=2,
                           compute_dtype=tdt),
        MeanAggregation(),
        RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
        batch_norm=True,
    )
    model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    return request.param, jmodel, variables, model.eval()


def _recording(cls):
    """``cls`` with every ``_eval_masks`` output kept in ``self.evals``."""

    class Recording(cls):
        def _eval_masks(self, mg, masks):
            out = super()._eval_masks(mg, masks)
            self.__dict__.setdefault("evals", []).append((list(masks), out))
            return out

    return Recording


def _mg(smi):
    return SimpleMoleculeMolGraphFeaturizer()(make_mol(smi))


def _jax_mg(smi):
    return JaxFeaturizer()(jax_make_mol(smi))


def _hold(dtype, got, want, scale=1.0):
    rtol, atol = LIMITS[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol * scale, atol=atol * scale)


def _explain_both(pair, smi, **kwargs):
    dtype, jmodel, variables, model = pair
    port = _recording(MyersonExplainer)(model, device="cpu", **kwargs)
    jax_ = _recording(JaxMyerson)(jmodel, variables, **kwargs)
    phi, jphi = port.explain(_mg(smi)), jax_.explain(_jax_mg(smi))
    return port, jax_, phi, jphi


def _hold_explanations(pair, port, jax_, phi, jphi, n):
    dtype = pair[0]
    assert [m for m, _ in port.evals] == [m for m, _ in jax_.evals]
    for (_, got), (_, want) in zip(port.evals, jax_.evals):
        assert got.shape == want.shape
        _hold(dtype, got, want)
    assert phi.shape == jphi.shape == (n, 1)
    _hold(dtype, phi, jphi, scale=2 * n)


@pytest.mark.parametrize("smi", EXACT_SMIS)
def test_exact_myerson_matches_jax(pair, smi):
    # 16 graphs per batch: several chunks, the last one short
    port, jax_, phi, jphi = _explain_both(pair, smi, graphs_per_batch=16)
    n = make_mol(smi).num_atoms
    _hold_explanations(pair, port, jax_, phi, jphi, n)
    # the efficiency axiom: the attributions sum to the whole molecule's
    # prediction (the component of every atom), to the f64 sums' rounding
    (masks, out), = port.evals
    np.testing.assert_allclose(phi.sum(0), out[masks.index((1 << n) - 1)], rtol=0, atol=1e-5)


def test_sampled_myerson_matches_jax(pair):
    port, jax_, phi, jphi = _explain_both(pair, SAMPLED_SMI, sampling_threshold=4,
                                          n_samples=20, seed=7)
    _hold_explanations(pair, port, jax_, phi, jphi, make_mol(SAMPLED_SMI).num_atoms)


def test_chunk_of_single_atoms_and_short_last_chunk(pair):
    """A chunk whose graphs are single atoms (no edges) beside larger ones, and
    a last chunk of three graphs in a pad of eight (five graphs without
    nodes): against each subgraph alone in a batch of its own (the plain
    kernels, padding apart) and against the JAX package's evaluator."""
    dtype, jmodel, variables, model = pair
    smi = EXACT_SMIS[1]
    n = make_mol(smi).num_atoms
    masks = [1 << a for a in range(n)] + [0b11, 0b111, (1 << n) - 1, 0b1100]
    assert len(masks) % 8 == 3
    got = MyersonExplainer(model, graphs_per_batch=8, device="cpu")._eval_masks(_mg(smi), masks)
    want = JaxMyerson(jmodel, variables, graphs_per_batch=8)._eval_masks(_jax_mg(smi), masks)
    _hold(dtype, got, want)
    alone = []
    with torch.no_grad():
        for m in masks:
            alone.append(model(batch_mol_graphs([_submolgraph(_mg(smi), m)]))[:1].float().numpy())
    # the same rows in another batch: summation order only; bf16 may flip a
    # rounding of a hidden value, which the f32 head shrinks below 1e-3
    np.testing.assert_allclose(got, np.concatenate(alone), rtol=0,
                               atol=1e-5 if dtype == "float32" else 1e-3)
    pad = subgraph_pad(_mg(smi), len(masks), 8)
    assert pad.n_graphs == 8


@pytest.mark.parametrize("smi", ["Cc1ccccc1", "CCC(=O)Nc1ccc2ccccc2c1", "C", "CCO",
                                 "C1CC1CC1CCCC1"])
def test_clusters_and_subgraph_smiles_match_jax(smi):
    mol, jmol = make_mol(smi), jax_make_mol(smi)
    clusters, atom_cls = find_deletion_clusters(mol)
    assert (clusters, atom_cls) == jax_clusters(jmol)
    rng = np.random.default_rng(0)
    masks = clusters + [int(m) for m in rng.integers(1, 1 << mol.num_atoms, 20)]
    assert [subgraph_smiles(mol, m) for m in masks] == [jax_subgraph_smiles(jmol, m)
                                                        for m in masks]


def _planted(cls, smi):
    mol = make_mol(smi)
    ring = sum(1 << a for r in mol.rings for a in r)

    class Planted(cls):
        def _score_masks(self, mg, masks):
            return np.array([1.0 if m & ring == ring else 0.0 for m in masks])

    return Planted


def test_mcts_planted_scorer_matches_jax():
    """The search alone (``tests/unit/test_interpret.py``'s planted scorer):
    the same rationales, in the same order."""
    smi = "CCCCCCc1ccccc1"
    kw = dict(n_rollout=10, max_atoms=7, min_atoms=4, prop_delta=0.5)
    port = _planted(MCTSRationaleExplainer, smi)(model=None, **kw).explain(smi)
    jax_ = _planted(JaxMCTS, smi)(model=None, variables=None, **kw).explain(smi)
    assert port == jax_ and port and port[0]["score"] == 1.0


def test_mcts_real_model_matches_jax(pair):
    dtype, jmodel, variables, model = pair
    kw = dict(n_rollout=6, max_atoms=9, min_atoms=3, prop_delta=-1e9)
    port = MCTSRationaleExplainer(model, device="cpu", **kw).explain(MCTS_SMI)
    jax_ = JaxMCTS(jmodel, variables, **kw).explain(MCTS_SMI)
    assert port
    scores = lambda rats: np.array([r["score"] for r in rats])  # noqa: E731
    if dtype == "float32":
        assert [(r["atoms"], r["smiles"], r["n_atoms"]) for r in port] == [
            (r["atoms"], r["smiles"], r["n_atoms"]) for r in jax_]
        _hold(dtype, scores(port), scores(jax_))
    else:
        # bf16 scores within the envelope may order two states apart: the
        # same atom sets, each with its score
        by_atoms = {tuple(r["atoms"]): r["score"] for r in jax_}
        assert sorted(by_atoms) == sorted(tuple(r["atoms"]) for r in port)
        _hold(dtype, scores(port), [by_atoms[tuple(r["atoms"])] for r in port])


def test_callbacks_match_the_explainers(pair):
    dtype, jmodel, variables, model = pair
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s) for s in EXACT_SMIS])
    assert CallbackRegistry["myerson"] is MyersonExplainerCallback
    assert CallbackRegistry["mcts"] is MCTSRationaleCallback
    got = MyersonExplainerCallback(device="cpu").explain(model, ds)
    for smi, phi in zip(EXACT_SMIS, got):
        np.testing.assert_array_equal(phi, MyersonExplainer(model, device="cpu").explain(_mg(smi)))
    kw = dict(n_rollout=3, max_atoms=6, min_atoms=2, prop_delta=-1e9)
    rats = MCTSRationaleCallback(device="cpu", **kw).explain(model, ds)
    assert rats == [MCTSRationaleExplainer(model, device="cpu", **kw).explain(s)
                    for s in EXACT_SMIS]


def test_explainers_need_a_device_on_a_machine_without_a_card(pair):
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MyersonExplainer(pair[3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MCTSRationaleExplainer(pair[3])


# ------------------------------------------------- divergences by design
def test_mcts_callback_takes_the_dataset_featurizer():
    """The JAX package's MCTS callback featurises with the default featurizer
    whatever the dataset's (``chemprop_tpu/cli/predict.py:496``): a model of
    the v1 featurizer's widths fails there. The port takes the dataset's."""
    from chemprop_tpu.data import MoleculeDatapoint as JaxDatapoint
    from chemprop_tpu.data import MoleculeDataset as JaxDataset
    from chemprop_tpu.featurizers.atom import get_multi_hot_atom_featurizer as jax_atoms
    from chemprop_tpu_torch.featurizers import get_multi_hot_atom_featurizer

    featurizer = SimpleMoleculeMolGraphFeaturizer(atom_featurizer=get_multi_hot_atom_featurizer("v1"))
    jfeaturizer = JaxFeaturizer(atom_featurizer=jax_atoms("v1"))
    assert featurizer.shape != SimpleMoleculeMolGraphFeaturizer().shape
    mg = jfeaturizer(jax_make_mol("CCO"))
    jmodel = _jax_model(DTYPES["float32"][0], batch_norm=False)
    variables = _numpy_variables(jmodel.init(
        jax.random.PRNGKey(0), jax_batch([mg], JaxPadSpec(16, 16, 1)), None, None, False))
    model = MPNN(BondMessagePassing(d_v=mg.V.shape[1], d_e=mg.E.shape[1], d_h=D_H, depth=2),
                 MeanAggregation(), RegressionFFN(input_dim=D_H, hidden_dim=D_H,
                                                  output_transform=False))
    model.load_state_dict(from_jax_params(variables["params"]))
    kw = dict(n_rollout=3, max_atoms=6, min_atoms=2, prop_delta=-1e9)
    smi = "CCc1ccccc1O"
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(smi)], featurizer=featurizer)
    got = MCTSRationaleCallback(device="cpu", **kw).explain(model.eval(), ds)
    want = JaxMCTS(jmodel, variables, featurizer=jfeaturizer, **kw).explain(smi)
    assert [r["atoms"] for r in got[0]] == [r["atoms"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got[0]], [r["score"] for r in want],
                               rtol=0, atol=1e-5)
    jds = JaxDataset([JaxDatapoint.from_smi(smi)], featurizer=jfeaturizer)
    with pytest.raises(Exception):  # the default featurizer's widths do not fit
        JaxMCTSCallback(**kw).explain(jmodel, variables, jds)


def test_explainers_refuse_other_heads():
    """The JAX package's MCTS callback runs any head, and attributes a
    multiclass head's first class as if it were a score
    (``chemprop_tpu/cli/predict.py:485``); the port refuses the heads that
    Myerson refuses, for both callbacks."""
    from chemprop_tpu_torch.nn import MulticlassClassificationFFN, MveFFN

    ds = MoleculeDataset([MoleculeDatapoint.from_smi("CCO")])
    model = MPNN(BondMessagePassing(d_h=D_H, depth=2), MeanAggregation(),
                 MulticlassClassificationFFN(n_classes=3, input_dim=D_H, hidden_dim=D_H)).eval()
    for cb in (MCTSRationaleCallback(device="cpu"), MyersonExplainerCallback(device="cpu")):
        with pytest.raises(NotImplementedError, match="regression and binary classification"):
            cb.explain(model, ds)
    mve = MPNN(BondMessagePassing(d_h=D_H, depth=2), MeanAggregation(),
               MveFFN(input_dim=D_H, hidden_dim=D_H)).eval()
    check_explainable(mve)  # a regression head: its mean is attributed
    phi, = MyersonExplainerCallback(device="cpu").explain(mve, ds)
    assert phi.shape == (3, 1)


def test_explainers_refuse_models_of_several_molecules(data_dir):
    """The JAX package's MCTS callback does not check for a single molecule
    per row (``chemprop_tpu/cli/predict.py:498``); the port refuses
    multicomponent, reaction and mol-atom-bond models, naming the item."""
    from chemprop_tpu_torch.models import load_model

    ds = MoleculeDataset([MoleculeDatapoint.from_smi("CCO")])
    multi, _ = load_model(data_dir / "example_model_v2_regression_mol+mol.pt", "cpu")
    mab, _ = load_model(data_dir / "mol_atom_bond/example_models/regression.pt", "cpu")
    for model, item in ((multi, "item 7"), (mab, "item 8")):
        for cb in (MCTSRationaleCallback(device="cpu"), MyersonExplainerCallback(device="cpu")):
            with pytest.raises(ValueError, match=f"single-molecule.*{item}"):
                cb.explain(model, ds)
