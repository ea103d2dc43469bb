"""The per-iteration message-passing path of the port as a whole, against the
JAX package: ``BondMessagePassing`` and the full model with the fused readout
off on both sides (``CHEMPROP_TPU_FUSED_READOUT=0`` there,
``KernelOptions(fused_readout=False)`` here), with a bias, with undirected
messages, with another activation in bfloat16 and at depth 2, forward and
three Adam steps from JAX's initial parameters on the same unshuffled
batches. Small size: d_h = 64 (padded to 128), the 100 molecules of
tests/data/regression/mol/mol.csv in batches of 32. The same comparisons with
dropout are in test_torch_dropout.py, which shares this file's helpers."""

from __future__ import annotations

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn import utils as nn_utils
from chemprop_tpu_torch.ops import LAUNCHES, KernelOptions
from chemprop_tpu_torch.train import Trainer

D_H = 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PER_ITERATION = KernelOptions(fused_readout=False)
# the variants of the path: message-passing arguments and dtype
VARIANTS = {
    "plain_f32": (dict(), "float32"),
    "plain_bf16": (dict(), "bfloat16"),
    "bias_f32": (dict(bias=True), "float32"),
    "bias_bf16": (dict(bias=True), "bfloat16"),
    "undirected_f32": (dict(undirected=True), "float32"),
    "undirected_bf16": (dict(undirected=True), "bfloat16"),
    "tanh_bf16": (dict(activation="tanh"), "bfloat16"),
    "depth2_f32": (dict(depth=2), "float32"),
}
DROPOUT_VARIANTS = {
    "dropout_f32": (dict(dropout=0.2), "float32"),
    "dropout_bf16": (dict(dropout=0.2), "bfloat16"),
}
THREE_LRS = sum(noam_lr_host(k, 8, 192, 1e-4, 1e-3, 1e-4) for k in range(3))


@pytest.fixture(scope="module")
def datasets(data_dir):
    with open(data_dir / "regression" / "mol" / "mol.csv") as f:
        rows = [(smi, float(y)) for smi, y in list(csv.reader(f))[1:]]
    jds = jdata.MoleculeDataset(
        [jdata.MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in rows]
    )
    tds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in rows])
    for ds in (jds, tds):
        ds.normalize_targets()
        ds.cache = True
    return jds, tds


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are small, and the test workers share the machine's
    cores: more than one intra-op thread only makes them wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def per_iteration_jax(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_FUSED_READOUT", "0")


def _interpret(monkeypatch, dtype):
    """The JAX package's bfloat16 path runs its Pallas kernels, in interpret
    mode here; its float32 path composes XLA ops on the CPU, as in
    test_torch_train.py."""
    if dtype == "bfloat16":
        monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


def _models(mp_kwargs, dtype, options=PER_ITERATION):
    jdt, tdt = DTYPES[dtype]
    rate = mp_kwargs.get("dropout", 0.0)
    jmodel = JaxMPNN(
        message_passing=JaxBondMP(d_h=D_H, compute_dtype=jdt, **mp_kwargs),
        agg=JaxMean(),
        predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H, dropout=rate),
        batch_norm=True,
    )
    model = MPNN(
        BondMessagePassing(d_h=D_H, compute_dtype=tdt, kernel_options=options, **mp_kwargs),
        MeanAggregation(),
        RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False, dropout=rate),
        batch_norm=True,
    )
    return jmodel, model


class _Masks:
    """Records what ``jax.random.bernoulli`` returns, and hands the masks to
    the port through the function it draws its masks from."""

    def __init__(self, monkeypatch):
        self.masks: list[np.ndarray] = []
        draw = jax.random.bernoulli

        def record(key, p=0.5, shape=None):
            keep = draw(key, p, shape)
            self.masks.append(np.asarray(keep))
            return keep

        def replay(shape, rate, generator, device):
            keep = torch.from_numpy(self.masks.pop(0).copy())
            if keep.shape[1] < shape[1]:
                # the JAX module alone cuts its node table to d_h before the
                # last dropout; the port's columns past d_h are exact zeros,
                # kept or not
                keep = torch.nn.functional.pad(keep, (0, shape[1] - keep.shape[1]), value=True)
            assert keep.shape == shape
            return keep.to(device)

        monkeypatch.setattr(jax.random, "bernoulli", record)
        monkeypatch.setattr(nn_utils, "dropout_mask", replay)


def _three_steps(datasets, mp_kwargs, dtype, masks=None, options=PER_ITERATION):
    """Three training steps of both packages from JAX's initial parameters;
    returns the losses and the final states in the port's names. With
    ``masks`` the JAX steps run eagerly, so that their dropout masks are
    concrete; so do the bfloat16 ones, whose interpret-mode kernels take
    longer to compile than to run; the float32 ones are jitted."""
    jds, tds = datasets
    jmodel, model = _models(mp_kwargs, dtype, options)
    jloader = jdata.DataLoader(jds, batch_size=32, shuffle=False, prefetch=0)
    tloader = DataLoader(tds, batch_size=32, shuffle=False)
    jbatches, tbatches = list(jloader)[:3], list(tloader)[:3]
    jtrainer = JaxTrainer(jmodel, max_epochs=50, warmup_epochs=2, seed=12)
    state = jtrainer.init_state(jbatches[0], len(jloader))
    trainer = Trainer(model, max_epochs=50, warmup_epochs=2, seed=12, device="cpu")
    trainer.init_state(tbatches[0], len(tloader))
    model.load_state_dict(from_jax_params(state.params, state.batch_stats))
    jstep = jtrainer._train_body()
    if masks is None and dtype == "float32":
        jstep = jax.jit(jstep)
    jlosses, tlosses = [], []
    for jb, tb in zip(jbatches, tbatches):
        state, loss = jstep(state, jb)
        jlosses.append(float(loss))
        if masks is not None:
            assert len(masks.masks) == 4  # two iterations, the node table, the head
        tlosses.append(float(trainer.train_step(tb)))
        assert masks is None or not masks.masks
    want = from_jax_params(state.params, state.batch_stats)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    return jlosses, tlosses, want, got


def check_three_adam_steps(datasets, monkeypatch, mp_kwargs, dtype, options=PER_ITERATION):
    _interpret(monkeypatch, dtype)
    masks = _Masks(monkeypatch) if "dropout" in mp_kwargs else None
    LAUNCHES.clear()
    jlosses, tlosses, want, got = _three_steps(datasets, mp_kwargs, dtype, masks, options)
    assert sum(LAUNCHES.values()) == 0 and set(got) == set(want)
    if dtype == "float32":
        # the same arithmetic in f32; only summation orders differ
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
        n_bad = n_all = 0
        for name in want:  # every parameter and both batch-norm statistics
            err = (got[name] - want[name]).abs()
            # Adam steps by the rate times the gradient's sign: an element
            # whose gradient is at f32 rounding level may step the other way
            assert float(err.max()) <= 2 * THREE_LRS, name
            n_bad += int((err > 1e-6 + 1e-4 * want[name].abs()).sum())
            n_all += err.numel()
        assert n_bad <= 1e-3 * n_all, (n_bad, n_all)
    else:
        # bf16 tables round at other places in the two frameworks; the composed
        # path of another activation rounds after every op (message, product,
        # sum, activation) where the fused iteration rounds twice
        np.testing.assert_allclose(tlosses, jlosses, rtol=3e-2 if "activation" in mp_kwargs else 2e-2)
        for name in want:
            if name.startswith("bn.running"):  # not stepped: moments of the fingerprints
                torch.testing.assert_close(got[name], want[name], rtol=0.05, atol=0.01, msg=name)
            else:
                assert float((got[name] - want[name]).abs().max()) <= 2 * THREE_LRS, name


def check_message_passing_forward(datasets, monkeypatch, mp_kwargs, dtype):
    """The module alone, in training mode (dropout on where it has one)."""
    _interpret(monkeypatch, dtype)
    jds, tds = datasets
    jdt, tdt = DTYPES[dtype]
    jb = next(iter(jdata.DataLoader(jds, batch_size=32, shuffle=False, prefetch=0))).bmg
    tb = next(iter(DataLoader(tds, batch_size=32, shuffle=False))).bmg
    jmp = JaxBondMP(d_h=D_H, compute_dtype=jdt, **mp_kwargs)
    variables = jmp.init(jax.random.PRNGKey(0), jb, None, False)
    if mp_kwargs.get("bias"):  # flax starts the biases at zero-mean noise; make them count
        variables = jax.tree_util.tree_map(lambda x: x + 0.05 if x.ndim == 1 else x, variables)
    masks = _Masks(monkeypatch) if "dropout" in mp_kwargs else None
    want = np.asarray(
        jmp.apply(variables, jb, None, True, rngs={"dropout": jax.random.PRNGKey(1)}), np.float32
    )
    mp = BondMessagePassing(d_h=D_H, compute_dtype=tdt, kernel_options=PER_ITERATION, **mp_kwargs)
    sd = from_jax_params({"message_passing": variables["params"], "predictor": {"ffn": {}}})
    mp.load_state_dict({k.removeprefix("message_passing."): v for k, v in sd.items()})
    got = mp(tb, is_training=True, generator=torch.Generator().manual_seed(0))
    assert masks is None or not masks.masks  # every recorded mask was used
    got = got.detach().float().numpy()[:, :D_H]
    real = tb.node_mask.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got[real], want[real], rtol=1e-4, atol=1e-5)
    else:  # the JAX package's bf16 parity envelope
        np.testing.assert_allclose(got[real], want[real], rtol=0.05, atol=0.1)


# the three steps take the longest: undirected runs them in float32 only
@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "undirected_bf16"])
def test_three_adam_steps_match_jax(datasets, per_iteration_jax, monkeypatch, variant):
    check_three_adam_steps(datasets, monkeypatch, *VARIANTS[variant])


@pytest.mark.parametrize("variant", VARIANTS)
def test_message_passing_forward_matches_jax(datasets, per_iteration_jax, monkeypatch, variant):
    check_message_passing_forward(datasets, monkeypatch, *VARIANTS[variant])
