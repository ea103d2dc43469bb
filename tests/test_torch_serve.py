"""The port's ``serve`` against the JAX package's ``ModelService`` on the
CPU, and its HTTP surface: health, errors, the request limit and the
coalescing of concurrent requests."""

from __future__ import annotations

import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from chemprop_tpu.cli.serve import ModelService as JaxModelService
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.cli.parsing import build_datasets, make_datapoints, parse_csv
from chemprop_tpu_torch.cli.serve import ModelService, _bucket, make_server
from chemprop_tpu_torch.cli.train import build_model
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.nn.init import init_parameters

SMILES = ["CCO", "c1ccccc1O", "not a smiles", "CC(=O)Oc1ccccc1C(=O)O", "C1CC",
          "CN1CCC[C@H]1c1cccnc1", "[Na+].[Cl-]", "C"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, data_dir):
    """Two CPTPU001 files of a small model (batch norm, one with a bias and
    an MVE head), their parameters made from seeds."""
    root = tmp_path_factory.mktemp("serve")
    mol_csv = data_dir / "regression/mol/mol.csv"
    ds = build_datasets(make_datapoints(*parse_csv(mol_csv, None, None, None)[:6]))
    ds.normalize_targets()
    paths = []
    for seed, extra in ((1, []), (2, ["--message-bias"])):
        args = construct_parser().parse_args(
            ["train", "-i", str(mol_csv), "--batch-norm", "--message-hidden-dim", "48",
             "--ffn-hidden-dim", "24", "--device", "cpu", *extra])
        model = build_model(args, ds)
        init_parameters(model, "lecun", torch.Generator().manual_seed(seed))
        with torch.no_grad():  # batch-norm statistics and unscaling that are not the identity
            model.bn.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(seed))
            model.bn.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed))
            model.predictor.output_transform.mean.fill_(2.0)
            model.predictor.output_transform.scale.fill_(1.5)
        paths.append(root / f"m{seed}.ckpt")
        serialize.save_model(paths[-1], model, ["lipo"])
    return paths


def test_predictions_match_jax_model_service(ckpts):
    want, want_errors = JaxModelService(ckpts).predict(SMILES)
    service = ModelService(ckpts, device="cpu")
    try:
        got, errors = service.predict(SMILES)
    finally:
        service.close()
    assert errors == want_errors and set(errors) == {2, 4}
    assert [g is None for g in got] == [w is None for w in want]
    got_rows = np.array([g for g in got if g is not None])
    want_rows = np.array([w for w in want if w is not None])
    assert got_rows.shape == (6, 1)
    np.testing.assert_allclose(got_rows, want_rows, rtol=1e-5, atol=1e-5)
    assert service.requests == 1 and service.dispatches == 1


def test_a_request_of_invalid_smiles_alone_needs_no_dispatch(ckpts):
    service = ModelService(ckpts[:1], device="cpu")
    try:
        preds, errors = service.predict(["C1CC", "xyz"])
    finally:
        service.close()
    assert preds == [None, None] and set(errors) == {0, 1}
    assert (service.requests, service.dispatches) == (1, 0)


@pytest.mark.parametrize("extra", ["atom_descriptors", "molecule_descriptors"])
def test_a_model_with_extra_inputs_is_refused_at_load(tmp_path, extra):
    """The JAX package's serve passes no extra inputs to its models, so the
    port refuses a model that needs them where it loads, and says so."""
    from chemprop_tpu_torch.models.model import MPNN
    from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN

    mp = BondMessagePassing(d_h=32, d_vd=3 if extra == "atom_descriptors" else None)
    model = MPNN(mp, MeanAggregation(),
                 RegressionFFN(input_dim=mp.output_dim + (4 if extra != "atom_descriptors" else 0),
                               hidden_dim=16))
    path = tmp_path / "extra.ckpt"
    serialize.save_model(path, model)
    with pytest.raises(ValueError, match="JAX package's serve passes none either"):
        ModelService([path], device="cpu")


def test_bucket_ladder():
    assert [_bucket(n) for n in (1, 8, 9, 16, 17, 100, 256)] == [8, 8, 16, 16, 32, 128, 256]


def _call(port: int, path: str, body=None, raw: bytes | None = None):
    url = f"http://127.0.0.1:{port}{path}"
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def server(ckpts):
    args = construct_parser().parse_args(
        ["serve", "--model-paths", *map(str, ckpts), "--port", "0", "--device", "cpu",
         "--max-batch", "32", "--warmup-buckets", "8"])
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1], service
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join()


def test_http_surface(server):
    port, service = server
    assert service.requests == 1  # the warm-up
    status, health = _call(port, "/health")
    assert status == 200 and health["status"] == "ok" and health["models"] == 2
    assert health["columns"] == ["lipo"]
    assert _call(port, "/nope")[0] == 404
    assert _call(port, "/nope", {"smiles": ["C"]})[0] == 404
    assert _call(port, "/predict", {})[0] == 400
    assert _call(port, "/predict", {"smiles": []})[0] == 400
    assert _call(port, "/predict", raw=b"{not json")[0] == 400
    status, body = _call(port, "/predict", {"smiles": ["C"] * 33})
    assert status == 413 and "32" in body["error"]
    status, body = _call(port, "/predict", {"smiles": SMILES})
    assert status == 200 and body["columns"] == ["lipo"]
    assert set(body["errors"]) == {"2", "4"} and body["preds"][2] is None
    want, _ = service.predict(SMILES)
    np.testing.assert_allclose([p for p in body["preds"] if p], [p for p in want if p],
                               rtol=1e-5, atol=1e-5)

    def broken(bmg):
        raise RuntimeError("a model that fails")

    service.models.append(broken)  # a failed dispatch fails its requests, not the server
    try:
        status, body = _call(port, "/predict", {"smiles": ["CCO"]})
    finally:
        service.models.pop()
    assert status == 500 and "a model that fails" in body["error"]
    assert _call(port, "/predict", {"smiles": ["CCO"]})[0] == 200


def test_concurrent_requests_coalesce(server):
    """Sixteen clients at once (more than the cores, with a short switch
    interval) are all counted and served in fewer dispatches than requests,
    each with its own rows (a batch's other rows change only the products'
    summation order)."""
    port, service = server
    service.coalesce_linger_s = 0.5  # wide enough that the burst lands in one window
    rng = np.random.default_rng(0)
    valid = [s for i, s in enumerate(SMILES) if i not in (2, 4)]
    bodies = [[valid[j] for j in rng.integers(0, len(valid), 4)] for _ in range(16)]
    before = (service.requests, service.dispatches)
    results = [None] * 16
    barrier = threading.Barrier(16)

    def client(i):
        barrier.wait()
        results[i] = _call(port, "/predict", {"smiles": bodies[i]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # a lost update of the request count would show
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    status, health = _call(port, "/health")
    requests = health["requests"] - before[0]
    dispatches = health["dispatches"] - before[1]
    assert requests == 16 and 1 <= dispatches < requests
    service.coalesce_linger_s = 0.005
    alone = {s: service.predict([s])[0][0] for s in valid}
    for (status, body), smis in zip(results, bodies):
        assert status == 200
        np.testing.assert_allclose(body["preds"], [alone[s] for s in smis], rtol=1e-5, atol=1e-5)
