"""Serve a trained model over HTTP and query it: the port's ``serve``
subcommand coalesces concurrent requests into single padded dispatches on
the GPU. The port's twin of ``examples/serving.py`` (no reference-notebook
counterpart: serving is a capability this framework adds), through
``chemprop_tpu_torch.cli.serve.make_server``.

Run: python examples_torch/serving.py [--device cuda] [--quick]
"""

import json
import threading
import urllib.request
from types import SimpleNamespace

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("serving")
    run_cli([
        "train", "-i", head(DATA / "regression" / "mol" / "mol.csv", out, args.quick),
        "--epochs", epochs(2, args.quick), "--batch-size", "64", "-o", out,
    ], args.device)

    from chemprop_tpu_torch.cli.serve import make_server

    served = SimpleNamespace(
        model_paths=[next(out.rglob("best.ckpt"))],
        host="127.0.0.1", port=0, max_batch=64, warmup_buckets=[4],
        keep_h=False, add_h=False, multi_hot_atom_featurizer_mode="v2",
        device=args.device, dtype=None,
    )
    server, service = make_server(served)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(
            url + "/predict",
            data=json.dumps({"smiles": ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O"]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join()
    print("served predictions:", body["preds"])
    assert len(body["preds"]) == 3


if __name__ == "__main__":
    main()
