"""``serve``: a warm model behind a standard-library HTTP server (cf.
``chemprop_tpu/cli/serve.py``), on the GPU unless ``--device`` says otherwise.

    python -m chemprop_tpu_torch.cli serve --model-paths out/best.ckpt
        [--port 8000] [--device cpu] [--dtype float32|bfloat16]

* ``POST /predict``, body ``{"smiles": ["CCO", ...]}`` ->
  ``{"preds": [[...], ...], "columns": [...]}``: the mean over
  ``--model-paths`` (an ensemble; each a reference ``.pt`` or a ``CPTPU001``
  file), each row flattened; an invalid SMILES comes back as ``null`` with
  its message in ``errors`` (by the row's index) and the other rows are
  served. An empty or malformed body is 400, more than ``--max-batch``
  molecules 413, an unknown path 404, a failed dispatch 500.
* ``GET /health`` -> ``{"status": "ok", "models": ..., "columns": ...,
  "requests": N, "dispatches": M}``.

Requests are featurised on the server's threads and queued; one dispatcher
thread drains the queue into one padded batch (up to ``max_coalesce``
molecules, lingering 5 ms after the first request so that concurrent ones
join it), on the bucket ladder of graph counts over ``PadSpec.for_graphs``,
runs every model on it and hands each request its rows: N concurrent small
requests cost about one dispatch. The dispatcher is the only thread that
launches kernels, so the host counters ``ops.LAUNCHES`` and ``ops.UNSERVED``
are bumped by it alone; it runs under ``torch.inference_mode`` (grad mode is
per thread). ``make_server`` serves a few requests of drug-sized molecules
before it listens, so that the kernels are built and the tile tables checked
before the first client's request. ``--dtype`` is the checkpoints' own by
default (float32 for a reference file). A model that takes extra inputs is
refused, as in ``predict``."""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from chemprop_tpu_torch.cli.common import DTYPES
from chemprop_tpu_torch.cli.parsing import featurizer_for
from chemprop_tpu_torch.cli.predict import check_plain_inputs
from chemprop_tpu_torch.cli.utils.command import Subcommand
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.data.datapoints import MoleculeDatapoint
from chemprop_tpu_torch.models.load import load_model
from chemprop_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# drug-sized molecules for the warm-up requests
WARM_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O",  # aspirin (21 atoms)
    "CN1CCC[C@H]1c1cccnc1",  # nicotine
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",  # ibuprofen
    "COc1cc2c(cc1OC)CC[NH+](C)CC2",  # drug-like, charged
]


def add_serve_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--model-paths", "--model-path", nargs="+", type=Path, required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=256, help="max molecules per request")
    parser.add_argument(
        "--warmup-buckets", type=int, nargs="+", default=[8, 64],
        help="request sizes served once before listening",
    )
    parser.add_argument("--keep-h", action="store_true")
    parser.add_argument("--add-h", action="store_true")
    parser.add_argument(
        "--multi-hot-atom-featurizer-mode", default="v2",
        choices=["v1", "v2", "organic", "rigr"],
    )
    parser.add_argument("--device", help="torch device (default: cuda; raises without a GPU)")
    parser.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                        help="message-passing compute dtype (default: the checkpoint's)")
    return parser


def _bucket(n: int) -> int:
    """The graph count a dispatch of ``n`` molecules is padded to: 8, 16, 32, ..."""
    b = 8
    while b < n:
        b *= 2
    return b


class ModelService:
    """The models of ``model_paths`` on ``device``, served through one
    coalescing dispatcher thread (an ensemble's mean)."""

    def __init__(self, model_paths, featurizer_mode: str = "v2", keep_h: bool = False,
                 add_h: bool = False, device: str | torch.device | None = None,
                 dtype: str | None = None):
        self.device = resolve_device(device)  # raises where there is no GPU
        self.keep_h, self.add_h = keep_h, add_h
        self.featurizer = featurizer_for(featurizer_mode)
        self.models = []
        self.output_columns = None
        for p in model_paths:
            model, columns = load_model(p, self.device, DTYPES[dtype] if dtype else None)
            check_plain_inputs(model, self.featurizer)
            self.models.append(model)
            self.output_columns = columns or self.output_columns
        self.requests = 0
        self.dispatches = 0
        self.max_coalesce = 256
        # after the first request of a dispatch arrives, linger briefly so
        # that concurrent requests join the same padded dispatch
        self.coalesce_linger_s = 0.005
        self._lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._dispatcher.start()

    def _featurize(self, smis: list[str]):
        graphs, errors = [], {}
        for i, smi in enumerate(smis):
            try:
                dp = MoleculeDatapoint.from_smi(smi, keep_h=self.keep_h, add_h=self.add_h,
                                                y=np.zeros(1))
                graphs.append(self.featurizer(dp.mol))
            except Exception as e:  # noqa: BLE001 — a bad SMILES must not fail the request
                graphs.append(None)
                errors[i] = str(e)
        return graphs, errors

    def predict(self, smis: list[str]) -> tuple[list, dict]:
        """``(one flattened prediction row per SMILES or None, {index: error})``."""
        graphs, errors = self._featurize(smis)
        ok = [g for g in graphs if g is not None]
        with self._lock:
            self.requests += 1
        if not ok:
            return [None] * len(smis), errors
        item = {"graphs": ok, "event": threading.Event(), "result": None, "error": None}
        self._queue.put(item)
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        rows = iter(item["result"])
        preds = [None if g is None else np.asarray(next(rows), np.float64).reshape(-1).tolist()
                 for g in graphs]
        return preds, errors

    def close(self) -> None:
        """Stop the dispatcher thread once the queue before it is served."""
        self._queue.put(None)
        self._dispatcher.join()

    def _dispatch_loop(self) -> None:
        with torch.inference_mode():
            while True:
                first = self._queue.get()
                if first is None:
                    return
                items, total, stop = [first], len(first["graphs"]), False
                deadline = time.monotonic() + self.coalesce_linger_s
                while total < self.max_coalesce:
                    try:
                        nxt = self._queue.get(timeout=max(0.0, deadline - time.monotonic()))
                    except queue.Empty:
                        break
                    if nxt is None:
                        stop = True
                        break
                    items.append(nxt)
                    total += len(nxt["graphs"])
                self._dispatch(items)
                if stop:
                    return

    def _dispatch(self, items: list[dict]) -> None:
        """One padded batch of every item's graphs through every model."""
        try:
            allg = [g for it in items for g in it["graphs"]]
            pad = PadSpec.for_graphs(allg, n_graphs=_bucket(len(allg)))
            bmg = batch_mol_graphs(allg, pad).to(self.device)
            self.dispatches += 1
            outs = [model(bmg)[: len(allg)].float().cpu().numpy() for model in self.models]
            mean = np.mean(np.stack(outs), axis=0)
            k = 0
            for it in items:
                n = len(it["graphs"])
                it["result"] = mean[k : k + n]
                k += n
        except Exception as e:  # noqa: BLE001 — fail the requests, not the server
            for it in items:
                it["error"] = e
        finally:
            for it in items:
                it["event"].set()


def _make_handler(service: ModelService, max_batch: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # to logging, not stderr
            logger.debug("serve: " + fmt, *args)

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "models": len(service.models),
                                 "columns": service.output_columns,
                                 "requests": service.requests,
                                 "dispatches": service.dispatches})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                smis = req.get("smiles") if isinstance(req, dict) else None
                if not isinstance(smis, list) or not smis:
                    self._send(400, {"error": "body must be {'smiles': [..]}"})
                    return
                if len(smis) > max_batch:
                    self._send(413, {"error": f"max {max_batch} molecules per request"})
                    return
                preds, errors = service.predict([str(s) for s in smis])
                out = {"preds": preds, "columns": service.output_columns}
                if errors:
                    out["errors"] = {str(k): v for k, v in errors.items()}
                self._send(200, out)
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"invalid JSON: {e}"})
            except Exception as e:  # noqa: BLE001
                logger.exception("predict failed")
                self._send(500, {"error": str(e)})

    return Handler


class _Server(ThreadingHTTPServer):
    # the default listen backlog (5) resets connections under bursts of more
    # concurrent clients, the load the coalescing linger invites
    request_queue_size = 128
    daemon_threads = True


def make_server(args) -> tuple[ThreadingHTTPServer, ModelService]:
    """The server (bound, not yet serving) and its warmed service."""
    service = ModelService(args.model_paths, featurizer_mode=args.multi_hot_atom_featurizer_mode,
                           keep_h=args.keep_h, add_h=args.add_h, device=args.device,
                           dtype=args.dtype)
    for n in args.warmup_buckets:
        service.predict((WARM_SMILES * (n // len(WARM_SMILES) + 1))[:n])
    server = _Server((args.host, args.port), _make_handler(service, args.max_batch))
    return server, service


def main(args) -> int:
    server, service = make_server(args)
    host, port = server.server_address[:2]
    logger.info("serving %d model(s) on http://%s:%d (POST /predict, GET /health)",
                len(service.models), host, port)
    print(f"serving on http://{host}:{port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0


add_args = add_serve_args


class ServeSubcommand(Subcommand):
    """``serve`` on the command line: :func:`add_args` and :func:`main`."""

    COMMAND = "serve"
    HELP = "serve trained models over HTTP"
    add_args = staticmethod(add_args)
    func = staticmethod(main)
