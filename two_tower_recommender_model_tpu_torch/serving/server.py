"""HTTP model server with the Databricks-serving invocation contract.

Port of `two_tower_recommender_model_tpu/serving/server.py` (stdlib only):

    POST /invocations   {"inputs": {"user_id": [...], "product_id": [...]}}
                     -> {"predictions": [p0, p1, ...]}
    POST /retrieve      {"user_id": [...], "k": 10}   (with a RetrievalService)
                     -> {"items": [[...]], "scores": [[...]]}
    GET  /health        -> {"status": "ok"}

`/invocations` also takes the `dataframe_split` ({"columns": [...], "data":
[[...]]}) and `dataframe_records` payload forms. Malformed requests answer
400, model or runtime errors 500; requests can be captured to a JSON-lines
inference log.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from two_tower_recommender_model_tpu_torch.serving.scorer import Scorer

log = logging.getLogger(__name__)


def _parse_payload(payload: dict) -> dict:
    if "inputs" in payload:
        return payload["inputs"]
    if "dataframe_split" in payload:
        split = payload["dataframe_split"]
        cols = split["columns"]
        data = np.asarray(split["data"], dtype=object)
        return {c: data[:, i].tolist() for i, c in enumerate(cols)}
    if "dataframe_records" in payload:
        records = payload["dataframe_records"]
        keys = records[0].keys()
        return {k: [r[k] for r in records] for k in keys}
    raise ValueError("payload must contain 'inputs', 'dataframe_split' or 'dataframe_records'")


class ModelServer:
    def __init__(self, scorer: Scorer, host: str = "127.0.0.1", port: int = 0,
                 capture_path: str | None = None, retrieval=None):
        """`retrieval`: optional `RetrievalService` enabling POST /retrieve."""
        self.scorer = scorer
        self.capture_path = capture_path
        self.retrieval = retrieval
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def _reply(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path in ("/health", "/ping"):
                    self._reply(200, {"status": "ok"})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if self.path == "/invocations":
                        inputs = _parse_payload(payload)
                        preds = outer.scorer.predict(inputs).tolist()
                        if outer.capture_path:
                            with open(outer.capture_path, "a") as f:
                                f.write(json.dumps({"ts": time.time(),
                                                    "inputs": _jsonable(inputs),
                                                    "predictions": preds}) + "\n")
                        self._reply(200, {"predictions": preds})
                    elif self.path == "/retrieve":
                        if outer.retrieval is None:
                            self._reply(404, {"error": "no retrieval service configured"})
                            return
                        user_ids = payload["user_id"]
                        k = int(payload.get("k", 100))
                        items, scores = outer.retrieval.retrieve(user_ids, k=k)
                        self._reply(200, {"items": items.tolist(),
                                          "scores": scores.tolist()})
                    else:
                        self._reply(404, {"error": f"unknown path {self.path}"})
                except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:  # model/runtime error
                    log.exception("invocation failed")
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ModelServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def validate_serving_input(scorer: Scorer, payload: dict) -> np.ndarray:
    """Pre-deployment contract check: parse the exact REST payload and score
    it, raising on contract violations."""
    return scorer.predict(_parse_payload(payload))


def _jsonable(inputs):
    return {k: (np.asarray(v).tolist() if not isinstance(v, list) else v)
            for k, v in inputs.items()}
