"""Stdlib HTTP front end of the batching inference engine (port of
tmdiff_tpu/serve/server.py).

Endpoints:
  POST /v1/pansharpen   body = .npz bytes with arrays `pan` (1,H,W) or (H,W)
                        and `ms` (bands,H,W); optional scalar string array
                        `sensor` (default "QB") and scalar `guidance`
                        (dpm++_cfg engines); for a model that takes
                        them (the ControlNet), `hint` (H,W,C) and a
                        scalar string `task` (a UniControl task name).
                        Response: .npz with `sr`
                        (bands,H,W) float32 in [0,1], and `seed`, `bucket`
                        and `row`, where the request rode (the engine's
                        `placement`).
  GET  /healthz         {"ok": true} once the engine is up.
  GET  /v1/stats        engine counters (requests, batches, padding,
                        batch sizes, mean latency, rejections).

A malformed request gets 400, a full queue 503 with `Retry-After: 1`.
`ThreadingHTTPServer` gives each in-flight request a thread that blocks on
its engine future, so concurrent clients are coalesced into batches by the
engine's worker; the HTTP layer adds no queueing of its own. Over a mesh
(serve/mesh.py) only rank 0 runs this server, /healthz included; the
/v1/stats keys are the JAX server's on a mesh too.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tmdiff_tpu_torch.serve.engine import EngineOverloaded, InferenceEngine


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    engine: InferenceEngine = None  # set by make_server

    def log_message(self, *args):  # quiet; /v1/stats is the record
        pass

    def _reply(self, code: int, body: bytes, ctype: str, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj, headers=()):
        self._reply(code, json.dumps(obj).encode(), "application/json", headers)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply_json(200, {"ok": True})
        elif self.path == "/v1/stats":
            s = dict(self.engine.stats)
            n = max(s["requests"], 1)
            s["mean_latency_ms"] = round(s.pop("latency_ms_sum") / n, 2)
            s["batch_size_hist"] = {str(k): v for k, v in sorted(s["batch_size_hist"].items())}
            self._reply_json(200, s)
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/v1/pansharpen":
            self._reply_json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            data = np.load(io.BytesIO(self.rfile.read(length)))
            pan, ms = data["pan"], data["ms"]
            sensor = str(data["sensor"]) if "sensor" in data else "QB"
            guidance = float(data["guidance"]) if "guidance" in data else None
            hint = data["hint"] if "hint" in data else None
            task = str(data["task"]) if "task" in data else None
            fut = self.engine.submit(pan, ms, sensor=sensor, guidance=guidance, hint=hint,
                                     task=task)
            sr = fut.result()
        except EngineOverloaded as err:
            self._reply_json(503, {"error": str(err)}, headers=[("Retry-After", "1")])
            return
        except Exception as err:
            self._reply_json(400, {"error": str(err)})
            return
        self._reply(200, _npz_bytes(sr=np.asarray(sr, np.float32), **fut.placement),
                    "application/octet-stream")


def make_server(engine: InferenceEngine, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"engine": engine})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
