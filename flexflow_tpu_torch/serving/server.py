"""Minimal HTTP JSON endpoint for generation (stdlib only), the
generation half of flexflow_tpu/serving/server.py.

POST /v2/generate  {"prompt": [ids...]} or {"prompts": [[ids...], ...]},
                   optional "max_new_tokens" (int, default 16),
                   "temperature" (float), "timeout_s" (float, default
                   120; an expired wait returns 503 and the request still
                   completes server-side) -> {"tokens": [[ids...], ...]}
GET  /v2/health    -> {"status": "ok"|"degraded", "requests": N};
                   "degraded" (HTTP 503) when the engine's worker thread
                   has died
GET  /v2/stats     -> step/request counters, latency percentiles and the
                   engine's "continuous" block (KV pool, prefix cache,
                   paged-kernel reads, TTFT)
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def serve_http(generator, host: str = "127.0.0.1", port: int = 8000,
               block: bool = True):
    """Serve a ContinuousScheduler over HTTP.  Returns the server; with
    block=False it runs on a daemon thread (server.shutdown() stops
    it, server.server_close() frees the socket)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v2/health":
                dead = not generator.worker_alive
                self._send(503 if dead else 200,
                           {"status": "degraded" if dead else "ok",
                            "requests": generator.batches_run})
            elif self.path == "/v2/stats":
                self._send(200, {
                    "batches_run": generator.batches_run,
                    "requests_done": generator.requests_done,
                    "latency": generator.latency_stats(),
                    "continuous": generator.stats(),
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path != "/v2/generate":
                    self._send(404, {"error": "not found"})
                    return
                prompts = req.get("prompts")
                if prompts is None:
                    prompts = [req["prompt"]]
                mnt = int(req.get("max_new_tokens", 16))
                temp = float(req.get("temperature", 0.0))
                timeout = float(req.get("timeout_s", 120.0))
                if timeout <= 0:
                    raise ValueError(f"timeout_s must be > 0, got {timeout}")
                handles = [generator.generate_async(p, mnt, temp)
                           for p in prompts]
                # ONE deadline for the whole request
                deadline = time.monotonic() + timeout
                toks = [h.wait(max(0.0, deadline - time.monotonic()))
                        for h in handles]
                self._send(200, {"tokens": toks})
            except TimeoutError as e:
                self._send(503, {"error": f"TimeoutError: {e}",
                                 "retriable": True})
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                # malformed request: the client's fault
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 - engine fault: report 500
                self._send(500, {"error": f"{type(e).__name__}: {e}",
                                 "retriable": True})

    server = ThreadingHTTPServer((host, port), Handler)
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
