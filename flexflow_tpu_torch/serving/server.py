"""Minimal HTTP JSON endpoint for generation (stdlib only), the
generation half of flexflow_tpu/serving/server.py.

POST /v2/generate  {"prompt": [ids...]} or {"prompts": [[ids...], ...]},
                   optional "max_new_tokens" (int, default 16),
                   "temperature" (float), "timeout_s" (float, default
                   120; an expired wait returns 503 and the request still
                   completes server-side), "deadline_s" (float: the TTFT
                   a ServingFront's admission control holds the request
                   to) -> {"tokens": [[ids...], ...]}
GET  /v2/health    -> {"status": "ok"|"degraded", "requests": N};
                   a single engine is "degraded" (HTTP 503) when its
                   worker thread has died.  A ServingFront aggregates its
                   replicas instead: ok (all live, 200), degraded (some
                   live: still serving, 200), down (none live, 503), with
                   a "replicas" list
GET  /v2/stats     -> step/request counters, latency percentiles and the
                   engine's "continuous" block (KV pool, prefix cache,
                   speculative decoding, paged-kernel reads, TTFT; a
                   ServingFront's per-replica blocks under "replicas")
GET  /metrics      -> Prometheus text exposition (version 0.0.4) of the
                   registry passed as serve_http(registry=...); 404 when
                   none is attached

A request the front sheds, or whose retries ran out
(front.ServiceUnavailable), returns 503 with a Retry-After header from
the front's measured drain rate.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def serve_http(generator, host: str = "127.0.0.1", port: int = 8000,
               block: bool = True, registry=None):
    """Serve a ContinuousScheduler or a ServingFront over HTTP.  Returns the server; with
    block=False it runs on a daemon thread (server.shutdown() stops
    it, server.server_close() frees the socket).  With `registry`
    (obs.metrics.MetricsRegistry), GET /metrics renders it as
    Prometheus text."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, body: str, content_type: str):
            raw = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self):
            if self.path == "/metrics":
                if registry is None:
                    self._send(404, {"error": "no metrics registry "
                                     "attached (serve_http registry=)"})
                    return
                from ..obs.metrics import to_prometheus

                # the content type Prometheus's scraper negotiates for
                self._send_text(200, to_prometheus(registry),
                                "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/v2/health":
                if hasattr(generator, "health"):
                    # a replicated front: degraded still serves, so only
                    # "down" takes the 503 that drops the backend from
                    # status-code-only probes
                    payload = dict(generator.health())
                    payload["requests"] = generator.batches_run
                    self._send(503 if payload["status"] == "down" else 200,
                               payload)
                    return
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
                kw = {}
                if (req.get("deadline_s") is not None
                        and hasattr(generator, "admission_deadline_s")):
                    kw["deadline_s"] = float(req["deadline_s"])
                handles = [generator.generate_async(p, mnt, temp, **kw)
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
            except Exception as e:  # noqa: BLE001 - reported below
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    # shed, or retries exhausted: 503 and a Retry-After,
                    # so clients back off
                    self._send(
                        503, {"error": f"{type(e).__name__}: {e}",
                              "retriable": True},
                        headers={"Retry-After":
                                 str(max(1, int(round(retry_after))))})
                    return
                # an engine fault: 500, retriable
                self._send(500, {"error": f"{type(e).__name__}: {e}",
                                 "retriable": True})

    server = ThreadingHTTPServer((host, port), Handler)
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
