"""Exposition endpoints: stdlib-HTTP ``/metrics`` and JSON timelines.

``serve_metrics(registry)`` starts a daemon-thread HTTP server (port 0 =
ephemeral) serving:

  * ``GET /metrics``       — Prometheus text exposition (version 0.0.4)
  * ``GET /timeline.json`` — the tracer's full event dump (404 if no tracer)
  * ``GET /``              — a one-line index

No third-party dependencies; safe to leave running for the lifetime of a
simulation or a real deployment process.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import Tracer

__all__ = ["MetricsServer", "serve_metrics", "render_prom",
           "timeline_json", "write_timeline_json"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def render_prom(registry: MetricsRegistry) -> str:
    """Free-function alias for ``registry.render_prom()``."""
    return registry.render_prom()


def timeline_json(tracer: Tracer, indent: Optional[int] = 1) -> str:
    """Free-function alias for ``tracer.to_json()``."""
    return tracer.to_json(indent=indent)


def write_timeline_json(tracer: Tracer, path: str, indent: Optional[int] = 1) -> str:
    """Dump the tracer's events to ``path``; returns the path."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(tracer.to_json(indent=indent))
    return path


class MetricsServer:
    """Tiny threaded HTTP server exposing a registry (and optional tracer)."""

    def __init__(self, registry: MetricsRegistry, tracer: Optional[Tracer] = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.registry = registry
        self.tracer = tracer
        srv_self = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request stderr spam
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = srv_self.registry.render_prom().encode("utf-8")
                    self._send(200, body, PROM_CONTENT_TYPE)
                elif path == "/timeline.json":
                    if srv_self.tracer is None:
                        self._send(404, b"no tracer attached\n", "text/plain")
                    else:
                        body = srv_self.tracer.to_json(indent=1).encode("utf-8")
                        self._send(200, body, "application/json")
                elif path == "/":
                    self._send(200, b"sdflmq telemetry: /metrics /timeline.json\n",
                               "text/plain")
                else:
                    self._send(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="sdflmq-metrics", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def serve_metrics(registry: MetricsRegistry, tracer: Optional[Tracer] = None,
                  host: str = "127.0.0.1", port: int = 0) -> MetricsServer:
    """Start a daemon ``/metrics`` endpoint; returns the running server.

    ``port=0`` picks an ephemeral port — read it back from ``server.port``.
    """
    return MetricsServer(registry, tracer=tracer, host=host, port=port)
