"""Stdlib HTTP scrape endpoint for the health plane.

``GatewayConfig(metrics_port=...)`` starts one of these next to the
gateway.  Three routes, all GET:

  ``/metrics``  Prometheus text exposition of ``snapshot_stats()``
  ``/health``   JSON health report; 200 unless the overall status is
                ``critical`` -> 503 (load-balancer friendly)
  ``/slowlog``  the slow-request span trees as JSON

Port 0 binds an ephemeral port (tests); the bound port is exposed as
``server.port``.  Built on ``http.server.ThreadingHTTPServer`` so the
repo stays dependency-free.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from .export import prometheus_text

__all__ = ["HealthHTTPServer"]


class HealthHTTPServer:
    """Serve /metrics, /health, and /slowlog for one gateway."""

    def __init__(self, stats_fn: Callable[[], dict],
                 health_fn: Callable[[], dict],
                 slowlog_fn: Optional[Callable[[], List[dict]]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 namespace: str = "repro"):
        self.stats_fn = stats_fn
        self.health_fn = health_fn
        self.slowlog_fn = slowlog_fn
        self.namespace = namespace
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 - silence stderr
                pass

            def do_GET(self):  # noqa: N802 - http.server API
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = prometheus_text(
                            outer.stats_fn(), namespace=outer.namespace)
                        self._send(200, body.encode("utf-8"),
                                   "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/health":
                        report = outer.health_fn()
                        code = 503 if report.get("status") == "critical" else 200
                        self._send_json(code, report)
                    elif path == "/slowlog":
                        entries = outer.slowlog_fn() if outer.slowlog_fn else []
                        self._send_json(200, {"slow_requests": entries})
                    else:
                        self._send_json(404, {"error": f"no route {path}"})
                except Exception as exc:  # surface handler bugs as 500s
                    try:
                        self._send_json(500, {"error": repr(exc)})
                    except Exception:
                        pass

            def _send_json(self, code: int, payload: dict):
                body = json.dumps(payload, sort_keys=True).encode("utf-8")
                self._send(code, body, "application/json")

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http", daemon=True,
            kwargs={"poll_interval": 0.1})
        self._thread.start()
        self._closed = False

    def close(self, timeout: float = 2.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=timeout)
