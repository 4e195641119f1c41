"""HTTP metrics and traces exporter, the `--metrics_port` endpoint (the
port's copy of jubatus_tpu/obs/exporter.py).

A small threaded HTTP server (stdlib only) serving:

  /metrics       Prometheus text of the node's flat metrics map
                 (utils/metrics.render_prometheus): the same map
                 get_status merges and get_metrics returns
  /metrics.json  the whole map as JSON (non-numeric values too)
  /traces.json   the span ring (obs/trace.py)
  /livez         liveness: 200 while the process serves HTTP
  /healthz       readiness, and /fleet.json, the fleet snapshot: they
                 read obs/health.py and obs/fleet.py, which are ROADMAP
                 Queue 1 item 7; until then both answer 404 with a body
                 that names the item

Off by default (`--metrics_port 0`); a negative port binds an ephemeral
one.  The bound port is reported in get_status (`metrics_port`) and on
the CLI's ready line.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from jubatus_tpu_torch.obs.trace import TRACER, Tracer
from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics
from jubatus_tpu_torch.utils.metrics import render_prometheus

log = logging.getLogger("jubatus_tpu_torch.obs")


# the JAX exporter's endpoints of later items, answered 404 with the item
LATER_PATHS = {
    "/healthz": "/healthz reads obs/health.py, which is not in the port "
                "yet: ROADMAP Queue 1 item 7 (use /livez for liveness)",
    "/fleet.json": "/fleet.json reads obs/fleet.py, which is not in the "
                   "port yet: ROADMAP Queue 1 item 7",
}


class MetricsExporter:
    """Serve the node's metrics map and trace ring over HTTP.

    `collect()` returns the flat {name: value} map: the server passes
    its `metrics_snapshot`, the proxy its own; the default, the bare
    process registry, keeps the exporter usable alone."""

    def __init__(self, collect: Optional[Callable[[], Dict[str, str]]] = None,
                 tracer: Optional[Tracer] = None, ident: str = "",
                 host: str = "0.0.0.0"):
        self.collect = collect if collect is not None else _metrics.snapshot
        self.tracer = tracer if tracer is not None else TRACER
        self.ident = ident
        self.host = host
        self.port = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, port: int) -> int:
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # keep the access log out
                pass                            # of the server's stderr

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.partition("?")[0]
                try:
                    if path == "/metrics":
                        body = render_prometheus(exporter.collect()).encode()
                        self._send(body, "text/plain; version=0.0.4")
                    elif path == "/metrics.json":
                        body = json.dumps(
                            {"ident": exporter.ident,
                             "metrics": exporter.collect()},
                            default=str).encode()
                        self._send(body, "application/json")
                    elif path == "/traces.json":
                        body = json.dumps(
                            {"ident": exporter.ident,
                             "spans": exporter.tracer.snapshot()},
                            default=str).encode()
                        self._send(body, "application/json")
                    elif path == "/livez":
                        self._send(b"ok\n", "text/plain")
                    elif path in LATER_PATHS:
                        self._send(LATER_PATHS[path].encode() + b"\n",
                                   "text/plain", 404)
                    else:
                        self._send(b"not found\n", "text/plain", 404)
                except Exception as e:  # noqa: BLE001 - a scrape must not
                    log.warning("exporter error on %s: %s", path, e)
                    try:                # kill the serving thread
                        self._send(str(e).encode(), "text/plain", 500)
                    except Exception as e2:
                        # peer hung up mid-error-reply: count, don't hide
                        _metrics.inc("exporter_swallowed_error_total")
                        log.debug("exporter 500 reply failed: %s", e2)

        self._httpd = ThreadingHTTPServer((self.host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="metrics-http")
        self._thread.start()
        log.info("metrics exporter listening on %s:%d", self.host, self.port)
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
