"""Text metrics endpoint (DESIGN.md §9.1): a daemon-thread HTTP server
exposing one registry as ``GET /metrics`` plain text — what
``launch/serve.py --retrieval --metrics-port`` stands up next to a serving
process.  A copy of ``repro.obs.exporter``.
"""

from __future__ import annotations

import http.server
import json
import threading

__all__ = ["MetricsServer", "start_metrics_server"]


class MetricsServer:
    """Handle for a running metrics endpoint: ``.port`` (useful when
    bound to port 0) and ``.close()``."""

    def __init__(self, httpd, thread):
        self._httpd = httpd
        self._thread = thread
        self.port = httpd.server_address[1]

    def close(self) -> None:
        """Shut the endpoint down and join its thread."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(registry, port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Serve ``registry`` on ``http://host:port``:

    * ``GET /metrics`` — Prometheus-style text
      (``MetricsRegistry.render_text``);
    * ``GET /metrics.json`` — the raw ``snapshot()`` as JSON.

    ``port=0`` binds an ephemeral port (read it off the returned
    handle).  The server runs on a daemon thread; scrapes never touch
    the serving hot path beyond each instrument's own lock."""

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/metrics.json"):
                body = json.dumps(registry.snapshot(),
                                  sort_keys=True).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics") or self.path == "/":
                body = registry.render_text().encode()
                ctype = "text/plain; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):   # quiet: no stderr per scrape
            pass

    httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="metrics-exporter")
    t.start()
    return MetricsServer(httpd, t)
