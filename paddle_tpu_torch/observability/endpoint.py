"""Live observability endpoint: /metrics, /healthz, /varz over the
stdlib's http.server (the port of the JAX package's
``observability/endpoint.py``).

Off by default; ``PTPU_METRICS_PORT=<port>`` (0 = an ephemeral port)
makes ``observability`` start one daemon ThreadingHTTPServer bound to
127.0.0.1 at import, or call ``start(port=0)``. No flag, no thread.

Routes:
  /metrics  Prometheus text 0.0.4: exactly `registry().to_prometheus()`.
  /healthz  JSON snapshot of every registered health provider (the
            router registers its replica states, each engine its
            workers' `health()`); HTTP 503 when a provider raises, 200
            otherwise.
  /varz     the registry as JSON: `registry().to_dict()`, the schema of
            `dump_json` and tools/ptpu_stats.py.
  anything else 404; a scrape that fails inside the handler 500.

Health providers register only while the endpoint is enabled, so a
flag-off run never grows the provider dict (and never pins engines
live through it).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import flags as _flags
from ..analysis.concurrency import make_lock
from . import metrics as _metrics

__all__ = ["enabled", "start", "stop", "port", "url",
           "register_health_provider", "unregister_health_provider",
           "health_snapshot"]


_server = None
_thread = None
_providers = {}  # name -> zero-arg callable returning a JSON-able dict
_providers_lock = threading.Lock()  # replaced by a tracked lock in start


def enabled():
    """True when the endpoint is running or flag-configured to run."""
    if _server is not None:
        return True
    return _flags.env("PTPU_METRICS_PORT") is not None


def register_health_provider(name, fn):
    """Expose `fn()`'s dict under /healthz key `name` (engines and
    routers call this at construction when the endpoint is enabled). Last
    registration per name wins — a restarted engine replaces its
    predecessor's snapshot."""
    with _providers_lock:
        _providers[name] = fn


def unregister_health_provider(name):
    with _providers_lock:
        _providers.pop(name, None)


def health_snapshot():
    """(http_status, doc): every provider's report, with a top-level
    "status" of ok/degraded. A provider raising is itself a health
    signal (a dead engine's lock may be poisoned) — recorded as its
    error string, never propagated into the serving thread."""
    with _providers_lock:
        providers = dict(_providers)
    doc = {"status": "ok", "providers": {}}
    status = 200
    for name, fn in sorted(providers.items()):
        try:
            doc["providers"][name] = fn()
        except Exception as e:  # noqa: BLE001 — scrape must not die
            doc["providers"][name] = {"error": str(e)}
            doc["status"] = "degraded"
            status = 503
    return status, doc


class _Handler(BaseHTTPRequestHandler):
    server_version = "ptpu-obs"

    def log_message(self, fmt, *args):  # no stderr chatter per scrape
        pass

    def _reply(self, status, content_type, body):
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 — http.server's required spelling
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._reply(200, "text/plain; version=0.0.4",
                            _metrics.to_prometheus())
            elif path == "/varz":
                self._reply(200, "application/json",
                            json.dumps(_metrics.registry().to_dict(),
                                       sort_keys=True))
            elif path == "/healthz":
                status, doc = health_snapshot()
                self._reply(status, "application/json",
                            json.dumps(doc, sort_keys=True))
            else:
                self._reply(404, "text/plain",
                            "unknown route %s (try /metrics, /healthz, "
                            "/varz)\n" % path)
        except Exception as e:  # noqa: BLE001 — a scrape bug must not
            # kill the server thread; surface it to the scraper instead
            try:
                self._reply(500, "text/plain", "scrape error: %s\n" % e)
            except OSError:
                pass


def start(port=None, host="127.0.0.1"):
    """Start the endpoint thread (idempotent; returns the bound port).
    `port=None` reads PTPU_METRICS_PORT; port 0 binds an ephemeral port
    readable back through `port()`."""
    global _server, _thread, _providers_lock
    if _server is not None:
        return _server.server_address[1]
    if port is None:
        port = _flags.env("PTPU_METRICS_PORT")
        if port is None:
            raise ValueError(
                "endpoint.start() needs a port (PTPU_METRICS_PORT unset)")
    _providers_lock = make_lock("obs.endpoint")
    _server = ThreadingHTTPServer((host, int(port)), _Handler)
    _server.daemon_threads = True
    _thread = threading.Thread(target=_server.serve_forever,
                               name="ptpu-metrics-endpoint", daemon=True)
    _thread.start()
    return _server.server_address[1]


def stop():
    """Shut the endpoint down and join its thread (tests; production
    runs just let the daemon thread die with the process)."""
    global _server, _thread
    if _server is None:
        return
    _server.shutdown()
    _server.server_close()
    _thread.join(timeout=10)
    _server = None
    _thread = None


def port():
    """The bound port, or None when not running."""
    return _server.server_address[1] if _server is not None else None


def url(route="/metrics"):
    """http://127.0.0.1:<port><route>, or None when not running."""
    p = port()
    return None if p is None else "http://127.0.0.1:%d%s" % (p, route)
