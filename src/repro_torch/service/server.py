"""The /v1 HTTP control-plane daemon (torch port of
``repro.service.server``).

Endpoints (all JSON, all ``repro_torch.serde`` schema-stamped):

=========================  ==================================================
``GET  /v1/health``        liveness + schema/version handshake
``GET  /v1/stats``         counters, staleness state, maintenance stats
``GET  /v1/metrics``       Prometheus text exposition (``?format=json`` for
                           the serde-stamped JSON export) — NOT wrapped in
                           the JSON envelope
``GET  /v1/diameter``      largest-CC diameter (``?exact=1`` forces refresh)
``GET  /v1/route``         ``?src=&dst=``: distance bound + greedy path
``GET  /v1/adjacency``     live nodes + weighted edge list
``GET  /v1/overlay``       the served Overlay's JSON + global id mapping
``POST /v1/events``        Trace-format events: ``{"events": [...]}``
``POST /v1/reoptimize``    trigger an async re-optimization cycle
``POST /v1/snapshot``      force an atomic-commit snapshot
``POST /v1/shutdown``      graceful stop (final snapshot, then exit)
=========================  ==================================================

Every request lands in the ``repro_http_requests_total{method,endpoint,
status}`` counter and the ``repro_http_request_seconds{endpoint}``
histogram, and is logged (DEBUG) through the structured
``repro_torch.obs`` logger — ``BaseHTTPRequestHandler``'s raw-stderr
``log_message`` is routed there too, so ``REPRO_LOG_LEVEL`` controls all
of it.

Any other ``/vN/`` prefix answers 404 with the supported versions — clients
from the future fail loudly at the handshake, mirroring what
``repro_torch.serde`` does for payloads.

Run the daemon (prints ``SERVING host=... port=...`` when ready)::

    PYTHONPATH=src python -m repro_torch.service --n0 64 --dist bitnode \
        --policy dgro --port 0 --snapshot-dir /tmp/dgro-snaps

``--device`` (default ``cuda``) places the engine's distance state; with
no CUDA device and no ``--device cpu`` the daemon exits with the device
error before it binds a port.

The server is a stdlib ``ThreadingHTTPServer``: handler threads share the
one ``ServiceState`` lock, the re-optimizer runs beside them, and queries
keep being answered from the bounded-staleness distance matrix while a
re-optimization or snapshot is in flight.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from repro_torch import serde
from repro_torch.device import resolve_device
from repro_torch.dynamics.scenarios import Event, Trace
from repro_torch.obs import (REGISTRY, configure as configure_logging,
                             get_logger, kv)
from repro_torch.obs.metrics import LATENCY_BUCKETS_S

from .reoptimizer import Reoptimizer
from .state import ServiceState

__all__ = ["ServiceServer", "main"]

API_VERSIONS = ("v1",)

_log = get_logger(__name__)

# endpoint label values are drawn from this closed set (unknown paths fold
# into "_unknown") so a scanner can't blow up the metric cardinality
_ENDPOINTS = frozenset({
    "health", "stats", "metrics", "diameter", "route", "adjacency",
    "overlay", "events", "reoptimize", "snapshot", "shutdown"})

_HTTP_REQS = REGISTRY.counter(
    "repro_http_requests_total",
    "HTTP requests served, by method / endpoint / status code",
    labels=("method", "endpoint", "status"))
_HTTP_LAT = REGISTRY.histogram(
    "repro_http_request_seconds",
    "request handling wall time, by endpoint",
    labels=("endpoint",), buckets=LATENCY_BUCKETS_S)


class _Handler(BaseHTTPRequestHandler):
    """Routes /v1/* onto the shared ServiceState / Reoptimizer."""

    server_version = "repro-service/1"
    protocol_version = "HTTP/1.1"

    # set by ServiceServer
    state: ServiceState
    reopt: Optional[Reoptimizer]
    shutdown_event: threading.Event

    # per-request instrumentation scratch
    _status: int = 0
    _endpoint: str = "_unknown"

    def log_message(self, fmt, *args):
        """http.server's raw-stderr path, routed into the structured
        logger (DEBUG — per-request records; errors go via log_error)."""
        _log.debug(kv("http.server", client=self.address_string(),
                      msg=fmt % args))

    def log_error(self, fmt, *args):
        _log.warning(kv("http.server_error", client=self.address_string(),
                        msg=fmt % args))

    # -- plumbing ---------------------------------------------------------

    def _reply(self, code: int, payload: Dict) -> None:
        self._reply_bytes(code, serde.dumps(payload).encode(),
                          "application/json")

    def _reply_text(self, code: int, text: str,
                    content_type: str = "text/plain; version=0.0.4; "
                                        "charset=utf-8") -> None:
        self._reply_bytes(code, text.encode(), content_type)

    def _reply_bytes(self, code: int, body: bytes,
                     content_type: str) -> None:
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._reply(code, {"error": message})

    def _route_version(self) -> Optional[str]:
        """Returns the path below /v1, or None after answering an error."""
        path = urlparse(self.path).path.rstrip("/")
        parts = [p for p in path.split("/") if p]
        if len(parts) > 1 and parts[1] in _ENDPOINTS:
            self._endpoint = parts[1]
        if not parts or not parts[0].startswith("v"):
            self._error(404, f"endpoints live under /{API_VERSIONS[0]}/")
            return None
        if parts[0] not in API_VERSIONS:
            self._error(404, f"unsupported API version {parts[0]!r}; "
                             f"supported: {list(API_VERSIONS)}")
            return None
        return "/".join(parts[1:])

    def _read_body(self) -> Optional[Dict]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n).decode() if n else "{}"
            return serde.loads(raw, what="request body")
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, f"bad request body: {e}")
            return None

    # -- instrumentation wrapper ------------------------------------------

    def _instrumented(self, method: str, handler) -> None:
        """Per-endpoint latency histogram + status-code counter around the
        actual dispatch; the endpoint label is resolved by _route_version
        and unknown paths fold into ``_unknown``."""
        self._status = 0
        self._endpoint = "_unknown"
        t0 = time.perf_counter()
        try:
            handler()
        finally:
            dt = time.perf_counter() - t0
            status = str(self._status or 500)
            _HTTP_LAT.labels(endpoint=self._endpoint).observe(dt)
            _HTTP_REQS.labels(method=method, endpoint=self._endpoint,
                              status=status).inc()
            _log.debug(kv("http.request", method=method, path=self.path,
                          status=status, ms=dt * 1e3))

    # -- GET --------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        self._instrumented("GET", self._do_get)

    def _do_get(self) -> None:
        sub = self._route_version()
        if sub is None:
            return
        q = parse_qs(urlparse(self.path).query)
        try:
            if sub == "health":
                self._reply(200, {"status": "ok",
                                  "api_versions": list(API_VERSIONS),
                                  "version": self.state.version})
            elif sub == "stats":
                self._reply(200, self.state.stats())
            elif sub == "metrics":
                if q.get("format", [""])[0] == "json":
                    # render_json is already serde-stamped — send verbatim
                    self._reply_text(200, REGISTRY.render_json(),
                                     content_type="application/json")
                else:
                    self._reply_text(200, REGISTRY.render_prometheus())
            elif sub == "diameter":
                exact = q.get("exact", ["0"])[0] in ("1", "true")
                self._reply(200, self.state.diameter(exact=exact))
            elif sub == "route":
                try:
                    src = int(q["src"][0])
                    dst = int(q["dst"][0])
                except (KeyError, ValueError):
                    return self._error(400, "route needs integer ?src=&dst=")
                self._reply(200, self.state.route(src, dst))
            elif sub == "adjacency":
                self._reply(200, self.state.adjacency())
            elif sub == "overlay":
                ov, live = self.state.overlay()
                self._reply(200, {"overlay": json.loads(ov.to_json()),
                                  "live": [int(u) for u in live],
                                  "version": self.state.version})
            else:
                self._error(404, f"unknown endpoint /v1/{sub}")
        except ValueError as e:
            self._error(400, str(e))

    # -- POST -------------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802
        self._instrumented("POST", self._do_post)

    def _do_post(self) -> None:
        sub = self._route_version()
        if sub is None:
            return
        body = self._read_body()
        if body is None:
            return
        try:
            if sub == "events":
                raw = body.get("events")
                if raw is None and "event" in body:
                    raw = [body["event"]]
                if not isinstance(raw, list):
                    return self._error(
                        400, 'POST /v1/events needs {"events": [...]} '
                             '(Trace-format event dicts)')
                try:
                    events = [Event.from_dict(e) for e in raw]
                except (TypeError, ValueError) as e:
                    return self._error(400, f"bad event: {e}")
                try:
                    res = self.state.ingest(events)
                except ValueError as e:
                    # out-of-order clock / capacity violations: conflict
                    return self._error(409, str(e))
                if self.reopt is not None:
                    self.reopt.notify()
                self._reply(200, res)
            elif sub == "reoptimize":
                if self.reopt is None:
                    return self._error(409, "re-optimizer disabled")
                self.reopt.trigger()
                self._reply(202, {"triggered": True,
                                  "in_flight": self.reopt.in_flight,
                                  "cycles": self.reopt.cycles})
            elif sub == "snapshot":
                path = self.state.write_snapshot(reason="api")
                if path is None:
                    return self._error(409, "no snapshot dir configured")
                self._reply(200, {"path": path,
                                  "seq": self.state.snapshot_seq})
            elif sub == "shutdown":
                self._reply(200, {"stopping": True})
                self.shutdown_event.set()
            else:
                self._error(404, f"unknown endpoint /v1/{sub}")
        except ValueError as e:
            self._error(400, str(e))


class ServiceServer:
    """Owns the HTTP server thread + state + re-optimizer lifecycle."""

    def __init__(self, state: ServiceState, *, host: str = "127.0.0.1",
                 port: int = 0, reopt_every: int = 32,
                 snapshot_every: int = 64, reopt_method: str = "adapt",
                 reopt_enabled: bool = True, reopt_eps: float = 0.3,
                 seed: int = 0):
        self.state = state
        self.shutdown_event = threading.Event()
        self.reopt = (Reoptimizer(state, every=reopt_every,
                                  method=reopt_method, seed=seed,
                                  snapshot_every=snapshot_every,
                                  eps=reopt_eps)
                      if reopt_enabled else None)
        handler = type("BoundHandler", (_Handler,), {
            "state": state, "reopt": self.reopt,
            "shutdown_event": self.shutdown_event})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServiceServer":
        if self.reopt is not None:
            self.reopt.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="repro-service-http")
        self._thread.start()
        _log.info(kv("server.start", host=self.host, port=self.port,
                     reopt=self.reopt is not None))
        return self

    def stop(self, final_snapshot: bool = True) -> None:
        if self.reopt is not None:
            self.reopt.stop()
        if final_snapshot:
            self.state.write_snapshot(reason="shutdown")
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
        _log.info(kv("server.stop", final_snapshot=final_snapshot))

    def serve_until_shutdown(self) -> None:
        """Block until POST /v1/shutdown (the __main__ daemon loop)."""
        self.start()
        print(f"SERVING host={self.host} port={self.port}", flush=True)
        try:
            self.shutdown_event.wait()
        except KeyboardInterrupt:
            pass
        self.stop()
        print("STOPPED", flush=True)


def main(argv=None) -> None:
    # the daemon defaults to info-level structured logs on stderr; the
    # SERVING/STOPPED stdout lines below stay — they are the boot protocol
    # the smoke tools parse
    configure_logging(default="info")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks an ephemeral port (printed on SERVING)")
    ap.add_argument("--n0", type=int, default=64)
    ap.add_argument("--capacity", type=int, default=None,
                    help="slot capacity (default 2*n0)")
    ap.add_argument("--dist", default="bitnode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="dgro")
    ap.add_argument("--k-rings", type=int, default=None)
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--reopt-every", type=int, default=32)
    ap.add_argument("--snapshot-every", type=int, default=64)
    ap.add_argument("--reopt-method", default="adapt",
                    choices=("adapt", "dqn"))
    ap.add_argument("--reopt-eps", type=float, default=0.3,
                    help="adapt's keep-band half-width (larger = swap more)")
    ap.add_argument("--no-reopt", action="store_true")
    ap.add_argument("--no-detect-failures", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the distance state lives (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    world = Trace(n0=args.n0, capacity=args.capacity or 2 * args.n0,
                  dist=args.dist, seed=args.seed, events=[], name="service")
    state = ServiceState.open(
        world, snapshot_dir=args.snapshot_dir, policy=args.policy,
        k_rings=args.k_rings, detect_failures=not args.no_detect_failures,
        seed=args.seed, device=device)
    server = ServiceServer(state, host=args.host, port=args.port,
                           reopt_every=args.reopt_every,
                           snapshot_every=args.snapshot_every,
                           reopt_method=args.reopt_method,
                           reopt_eps=args.reopt_eps,
                           reopt_enabled=not args.no_reopt, seed=args.seed)
    server.serve_until_shutdown()


if __name__ == "__main__":
    main()
