"""Tiny stdlib client for the /v1 control-plane API (a copy of
``repro.service.client`` over the port's serde and obs).

Used by ``tools/torch_service_smoke.py`` and ``chip_smoke.py`` — and small
enough to crib for real integrations: every call is one HTTP round-trip,
every payload is ``repro_torch.serde`` schema-checked on the way in.

    from repro_torch.service.client import ServiceClient
    c = ServiceClient("http://127.0.0.1:8371")
    c.wait_ready()
    c.post_events(trace.events[:10])
    c.route(0, 5)["distance"]
    c.diameter()["diameter"]
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch import serde
from repro_torch.dynamics.scenarios import Event, Trace

__all__ = ["ServiceClient", "ServiceError"]


class ServiceError(RuntimeError):
    """Non-2xx response; carries the HTTP status and the server's message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class ServiceClient:
    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- plumbing ---------------------------------------------------------

    def _request(self, method: str, path: str,
                 params: Optional[Dict] = None,
                 payload: Optional[Dict] = None) -> Dict:
        url = f"{self.base_url}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = serde.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"} if data else {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return serde.loads(resp.read().decode(),
                                   what=f"{method} {path} response")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read().decode()).get("error", str(e))
            except Exception:  # noqa: BLE001 - error body is best-effort
                msg = str(e)
            raise ServiceError(e.code, msg) from None

    def _get(self, path: str, **params) -> Dict:
        return self._request("GET", path, params=params or None)

    def _post(self, path: str, payload: Optional[Dict] = None) -> Dict:
        return self._request("POST", path, payload=payload or {})

    # -- queries ----------------------------------------------------------

    def health(self) -> Dict:
        return self._get("/v1/health")

    def stats(self) -> Dict:
        return self._get("/v1/stats")

    def metrics_text(self) -> str:
        """Raw Prometheus text from ``GET /v1/metrics`` (not JSON — parse
        with :func:`repro_torch.obs.parse_prometheus`)."""
        url = f"{self.base_url}/v1/metrics"
        req = urllib.request.Request(url, method="GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read().decode()
        except urllib.error.HTTPError as e:
            raise ServiceError(e.code, e.read().decode()[:200]) from None

    def metrics(self) -> Dict:
        """Parsed scrape: ``{series: {labels-tuple: value}}``."""
        from repro_torch.obs import parse_prometheus
        return parse_prometheus(self.metrics_text())

    def diameter(self, exact: bool = False) -> Dict:
        return self._get("/v1/diameter", **({"exact": 1} if exact else {}))

    def route(self, src: int, dst: int) -> Dict:
        return self._get("/v1/route", src=src, dst=dst)

    def adjacency(self) -> Dict:
        return self._get("/v1/adjacency")

    def overlay(self) -> Dict:
        return self._get("/v1/overlay")

    # -- ingest / control -------------------------------------------------

    def post_events(self, events: Sequence[Event]) -> Dict:
        return self._post("/v1/events",
                          {"events": [e.to_dict() for e in events]})

    def stream_trace(self, trace: Trace, chunk: int = 8) -> List[Dict]:
        """Stream a whole trace through /v1/events in time-ordered chunks."""
        events = sorted(trace.events, key=lambda e: e.time)
        return [self.post_events(events[i:i + chunk])
                for i in range(0, len(events), chunk)]

    def reoptimize(self) -> Dict:
        return self._post("/v1/reoptimize")

    def snapshot(self) -> Dict:
        return self._post("/v1/snapshot")

    def shutdown(self) -> Dict:
        return self._post("/v1/shutdown")

    # -- helpers ----------------------------------------------------------

    def wait_ready(self, timeout: float = 30.0, poll: float = 0.1) -> Dict:
        """Poll /v1/health until the daemon answers (boot barrier).

        Deadlines run on the monotonic clock: a wall-clock step (NTP slew,
        suspend/resume) can neither fire the timeout early nor stall it.
        """
        deadline = time.monotonic() + timeout
        last: Exception = RuntimeError("unreachable")
        while time.monotonic() < deadline:
            try:
                return self.health()
            except (ServiceError, urllib.error.URLError, OSError) as e:
                last = e
                time.sleep(poll)
        raise TimeoutError(
            f"service at {self.base_url} not ready after {timeout}s: {last}")

    def wait_version(self, at_least: int, timeout: float = 60.0,
                     poll: float = 0.05) -> Dict:
        """Block until a re-optimization swap lands (version >= at_least)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.stats()
            if st["version"] >= at_least:
                return st
            time.sleep(poll)
        raise TimeoutError(f"version never reached {at_least} in {timeout}s")
