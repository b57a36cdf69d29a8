"""Background re-optimization worker: adapt off the hot path, swap atomically
(torch port of ``repro.service.reoptimizer``).

The worker wakes when enough events have accumulated (``every``) or when
explicitly triggered (``POST /v1/reoptimize``), then runs one cycle:

1. **capture** — freeze a copy of the live fleet (``ServiceState.capture``,
   the second overlay buffer);
2. **optimize** — run DGRO ring selection (``core.selection.adapt``) or a
   DQN ring reconstruction on the frozen copy, entirely OUTSIDE the state
   lock, on the state's device (the worker thread enters
   ``batcheval.eval_options(device=state.device)``: the options of the
   thread that made the state do not reach it): ingest and queries
   proceed at full speed while this runs;
3. **swap** — ``ServiceState.commit_reopt`` lands the new ring's edges as
   incremental relaxations between still-live nodes and bumps the version,
   all under one short lock acquisition;
4. **snapshot** — atomic-commit the post-swap state for crash recovery.

A crash between (3) and (4) is the classic torn-state window; the
atomic-commit snapshot protocol makes it safe (restart restores the LAST
committed snapshot — the pre-swap overlay — and simply re-optimizes again).
That window is crash-injectable for tests: set
``REPRO_SERVICE_CRASH_AFTER_SWAP=1`` (hard ``os._exit``) or pass a
``crash_hook`` callable.
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Callable, Optional

import numpy as np

from repro_torch.core import batcheval, selection
from repro_torch.obs import REGISTRY, get_logger, kv, span

from .state import ServiceState

__all__ = ["Reoptimizer"]

_CRASH_ENV = "REPRO_SERVICE_CRASH_AFTER_SWAP"

_log = get_logger(__name__)

# cycle outcomes: swapped (new overlay landed), kept (adapt said keep),
# skipped (fleet too small), error (cycle raised; daemon survives)
_CYCLES = REGISTRY.counter(
    "repro_reopt_cycles_total", "re-optimization cycles, by outcome",
    labels=("outcome",))


class Reoptimizer:
    """Owns the background thread; one optimization cycle in flight at most."""

    def __init__(self, state: ServiceState, *, every: int = 32,
                 method: str = "adapt", seed: int = 0,
                 snapshot_every: int = 64, eps: float = 0.3,
                 eval_opts: Optional[dict] = None,
                 crash_hook: Optional[Callable[[], None]] = None):
        if method not in ("adapt", "dqn"):
            raise ValueError(f"unknown reopt method {method!r}; "
                             f"options ('adapt', 'dqn')")
        self.state = state
        self.every = every
        self.method = method
        self.eps = eps                  # adapt's "keep" band half-width
        # scoped batcheval knobs for candidate SCORING only (dtype/method/
        # chunk...); reduced precision is safe here because the commit path
        # re-lands the chosen ring as exact incremental relaxations — a
        # mis-ranked candidate costs quality, never correctness
        self.eval_opts = dict(eval_opts or {})
        self.snapshot_every = snapshot_every
        self.crash_hook = crash_hook
        self._rng = np.random.default_rng(seed)
        self._cond = threading.Condition()
        self._stop = False
        self._forced = 0
        self._thread: Optional[threading.Thread] = None
        self.in_flight = False          # an optimize+swap cycle is running
        self.cycles = 0
        self.last_error: Optional[str] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Reoptimizer":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-reoptimizer")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def notify(self) -> None:
        """Called by the server after each ingest batch."""
        with self._cond:
            self._cond.notify_all()

    def trigger(self) -> None:
        """Force a cycle regardless of the event cadence."""
        with self._cond:
            self._forced += 1
            self._cond.notify_all()

    # -- the loop ---------------------------------------------------------

    def _due(self) -> bool:
        return (self._forced > 0
                or self.state.events_since_reopt >= self.every
                or self.state.events_since_snapshot >= self.snapshot_every)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not self._due():
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    return
                forced = self._forced > 0
                if forced:
                    self._forced -= 1
            try:
                if forced or self.state.events_since_reopt >= self.every:
                    self.step(force=forced)
                elif self.state.events_since_snapshot >= self.snapshot_every:
                    self.state.write_snapshot(reason="cadence")
            except Exception:  # noqa: BLE001 - a failed cycle must not kill the daemon
                self.last_error = traceback.format_exc()
                _CYCLES.labels(outcome="error").inc()
                _log.exception(kv("reopt.cycle_failed", method=self.method))

    # -- one cycle --------------------------------------------------------

    def step(self, force: bool = False) -> Optional[dict]:
        """One capture → optimize → swap → snapshot cycle (synchronous).

        Exposed for tests and the benchmark; the daemon thread calls it too.
        Returns the commit result, or None when nothing was swapped (too few
        live nodes, or adapt said "keep").
        """
        self.in_flight = True
        try:
            with span("reopt.capture"):
                job = self.state.capture()
            if len(job.live) < 4:
                _CYCLES.labels(outcome="skipped").inc()
                return None
            seed = int(self._rng.integers(2**31))
            with span("reopt.optimize"):
                new_ov = self._optimize(job, seed)
            if new_ov is None:
                with self.state.lock:
                    self.state.reopts_kept += 1
                    self.state.events_since_reopt = 0
                _CYCLES.labels(outcome="kept").inc()
                _log.info(kv("reopt.cycle", outcome="kept",
                             method=self.method, n_live=len(job.live)))
                return None
            with span("reopt.commit"):
                res = self.state.commit_reopt(job, new_ov)
            self.cycles += 1
            _CYCLES.labels(outcome="swapped").inc()
            _log.info(kv("reopt.cycle", outcome="swapped",
                         method=self.method, n_live=len(job.live),
                         version=res["version"],
                         edges_added=res["edges_added"]))
            self._maybe_crash()          # the torn-state window under test
            self.state.write_snapshot(reason="reopt")
            return res
        finally:
            self.in_flight = False

    def _optimize(self, job, seed: int):
        """Compute the candidate overlay on the frozen copy (no locks), on
        the state's device."""
        with batcheval.eval_options(**{**self.eval_opts,
                                       "device": self.state.device}):
            return self._optimize_inner(job, seed)

    def _optimize_inner(self, job, seed: int):
        if self.method == "adapt":
            new_ov, kind, _rho = selection.adapt(job.overlay, eps=self.eps,
                                                 seed=seed)
            return None if kind == "keep" else new_ov
        # "dqn": reconstruct a fresh DGRO-DQN ring set over the frozen
        # latency block and graft it (additively) onto the live overlay
        from repro_torch import overlay as overlay_api
        built = overlay_api.build(
            "dgro-dqn", job.overlay.w,
            overlay_api.DGRODQNConfig(epochs=4, n_starts=2), seed=seed)
        merged = job.overlay
        for ring in built.rings:
            merged = merged.add_ring(ring)
        return merged

    def _maybe_crash(self) -> None:
        if self.crash_hook is not None:
            self.crash_hook()
        if os.environ.get(_CRASH_ENV) == "1":
            os._exit(17)        # simulate a hard crash mid-window
