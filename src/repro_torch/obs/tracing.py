"""Span timers and first-call-aware timing over the global metrics registry.

A copy of ``repro.obs.tracing`` (the port imports nothing of ``repro``);
instrument names, help strings and buckets are the reference's.  Three
tools, all ``time.perf_counter``-based and thread-safe:

* :func:`span` — nestable wall-time spans recorded into the
  ``repro_span_seconds{span=...}`` histogram (plus a ``repro_spans_total``
  counter), with a thread-local stack so nested spans know their parent
  (``current_span()``).

* :func:`jit_span` — the first-call-aware variant for the port's entry
  points (``batcheval.diameters``, ``rollout.rollout_episodes``, the
  incremental relax/join/tombstone/rebuild updates).  It keys each timing
  by ``(name, key)`` — pass the shape/static-arg tuple as ``key`` — and
  routes the FIRST observation per key into
  ``repro_jit_compile_seconds{fn=...}`` and every later one into
  ``repro_jit_execute_seconds{fn=...}``, the reference's split.

* :class:`TimedRLock` — an RLock whose *acquisition wait* is observed into
  a histogram (re-entrant acquisitions are not recorded: the owner never
  waits).

Two decisions of the port:

* **What "compile" means here.**  Nothing is traced or jit-compiled, but
  the first call per ``(name, key)`` on the card still pays one-off costs:
  the lazy ``nvcc`` build of ``kernels/_build.py`` (~40 s, once per
  process), CUDA context and cuBLAS initialisation, and the caching
  allocator's first reservations at that shape.  That call lands in
  ``repro_jit_compile_seconds`` and the rest in
  ``repro_jit_execute_seconds``, under the same split as the reference,
  so a scrape of either package reads the same way.

* **Spans never add a host sync.**  CUDA work is asynchronous, so a span
  around a call that only launches kernels times the launches, exactly as
  the reference's span around an asynchronous JAX dispatch does; a span
  that should time device work must end on a call that waits for it.
  The span itself never synchronises: the deep-Q step loop's "no host
  sync in the step loop" rule holds with spans on.  Where the reference's
  span ends on a host copy (``batcheval._stream``), the port's ends after
  its ``.cpu()``, which is a real sync.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from .metrics import LATENCY_BUCKETS_S, REGISTRY, Histogram, MetricsRegistry

__all__ = ["span", "current_span", "jit_span", "jit_phase",
           "reset_jit_state", "TimedRLock"]

_local = threading.local()

# spans can be long (an exact-diameter refresh, a DQN reopt): stretch the
# default bucket range upward
SPAN_BUCKETS_S: Tuple[float, ...] = (
    .0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _span_instruments(registry: MetricsRegistry):
    return (registry.histogram(
                "repro_span_seconds", "wall time per named span",
                labels=("span",), buckets=SPAN_BUCKETS_S),
            registry.counter(
                "repro_spans_total", "completed spans", labels=("span",)))


# instruments on the default registry are resolved ONCE at import — span()
# and jit_span() sit on ingest/relax hot paths, and re-resolving through the
# registry lock per call is measurable (the instrumented overhead)
_DEFAULT_SPAN = _span_instruments(REGISTRY)


def _jit_instruments(registry: MetricsRegistry):
    return (registry.histogram(
                "repro_jit_compile_seconds",
                "first-call (traced+compiled) time per jit entry point",
                labels=("fn",), buckets=SPAN_BUCKETS_S),
            registry.histogram(
                "repro_jit_execute_seconds",
                "steady-state execute time per jit entry point",
                labels=("fn",), buckets=SPAN_BUCKETS_S))


_DEFAULT_JIT = _jit_instruments(REGISTRY)


def _stack() -> list:
    st = getattr(_local, "spans", None)
    if st is None:
        st = _local.spans = []
    return st


def current_span() -> Optional[str]:
    """Name of the innermost active span on this thread, or None."""
    st = _stack()
    return st[-1] if st else None


# labelled-child handles resolved once per span/fn name on the default
# registry — plain dict reads, no locks, on the hot path (racy writes are
# harmless: labels() dedupes children under the instrument lock)
_span_children: dict = {}
_jit_children: dict = {}


class span:
    """``with span("reopt.capture"): ...`` — record the block's wall time.

    Nesting is explicit: each span records its own duration under its own
    name (inclusive of children), and ``current_span()`` exposes the
    innermost name while inside the block.  A class-based context manager
    (not ``@contextmanager``): span sits on ingest/relax hot paths and the
    generator protocol alone costs more than the two clock reads.
    """

    __slots__ = ("_name", "_registry", "_hist", "_ctr", "_t0", "_on")

    def __init__(self, name: str, *, registry: MetricsRegistry = REGISTRY):
        self._name = name
        self._registry = registry

    def __enter__(self) -> "span":
        reg = self._registry
        if not reg.enabled:          # disabled: no clock reads, no lookups
            self._on = False
            return self
        self._on = True
        if reg is REGISTRY:
            pair = _span_children.get(self._name)
            if pair is None:
                hist, ctr = _DEFAULT_SPAN
                pair = (hist.labels(span=self._name),
                        ctr.labels(span=self._name))
                _span_children[self._name] = pair
        else:
            hist, ctr = _span_instruments(reg)
            pair = (hist.labels(span=self._name), ctr.labels(span=self._name))
        self._hist, self._ctr = pair
        _stack().append(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._on:
            dt = time.perf_counter() - self._t0
            _stack().pop()
            self._hist.observe(dt)
            self._ctr.inc()
        return False


# ---------------------------------------------------------------------------
# JIT-aware timing
# ---------------------------------------------------------------------------

_jit_lock = threading.Lock()
_jit_seen: set = set()


def reset_jit_state() -> None:
    """Forget which (name, key) combinations have been seen (tests)."""
    with _jit_lock:
        _jit_seen.clear()


def _is_first(name: str, key) -> bool:
    k = (name, key)
    if k in _jit_seen:               # lock-free steady state (atomic read)
        return False
    with _jit_lock:
        if k in _jit_seen:
            return False
        _jit_seen.add(k)
        return True


def jit_phase(name: str, key=None) -> str:
    """Compile/execute split for callers that time a call themselves.

    Returns ``"compile"`` on the first call per (name, key) and
    ``"execute"`` after — the same split ``jit_span`` applies, exposed as
    a label value for code that observes its own histogram (e.g. the
    ``repro_apsp_seconds{method, phase}`` engine timings in
    ``core.batcheval``).  Shares ``reset_jit_state()`` with ``jit_span``.
    """
    return "compile" if _is_first(name, key) else "execute"


class jit_span:
    """Time a call, separating the first call per key from steady state.

    ``key`` should capture whatever triggers retracing (shapes, static
    args); the first observation per (name, key) lands in
    ``repro_jit_compile_seconds``, the rest in
    ``repro_jit_execute_seconds``.
    """

    __slots__ = ("_name", "_key", "_registry", "_hist", "_t0", "_on")

    def __init__(self, name: str, key=None, *,
                 registry: MetricsRegistry = REGISTRY):
        self._name = name
        self._key = key
        self._registry = registry

    def __enter__(self) -> "jit_span":
        reg = self._registry
        if not reg.enabled:          # disabled: don't even consume "first"
            self._on = False
            return self
        self._on = True
        first = _is_first(self._name, self._key)
        if reg is REGISTRY:
            ck = (first, self._name)
            h = _jit_children.get(ck)
            if h is None:
                h = _DEFAULT_JIT[0 if first else 1].labels(fn=self._name)
                _jit_children[ck] = h
        else:
            compile_h, execute_h = _jit_instruments(reg)
            h = (compile_h if first else execute_h).labels(fn=self._name)
        self._hist = h
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._on:
            self._hist.observe(time.perf_counter() - self._t0)
        return False


# ---------------------------------------------------------------------------
# lock-wait measurement
# ---------------------------------------------------------------------------

class TimedRLock:
    """Drop-in re-entrant lock recording acquisition *wait* time.

    Only top-level acquisitions are observed — a re-entrant acquire by the
    owning thread never blocks, and recording it would drown the histogram
    in zeros.  API-compatible with ``threading.RLock`` for ``with``-block
    and ``acquire``/``release`` use.
    """

    def __init__(self, histogram: Optional[Histogram] = None, *,
                 registry: MetricsRegistry = REGISTRY,
                 name: str = "repro_lock_wait_seconds",
                 help: str = "time spent waiting to acquire a shared lock"):
        self._lock = threading.RLock()
        self._hist = histogram if histogram is not None else \
            registry.histogram(name, help, buckets=LATENCY_BUCKETS_S)
        self._owner: Optional[int] = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:                  # re-entrant: no wait
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                self._depth += 1
            return ok
        t0 = time.perf_counter()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._hist.observe(time.perf_counter() - t0)
            self._owner = me
            self._depth = 1
        return ok

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError("cannot release un-acquired TimedRLock")
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
        self._lock.release()

    def __enter__(self) -> "TimedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
