"""repro_torch.obs — stdlib-only observability: metrics, tracing, logging.

A copy of ``repro.obs`` (the port imports nothing of ``repro``, not even
this stdlib-only package): the same instruments, names, help strings,
label sets and bucket edges, so a scrape of either package lists the same
series and the same observations render byte-identically.

  metrics   — process-global thread-safe registry of counters / gauges /
              fixed-bucket histograms (p50/p90/p99 from bucket counts,
              label support, Prometheus text + serde-stamped JSON export)
  tracing   — nestable ``span()`` wall-time timers, the first-call-aware
              ``jit_span()`` (first call per key vs steady state; on the
              card the first call holds the ``nvcc`` build) and
              ``TimedRLock`` (lock-wait histograms)
  logsetup  — structured one-line ``key=value`` stdlib logging under the
              ``repro_torch`` logger, ``REPRO_LOG_LEVEL``-controlled

Consumers: ``repro_torch.dynamics`` (event counters, incremental-vs-
rebuild maintenance timing) and the core entry points
(``batcheval.diameters``, ``rollout.rollout_episodes``).
"""
from .logsetup import configure, get_logger, kv  # noqa: F401
from .metrics import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, parse_prometheus)
from .tracing import (TimedRLock, current_span, jit_phase,  # noqa: F401
                      jit_span, reset_jit_state, span)

# Pre-registered hierarchical-overlay defaults, as in the reference: present
# (at zero) in every scrape before a hierarchical overlay exists, so a
# scrape of either package lists the same series.
HIER_CLUSTERS = REGISTRY.gauge(
    "repro_hier_clusters",
    "cluster count of the currently served hierarchical overlay")
HIER_HEADRING_DIAMETER = REGISTRY.gauge(
    "repro_hier_headring_diameter",
    "diameter (ms) of the hierarchical overlay's head ring")
HIER_ROUTE_HOPS = REGISTRY.histogram(
    "repro_hier_route_hops",
    "per-level hop count of delivered hierarchical routes",
    labels=("level",),
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128))

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "parse_prometheus", "span", "current_span", "jit_span", "jit_phase",
    "reset_jit_state", "TimedRLock", "configure", "get_logger", "kv",
    "HIER_CLUSTERS", "HIER_HEADRING_DIAMETER", "HIER_ROUTE_HOPS",
]
