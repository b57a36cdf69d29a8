"""Process-global metrics: counters, gauges, fixed-bucket histograms.

A copy of ``repro.obs.metrics`` over ``repro_torch.serde`` (the port
imports nothing of ``repro``).  Metric names, help strings, label names and
bucket edges are the reference's, so the same observations render
byte-identically in both packages (``tests/test_torch_obs.py``).

Stdlib-only instrumentation shared by the port's runtime layers — the
churn engine and the core entry points (``batcheval.diameters``,
``rollout.rollout_episodes``) all record into the same instruments.

Design:

* one process-global :data:`REGISTRY` (a :class:`MetricsRegistry`); unit
  tests and A/B benchmarks construct private registries instead;
* registration is **idempotent for identical specs** (module reloads in
  tests re-register safely) and **raises for conflicting specs** — the same
  name with a different type, help, label set, or bucket layout is a
  programming error surfaced at registration time, not at scrape time;
* instruments are thread-safe (one lock per instrument; N threads
  incrementing a counter sum exactly) and cheap when the registry is
  disabled (``set_enabled(False)`` turns every record into one boolean
  check — ``chip_smoke.py``'s churn phase reports the enabled path's
  cost against this);
* histograms use **fixed cumulative buckets**: p50/p90/p99 are estimated
  from bucket counts by linear interpolation, so the error is bounded by
  the width of the containing bucket (property-tested against numpy
  percentiles);
* exports: :meth:`MetricsRegistry.render_prometheus` (text exposition
  format) and
  :meth:`MetricsRegistry.render_json` (``repro_torch.serde``
  schema-stamped).

Naming follows Prometheus conventions: counters end in ``_total``,
timings are ``*_seconds`` histograms, gauges are instantaneous values.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import serde

__all__ = [
    "DEFAULT_BUCKETS",
    "LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "parse_prometheus",
]

# the Prometheus client default buckets (seconds): sub-ms to 10s
DEFAULT_BUCKETS: Tuple[float, ...] = (
    .005, .01, .025, .05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0)

# finer low end for loopback request / lock-wait latencies (seconds)
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    .0001, .00025, .0005, .001, .0025, .005, .01, .025, .05, .1,
    .25, .5, 1.0, 2.5, 5.0)

_RESERVED_LABELS = ("le",)


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Instrument:
    """Shared parent/child machinery for labelled instruments.

    An instrument with ``label_names`` is a *family*: ``labels(...)`` binds
    one value per label name and returns (creating on first use) the child
    holding the actual series.  Label-less instruments are their own child.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (), *,
                 registry: Optional["MetricsRegistry"] = None):
        for ln in label_names:
            if ln in _RESERVED_LABELS:
                raise ValueError(f"label name {ln!r} is reserved")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._registry = registry
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Instrument"] = {}
        if not self.label_names:
            self._children[()] = self

    @property
    def spec(self) -> Tuple:
        return (self.kind, self.name, self.help, self.label_names,
                getattr(self, "buckets", None))

    @property
    def _enabled(self) -> bool:
        return self._registry is None or self._registry.enabled

    def labels(self, *values, **kv) -> "_Instrument":
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(kv[n] for n in self.label_names)
            except KeyError as e:
                raise ValueError(
                    f"{self.name} labels are {self.label_names}") from e
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} needs {len(self.label_names)} label values "
                f"{self.label_names}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
            return child

    def _make_child(self) -> "_Instrument":
        raise NotImplementedError

    def _series(self) -> List[Tuple[Tuple[str, ...], "_Instrument"]]:
        with self._lock:
            return sorted(self._children.items())

    def _label_str(self, values: Tuple[str, ...],
                   extra: str = "") -> str:
        parts = [f'{n}="{_escape(v)}"'
                 for n, v in zip(self.label_names, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> List[str]:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing count (events ingested, requests served)."""

    kind = "counter"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._value = 0.0

    def _make_child(self) -> "Counter":
        c = Counter(self.name, self.help, registry=self._registry)
        return c

    def inc(self, amount: float = 1.0) -> None:
        if not self._enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for values, child in self._series():
            lines.append(f"{self.name}{self._label_str(values)} "
                         f"{_fmt(child.value)}")
        return lines


class Gauge(_Instrument):
    """Instantaneous value; settable, or computed by a callback at scrape
    time (``set_function``) for values derived from live state."""

    kind = "gauge"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def _make_child(self) -> "Gauge":
        return Gauge(self.name, self.help, registry=self._registry)

    def set(self, value: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._value += amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Compute the value at scrape time (e.g. snapshot age, uptime).
        The callback runs OUTSIDE instrument/registry locks, so it may take
        its own locks (``ServiceState.lock``) without deadlock risk."""
        self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            return float(fn())
        with self._lock:
            return self._value

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for values, child in self._series():
            lines.append(f"{self.name}{self._label_str(values)} "
                         f"{_fmt(child.value)}")
        return lines


class Histogram(_Instrument):
    """Fixed-bucket histogram with quantile estimation from bucket counts.

    ``buckets`` are ascending upper bounds; an implicit +Inf bucket catches
    the overflow.  ``quantile(q)`` linearly interpolates inside the
    containing bucket, clamped to the observed min/max, so the estimate is
    never further from the true sample quantile than the containing
    bucket's width.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (), *,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 registry: Optional["MetricsRegistry"] = None):
        bkts = tuple(float(b) for b in buckets)
        if not bkts or list(bkts) != sorted(set(bkts)):
            raise ValueError(f"buckets must be ascending and unique: {bkts}")
        self.buckets = bkts
        super().__init__(name, help, label_names, registry=registry)
        self._counts = [0] * (len(bkts) + 1)
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, buckets=self.buckets,
                         registry=self._registry)

    def observe(self, value: float) -> None:
        if not self._enabled:
            return
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    # -- reads -------------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) from bucket counts; NaN when
        empty.  Within the containing bucket the mass is assumed uniform."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
            total = sum(counts)
            lo_obs, hi_obs = self._min, self._max
        if total == 0:
            return float("nan")
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if cum + c >= target and c > 0:
                lo = self.buckets[i - 1] if i > 0 else min(lo_obs, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else hi_obs
                lo = max(lo, lo_obs) if i == 0 else lo
                frac = (target - cum) / c
                est = lo + (hi - lo) * frac
                return float(min(max(est, lo_obs), hi_obs))
            cum += c
        return float(hi_obs)

    def summary(self) -> Dict[str, float]:
        """p50/p90/p99 + count/sum."""
        return {"count": self.count, "sum": self.sum,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for values, child in self._series():
            with child._lock:
                counts = list(child._counts)
                total = sum(counts)
                s = child._sum
            cum = 0
            for bound, c in zip(list(self.buckets) + [math.inf],
                                counts):
                cum += c
                le = self._label_str(values, f'le="{_fmt(bound)}"')
                lines.append(f"{self.name}_bucket{le} {cum}")
            lines.append(f"{self.name}_sum{self._label_str(values)} "
                         f"{repr(float(s))}")
            lines.append(f"{self.name}_count{self._label_str(values)} "
                         f"{total}")
        return lines


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe name -> instrument map with idempotent registration."""

    def __init__(self, enabled: bool = True):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}
        self.enabled = enabled

    def set_enabled(self, enabled: bool) -> None:
        """Globally arm/disarm every instrument in this registry (records
        become one-boolean-check no-ops).  The instrumented-overhead reading
        of ``chip_smoke.py`` measures exactly this toggle's cost."""
        self.enabled = bool(enabled)

    # -- registration ------------------------------------------------------

    def _register(self, kind: str, name: str, help: str,
                  label_names: Sequence[str],
                  buckets: Optional[Sequence[float]]) -> _Instrument:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                kw = {"buckets": tuple(float(b) for b in buckets)} \
                    if kind == "histogram" else {}
                want = (kind, name, help, tuple(label_names),
                        kw.get("buckets"))
                if existing.spec != want:
                    raise ValueError(
                        f"metric {name!r} already registered with spec "
                        f"{existing.spec}, conflicting re-registration "
                        f"{want}")
                return existing
            cls = _KINDS[kind]
            kw = {"buckets": buckets} if (kind == "histogram"
                                          and buckets is not None) else {}
            inst = cls(name, help, label_names, registry=self, **kw)
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register("counter", name, help, labels, None)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register("gauge", name, help, labels, None)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), *,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register("histogram", name, help, labels, buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        """Drop one instrument (tests re-registering with new specs)."""
        with self._lock:
            self._metrics.pop(name, None)

    # -- export ------------------------------------------------------------

    def _snapshot(self) -> List[_Instrument]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render_prometheus(self) -> str:
        """Text exposition format (the ``GET /v1/metrics`` body).  Renders
        from a snapshot of the instrument list, never under the registry
        lock, so scrapes proceed during registration and callbacks may
        take their own locks."""
        lines: List[str] = []
        for inst in self._snapshot():
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"

    def collect(self) -> Dict[str, Dict]:
        """Plain-dict view: {name: {kind, help, series: [{labels, ...}]}}."""
        out: Dict[str, Dict] = {}
        for inst in self._snapshot():
            series = []
            for values, child in inst._series():
                labels = dict(zip(inst.label_names, values))
                if inst.kind == "histogram":
                    series.append({"labels": labels, **child.summary()})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[inst.name] = {"kind": inst.kind, "help": inst.help,
                              "series": series}
        return out

    def render_json(self) -> str:
        """``repro_torch.serde`` schema-stamped JSON export of :meth:`collect`."""
        return serde.dumps({"kind": "metrics", "metrics": self.collect()})


#: the process-global default registry every layer records into
REGISTRY = MetricsRegistry()


def parse_prometheus(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Parse exposition text back to ``{series_name: {labels: value}}``.

    Labels are sorted ``(name, value)`` tuples (hashable keys).  Used by
    the tests and ``chip_smoke.py`` to assert that rendered metrics match
    ground truth.
    """
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            raw = rest.rstrip("}")
            labels = []
            for item in filter(None, _split_labels(raw)):
                k, _, v = item.partition("=")
                labels.append((k, v.strip('"').replace(r'\"', '"')
                               .replace(r"\n", "\n").replace(r"\\", "\\")))
            key = tuple(sorted(labels))
        else:
            name, key = name_part, ()
        value = math.inf if value_part == "+Inf" else float(value_part)
        out.setdefault(name, {})[key] = value
    return out


def _split_labels(raw: str) -> List[str]:
    """Split ``a="x",b="y,z"`` on commas outside quotes."""
    parts, buf, in_q, prev = [], [], False, ""
    for ch in raw:
        if ch == '"' and prev != "\\":
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
        prev = ch
    if buf:
        parts.append("".join(buf))
    return parts
