"""Churn scenario library + replayable trace format.

A copy of ``repro.dynamics.scenarios`` over the port's ``serde`` and
``core.topology``: the same generators give the same events, and
``Trace.to_json`` is byte-identical to the reference's.

A :class:`Trace` is plain data — timestamped events over capacity-slot node
ids plus the latency-distribution spec — so a benchmark run is exactly
reproducible from its JSON serialization, and the SAME trace can drive every
overlay policy (traces name *who* joins/leaves/fails, policies decide *how*
the overlay reacts).

Scenarios (all deterministic in ``seed``):

* ``poisson_churn``     — memoryless background join/leave churn;
* ``flash_crowd``       — a burst of joins inside a short window (fleet
                          onboarding, auto-scaling step);
* ``regional_failure``  — every node of one FABRIC site fails at once
                          (correlated regional outage; sites follow the
                          round-robin assignment of
                          ``topology.fabric_latency``);
* ``diurnal_drift``     — sinusoidal global latency scaling (daily WAN
                          congestion cycle);
* ``straggler_storm``   — a handful of nodes degrade sharply (tail-latency
                          incidents a la Dean & Barroso).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

from repro_torch import serde
from repro_torch.core.topology import N_FABRIC_SITES, make_latency

__all__ = ["Event", "Trace", "poisson_churn", "flash_crowd",
           "regional_failure", "diurnal_drift", "straggler_storm",
           "merge_traces", "churn_with_drift", "cluster_split_merge",
           "SCENARIOS"]

#: the five node-level kinds every engine handles, plus the two
#: cluster-level kinds only hierarchical engines accept (the flat
#: ``ChurnEngine`` raises a descriptive error on them)
EVENT_KINDS = ("join", "leave", "fail", "latency_drift", "straggler",
               "cluster_split", "cluster_merge")

_NODE_KINDS = EVENT_KINDS[:5]


@dataclasses.dataclass(frozen=True)
class Event:
    """One timestamped churn event (times in ms, node ids are slot indices).

    ``factor`` scales latencies for drift/straggler events; ``region``
    restricts a drift to one FABRIC site (-1 = global).  For the
    cluster-level kinds ``node`` holds the CLUSTER id (``cluster_split``
    splits it in two; ``cluster_merge`` absorbs cluster ``peer`` into it).
    ``peer`` is only serialized for cluster events, so node-level trace
    JSON is byte-identical to the pre-hierarchy format.
    """
    time: float
    kind: str
    node: int = -1
    factor: float = 1.0
    region: int = -1
    peer: int = -1

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {self.kind!r}; options {EVENT_KINDS}")
        if self.kind != "latency_drift" and self.node < 0:
            raise ValueError(
                f"{self.kind} event needs a node id >= 0, got {self.node} "
                f"(negative ids would silently index from the end)")
        if self.region != -1 and not 0 <= self.region < N_FABRIC_SITES:
            raise ValueError(
                f"region must be -1 (global) or a FABRIC site in "
                f"[0, {N_FABRIC_SITES}), got {self.region}")
        if self.kind == "cluster_merge":
            if self.peer < 0 or self.peer == self.node:
                raise ValueError(
                    f"cluster_merge needs a peer cluster id >= 0 distinct "
                    f"from node, got node={self.node} peer={self.peer}")
        elif self.peer != -1:
            raise ValueError(
                f"peer is only meaningful for cluster_merge events, got "
                f"peer={self.peer} on a {self.kind!r} event")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.kind in _NODE_KINDS:
            d.pop("peer")       # node-level JSON stays byte-identical
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(**d)


@dataclasses.dataclass
class Trace:
    """A replayable churn trace: initial fleet + capacity + event stream."""
    n0: int                 # initially-live nodes: slots [0, n0)
    capacity: int           # total slots (joins activate n0, n0+1, ...)
    dist: str               # latency distribution name (core.topology)
    seed: int               # latency-matrix seed
    events: List[Event]
    name: str = "trace"

    def __post_init__(self):
        bad = [e for e in self.events if e.node >= self.capacity]
        if bad:
            raise ValueError(
                f"events reference slots >= capacity {self.capacity}: "
                f"{bad[:3]}")

    def latency(self) -> np.ndarray:
        """The (capacity, capacity) base latency matrix this trace runs on."""
        return make_latency(self.dist, self.capacity, seed=self.seed)

    def to_json(self) -> str:
        return serde.dumps({
            "name": self.name, "n0": self.n0, "capacity": self.capacity,
            "dist": self.dist, "seed": self.seed,
            "events": [e.to_dict() for e in self.events],
        }, indent=None)

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        d = serde.loads(s, what="Trace JSON")
        return cls(n0=d["n0"], capacity=d["capacity"], dist=d["dist"],
                   seed=d["seed"], name=d.get("name", "trace"),
                   events=[Event.from_dict(e) for e in d["events"]])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def poisson_churn(n0: int = 40, dist: str = "bitnode", seed: int = 0, *,
                  horizon: float = 30_000.0, join_rate: float = 0.4e-3,
                  leave_rate: float = 0.4e-3, min_live: int = 8) -> Trace:
    """Memoryless background churn: joins/leaves as independent Poisson
    processes (rates in events/ms)."""
    rng = np.random.default_rng(seed + 1)
    live = list(range(n0))
    next_id = n0
    t = 0.0
    events: List[Event] = []
    total = join_rate + leave_rate
    while True:
        t += float(rng.exponential(1.0 / total))
        if t >= horizon:
            break
        if rng.random() < join_rate / total:
            events.append(Event(time=t, kind="join", node=next_id))
            live.append(next_id)
            next_id += 1
        elif len(live) > min_live:
            u = live.pop(int(rng.integers(len(live))))
            events.append(Event(time=t, kind="leave", node=u))
    return Trace(n0=n0, capacity=next_id, dist=dist, seed=seed,
                 events=events, name="poisson_churn")


def flash_crowd(n0: int = 32, dist: str = "bitnode", seed: int = 0, *,
                burst: int = 24, t0: float = 5_000.0,
                window: float = 2_000.0) -> Trace:
    """A join burst: ``burst`` nodes arrive within ``window`` ms of ``t0``."""
    rng = np.random.default_rng(seed + 1)
    times = np.sort(rng.uniform(t0, t0 + window, size=burst))
    events = [Event(time=float(t), kind="join", node=n0 + i)
              for i, t in enumerate(times)]
    return Trace(n0=n0, capacity=n0 + burst, dist=dist, seed=seed,
                 events=events, name="flash_crowd")


def regional_failure(n0: int = 51, dist: str = "fabric", seed: int = 0, *,
                     site: int = 0, t_fail: float = 5_000.0,
                     jitter: float = 50.0) -> Trace:
    """Correlated outage: every live node at one FABRIC site crashes at
    ~``t_fail`` (small per-node jitter models the power/link cascade)."""
    rng = np.random.default_rng(seed + 1)
    victims = [u for u in range(n0) if u % N_FABRIC_SITES == site]
    assert len(victims) < n0, "regional failure would kill the whole fleet"
    events = [Event(time=float(t_fail + rng.uniform(0, jitter)), kind="fail",
                    node=u) for u in victims]
    events.sort(key=lambda e: e.time)
    return Trace(n0=n0, capacity=n0, dist=dist, seed=seed,
                 events=events, name="regional_failure")


def diurnal_drift(n0: int = 40, dist: str = "bitnode", seed: int = 0, *,
                  period: float = 24_000.0, steps: int = 6,
                  amplitude: float = 0.4) -> Trace:
    """Sinusoidal global latency drift sampled at ``steps`` points per
    period: factor(t) = 1 + amplitude * sin(2 pi t / period)."""
    assert 0 <= amplitude < 1.0, amplitude
    events = [
        Event(time=(k + 1) * period / steps, kind="latency_drift",
              factor=float(1.0 + amplitude
                           * np.sin(2 * np.pi * (k + 1) / steps)))
        for k in range(steps)
    ]
    return Trace(n0=n0, capacity=n0, dist=dist, seed=seed,
                 events=events, name="diurnal_drift")


def straggler_storm(n0: int = 40, dist: str = "gaussian", seed: int = 0, *,
                    k: int = 3, factor: float = 6.0, t0: float = 4_000.0,
                    gap: float = 1_500.0) -> Trace:
    """``k`` distinct nodes degrade by ``factor`` x, one every ``gap`` ms."""
    rng = np.random.default_rng(seed + 1)
    victims = rng.choice(n0, size=min(k, n0), replace=False)
    events = [Event(time=t0 + i * gap, kind="straggler", node=int(u),
                    factor=factor) for i, u in enumerate(victims)]
    return Trace(n0=n0, capacity=n0, dist=dist, seed=seed,
                 events=events, name="straggler_storm")


def cluster_split_merge(n0: int = 96, dist: str = "fabric", seed: int = 0, *,
                        cluster: int = 0, peer: int = 1,
                        t_split: float = 4_000.0, t_merge: float = 12_000.0,
                        churn_rate: float = 0.2e-3,
                        horizon: float = 16_000.0) -> Trace:
    """Hierarchical reorganization under background churn: cluster
    ``cluster`` splits in two, then later absorbs cluster ``peer``, while
    Poisson join/leave churn keeps arriving.  Only hierarchical engines
    accept the cluster events; the flat engine rejects this trace with a
    descriptive error."""
    churn = poisson_churn(n0, dist, seed, horizon=horizon,
                          join_rate=churn_rate, leave_rate=churn_rate)
    reorg = Trace(n0=n0, capacity=n0, dist=dist, seed=seed, events=[
        Event(time=t_split, kind="cluster_split", node=cluster),
        Event(time=t_merge, kind="cluster_merge", node=cluster, peer=peer),
    ], name="cluster_reorg")
    return merge_traces(churn, reorg, name="cluster_split_merge")


def merge_traces(*traces: Trace, name: str | None = None) -> Trace:
    """Superimpose traces that share a latency world (n0/dist/seed must
    agree): events are merged in time order, capacity is the max.  This is
    how compound workloads (e.g. churn + drift) are assembled without a
    bespoke generator per combination."""
    if not traces:
        raise ValueError("merge_traces needs at least one trace")
    first = traces[0]
    for t in traces[1:]:
        if (t.n0, t.dist, t.seed) != (first.n0, first.dist, first.seed):
            raise ValueError(
                f"traces disagree on the latency world: "
                f"{(t.n0, t.dist, t.seed)} vs {(first.n0, first.dist, first.seed)}")
    events = sorted((e for t in traces for e in t.events), key=lambda e: e.time)
    return Trace(n0=first.n0, capacity=max(t.capacity for t in traces),
                 dist=first.dist, seed=first.seed, events=events,
                 name=name or "+".join(t.name for t in traces))


def churn_with_drift(n0: int = 40, dist: str = "bitnode", seed: int = 0, *,
                     horizon: float = 30_000.0, join_rate: float = 0.4e-3,
                     leave_rate: float = 0.4e-3, drift_steps: int = 6,
                     amplitude: float = 0.3) -> Trace:
    """The service benchmark's compound workload: memoryless join/leave
    churn superimposed on a diurnal latency cycle — membership changes keep
    arriving while every link's weight is drifting underneath them."""
    churn = poisson_churn(n0, dist, seed, horizon=horizon,
                          join_rate=join_rate, leave_rate=leave_rate)
    drift = diurnal_drift(n0, dist, seed, period=horizon,
                          steps=drift_steps, amplitude=amplitude)
    return merge_traces(churn, drift, name="churn_with_drift")


SCENARIOS: Dict[str, Callable[..., Trace]] = {
    "poisson_churn": poisson_churn,
    "flash_crowd": flash_crowd,
    "regional_failure": regional_failure,
    "diurnal_drift": diurnal_drift,
    "straggler_storm": straggler_storm,
    "churn_with_drift": churn_with_drift,
    "cluster_split_merge": cluster_split_merge,
}
