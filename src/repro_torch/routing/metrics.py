"""Routing-run summaries + the routing observability instruments.

:class:`RoutingSummary` is the serde-stamped artifact shape the fig19
matrix embeds (one row per builder × workload × policy).  The module also
registers the routing defaults on the process-global ``repro_torch.obs``
registry — the SAME two instruments the service's ``/v1/route`` endpoint
and the fig19 benchmark record into, so a live scrape and a benchmark
artifact always agree on what a "route request" is:

* ``repro_route_hops`` — hop-count histogram of delivered routes;
* ``repro_route_requests_total{policy,outcome}`` — requests by next-hop
  policy (``ring`` / ``latency``) and outcome (``delivered`` /
  ``dead_end`` / ``exhausted`` / ``unreachable``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch import serde
from repro_torch.core.diameter import INF
from repro_torch.obs import REGISTRY

from .greedy import RouteResult

__all__ = [
    "HOP_BUCKETS",
    "ROUTE_HOPS",
    "ROUTE_REQUESTS",
    "record_route",
    "record_route_batch",
    "RoutingSummary",
    "summarize",
]

# hop counts are small integers: power-of-two-ish bounds up to deep walks
HOP_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)

ROUTE_HOPS = REGISTRY.histogram(
    "repro_route_hops", "hop count per delivered greedy route",
    buckets=HOP_BUCKETS)
ROUTE_REQUESTS = REGISTRY.counter(
    "repro_route_requests_total",
    "greedy route requests, by next-hop policy and outcome",
    labels=("policy", "outcome"))


def record_route(policy: str, outcome: str,
                 hops: Optional[int] = None) -> None:
    """Count one route request; delivered routes also land in the hop
    histogram."""
    ROUTE_REQUESTS.labels(policy=policy, outcome=outcome).inc()
    if outcome == "delivered" and hops is not None:
        ROUTE_HOPS.observe(int(hops))


def record_route_batch(policy: str, result: RouteResult) -> None:
    """Record every pair of a batched routing call (one counter bump per
    outcome class, one histogram observation per delivered pair)."""
    n_delivered = int(result.success.sum())
    n_dead = int(result.failed.sum())
    n_exhausted = result.n_pairs - n_delivered - n_dead
    for outcome, count in (("delivered", n_delivered), ("dead_end", n_dead),
                           ("exhausted", n_exhausted)):
        if count:
            ROUTE_REQUESTS.labels(policy=policy, outcome=outcome).inc(count)
    for h in result.hops[result.success]:
        ROUTE_HOPS.observe(int(h))


@dataclasses.dataclass(frozen=True)
class RoutingSummary:
    """Aggregate routing quality of one (builder, workload, policy) cell.

    Stretch statistics are over DELIVERED pairs only (NaN when nothing
    was delivered); ``success_rate`` counts delivery over pairs whose
    endpoints are connected at all, so a partitioned fleet doesn't charge
    the router for physics.
    """

    builder: str
    workload: str
    policy: str
    n: int
    n_pairs: int
    hop_budget: int
    success_rate: float
    hops_mean: float
    hops_max: int
    latency_mean: float
    stretch_mean: float
    stretch_p99: float
    stretch_max: float

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return serde.dumps({"kind": "routing_summary", **self.to_dict()})

    @classmethod
    def from_json(cls, s: str) -> "RoutingSummary":
        d = serde.loads(s, what="RoutingSummary JSON")
        if d.pop("kind", "routing_summary") != "routing_summary":
            raise ValueError("not a routing_summary payload")
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


def summarize(result: RouteResult, *, builder: str = "custom",
              workload: str = "custom", policy: str = "latency",
              n: int = 0, hop_budget: int = 0) -> RoutingSummary:
    """Fold a :class:`RouteResult` into one :class:`RoutingSummary`."""
    reachable = (np.isnan(result.optimum)
                 | (result.optimum < float(INF) / 2))
    denom = max(int(reachable.sum()), 1)
    ok = result.success
    stretch = result.stretch[ok & np.isfinite(result.stretch)]
    return RoutingSummary(
        builder=builder, workload=workload, policy=policy, n=int(n),
        n_pairs=result.n_pairs, hop_budget=int(hop_budget),
        success_rate=float(ok.sum()) / denom,
        hops_mean=float(result.hops[ok].mean()) if ok.any() else float("nan"),
        hops_max=int(result.hops.max()) if result.n_pairs else 0,
        latency_mean=(float(result.latency[ok].mean()) if ok.any()
                      else float("nan")),
        stretch_mean=float(stretch.mean()) if stretch.size else float("nan"),
        stretch_p99=(float(np.percentile(stretch, 99)) if stretch.size
                     else float("nan")),
        stretch_max=float(stretch.max()) if stretch.size else float("nan"),
    )
