"""repro_torch.routing — overlays evaluated as routing fabrics (the torch
port of ``repro.routing``).

The paper scores overlays by diameter; this package scores them by what a
message actually experiences: greedy next-hop routing over a ``(P, 2)``
batch of source/destination pairs, on the eval device (CUDA unless the
caller asks for the CPU).

    from repro_torch import overlay, routing
    from repro_torch.core.topology import make_latency

    w = make_latency("bitnode", 256, seed=0)
    ov = overlay.build("kleinberg", w, seed=0)      # distances on CUDA
    pairs = routing.sample_pairs(256, 1024, "hotspot", seed=0)
    res = routing.route_overlay(ov, pairs, policy="ring")
    routing.summarize(res, builder="kleinberg", workload="hotspot",
                      policy="ring", n=256, hop_budget=256)

Layout: :mod:`~repro_torch.routing.greedy` (the batched router + its
numpy parity/serving reference), :mod:`~repro_torch.routing.workload`
(seeded uniform / hotspot / regional pair mixes),
:mod:`~repro_torch.routing.metrics` (serde-stamped summaries + the ``repro_route_*`` observability defaults
shared with ``repro_torch.service``'s ``/v1/route``).
"""
from .greedy import (POLICIES, RouteResult, latency_keys,  # noqa: F401
                     ring_distance_keys, ring_positions, route_overlay,
                     route_pairs, route_pairs_host, route_single_host)
from .metrics import (HOP_BUCKETS, ROUTE_HOPS, ROUTE_REQUESTS,  # noqa: F401
                      RoutingSummary, record_route, record_route_batch,
                      summarize)
from .workload import WORKLOADS, sample_pairs  # noqa: F401

__all__ = [
    "POLICIES", "RouteResult", "latency_keys", "ring_distance_keys",
    "ring_positions", "route_overlay", "route_pairs", "route_pairs_host",
    "route_single_host",
    "HOP_BUCKETS", "ROUTE_HOPS", "ROUTE_REQUESTS", "RoutingSummary",
    "record_route", "record_route_batch", "summarize",
    "WORKLOADS", "sample_pairs",
]
