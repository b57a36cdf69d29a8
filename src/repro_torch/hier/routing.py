"""Three-leg greedy routing over a hierarchical overlay (torch port of
``repro.hier.routing``).

A node in cluster ``a`` reaches a node in cluster ``b`` the way the
topology is wired: greedy within ``a`` to the cluster head, greedy over
the head ring to ``b``'s head, greedy within ``b`` to the destination
(intra-cluster pairs route in one local leg).  Every leg reuses the
packed-neighbour-table router from :mod:`repro_torch.routing.greedy` —
the batched variant groups legs per cluster so a (P, 2) pair batch costs
one ``route_pairs`` walk on the eval device per touched cluster plus one
for the head ring, and the
single-pair host variant (served by ``/v1/route``) applies the identical
float32 next-hop rule per leg.

Observability: delivered routes record per-level hop counts into the
pre-registered ``repro_hier_route_hops{level="local"|"head"}`` histogram
(:mod:`repro_torch.obs`), and request outcomes land in the shared
``repro_route_requests_total`` counter under policy ``"hier-<policy>"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import HIER_ROUTE_HOPS
from repro_torch.routing.greedy import (RouteResult, ring_distance_keys,
                                        route_pairs, route_single_host)
from repro_torch.routing.metrics import ROUTE_REQUESTS

__all__ = ["HierRouteResult", "route_pairs_hier", "route_single_hier"]


@dataclasses.dataclass(frozen=True)
class HierRouteResult:
    """Per-pair outcome of one batched hierarchical routing call.

    Mirrors :class:`repro_torch.routing.greedy.RouteResult` (same field
    semantics) with the hop count split by level: ``hops = hops_local +
    hops_head``.  ``optimum`` is the exact hierarchical shortest-path
    latency (:meth:`HierarchicalOverlay.distance_bound_pairs`), so
    ``stretch`` prices the greedy walk against the true optimum of this
    topology.
    """

    pairs: np.ndarray        # (P, 2) intp global src/dst
    hops: np.ndarray         # (P,) int32 total
    hops_local: np.ndarray   # (P,) int32 intra-cluster hops
    hops_head: np.ndarray    # (P,) int32 head-ring hops
    latency: np.ndarray      # (P,) float32
    success: np.ndarray      # (P,) bool
    failed: np.ndarray       # (P,) bool dead-ended on some leg
    optimum: np.ndarray      # (P,) float32
    stretch: np.ndarray      # (P,) float32; NaN unless delivered

    @property
    def n_pairs(self) -> int:
        return int(self.pairs.shape[0])


def _leg_route(ov, pairs: np.ndarray, policy: str,
               hop_budget: Optional[int]) -> RouteResult:
    """One leg on one flat overlay (cluster or head ring)."""
    ring = np.asarray(ov.rings[0]) if ov.rings else None
    return route_pairs(ov.adjacency, ov.distances(), pairs, policy=policy,
                       ring=ring, hop_budget=hop_budget)


def _merge_leg(rows: np.ndarray, res: RouteResult, hops: np.ndarray,
               lat: np.ndarray, success: np.ndarray,
               failed: np.ndarray) -> None:
    hops[rows] += res.hops
    lat[rows] += res.latency
    success[rows] &= res.success
    failed[rows] |= res.failed


def _record_batch(policy: str, success: np.ndarray, failed: np.ndarray,
                  hops_local: np.ndarray, hops_head: np.ndarray) -> None:
    label = f"hier-{policy}"
    n_ok = int(success.sum())
    n_dead = int(failed.sum())
    n_exhausted = success.size - n_ok - n_dead
    for outcome, count in (("delivered", n_ok), ("dead_end", n_dead),
                           ("exhausted", n_exhausted)):
        if count:
            ROUTE_REQUESTS.labels(policy=label, outcome=outcome).inc(count)
    local = HIER_ROUTE_HOPS.labels(level="local")
    head = HIER_ROUTE_HOPS.labels(level="head")
    for h in hops_local[success]:
        local.observe(int(h))
    for h in hops_head[success & (hops_head > 0)]:
        head.observe(int(h))


def route_pairs_hier(hov, pairs: np.ndarray, *, policy: str = "latency",
                     hop_budget: Optional[int] = None) -> HierRouteResult:
    """Route a (P, 2) batch of GLOBAL-id pairs over the hierarchy.

    Legs are grouped per cluster (and one head-ring batch), so the number
    of device walks is bounded by the number of touched clusters, not P.
    ``hop_budget`` applies per leg (default: the leg overlay's own N).
    """
    pairs = np.asarray(pairs, np.intp).reshape(-1, 2)
    p = pairs.shape[0]
    src, dst = pairs[:, 0], pairs[:, 1]
    a = hov.assignment[src]
    b = hov.assignment[dst]
    lsrc, ldst = hov._local[src], hov._local[dst]
    hl = hov._local[hov.heads]

    hops_local = np.zeros(p, np.int32)
    hops_head = np.zeros(p, np.int32)
    lat = np.zeros(p, np.float32)
    success = np.ones(p, bool)
    failed = np.zeros(p, bool)

    inter = a != b
    # leg 1 + intra leg: grouped by source cluster.  Intra pairs aim at
    # their destination; inter pairs aim at the source cluster's head.
    for c in np.unique(a):
        rows = np.flatnonzero(a == c)
        tgt = np.where(inter[rows], hl[c], ldst[rows])
        res = _leg_route(hov.clusters[c],
                         np.stack([lsrc[rows], tgt], axis=1), policy,
                         hop_budget)
        _merge_leg(rows, res, hops_local, lat, success, failed)
    # leg 2: one batch on the head ring (cluster-id node space)
    rows = np.flatnonzero(inter)
    if rows.size:
        res = _leg_route(hov.head_overlay,
                         np.stack([a[rows], b[rows]], axis=1), policy,
                         hop_budget)
        hops_head[rows] += res.hops
        lat[rows] += res.latency
        success[rows] &= res.success
        failed[rows] |= res.failed
        # leg 3: grouped by destination cluster, head -> dst
        for c in np.unique(b[rows]):
            sub = rows[b[rows] == c]
            res = _leg_route(hov.clusters[c],
                             np.stack([np.full(sub.size, hl[c], np.intp),
                                       ldst[sub]], axis=1), policy,
                             hop_budget)
            _merge_leg(sub, res, hops_local, lat, success, failed)

    optimum, _ = hov.distance_bound_pairs(src, dst)
    optimum = optimum.astype(np.float32)
    stretch = np.full(p, np.nan, np.float32)
    pos = success & (optimum > 0)
    stretch[pos] = lat[pos] / optimum[pos]
    stretch[success & (optimum == 0)] = 1.0
    _record_batch(policy, success, failed, hops_local, hops_head)
    return HierRouteResult(pairs=pairs, hops=hops_local + hops_head,
                           hops_local=hops_local, hops_head=hops_head,
                           latency=lat, success=success, failed=failed,
                           optimum=optimum, stretch=stretch)


def _leg_single(ov, src_local: int, dst_local: int, policy: str,
                hop_budget: Optional[int]
                ) -> Tuple[List[int], float, int, str]:
    if policy == "ring" and ov.rings:
        key = ring_distance_keys(np.asarray(ov.rings[0]),
                                 np.asarray([dst_local]))[0]
    else:
        key = ov.distances()[:, dst_local]
    return route_single_host(ov.adjacency, key, src_local, dst_local,
                             policy=policy, hop_budget=hop_budget)


def route_single_hier(hov, src: int, dst: int, *, policy: str = "latency",
                      hop_budget: Optional[int] = None
                      ) -> Tuple[List[int], float, Dict[str, int], str]:
    """Route ONE pair on the host, returning the GLOBAL-id path.

    Returns ``(path, latency, hops_by_level, outcome)`` where
    ``hops_by_level`` has ``"local"`` / ``"head"`` keys and outcome is
    ``"delivered"`` / ``"dead_end"`` / ``"exhausted"`` (first failing leg
    wins).  Metrics are recorded per call, matching the batched variant.
    """
    src, dst = int(src), int(dst)
    a, b = hov.cluster_of(src), hov.cluster_of(dst)
    hl = hov._local[hov.heads]
    legs: List[Tuple[str, object, int, int, np.ndarray]] = []
    if a == b:
        legs.append(("local", hov.clusters[a], hov.local_id(src),
                     hov.local_id(dst), hov.members[a]))
    else:
        legs.append(("local", hov.clusters[a], hov.local_id(src),
                     int(hl[a]), hov.members[a]))
        legs.append(("head", hov.head_overlay, a, b, hov.heads))
        legs.append(("local", hov.clusters[b], int(hl[b]),
                     hov.local_id(dst), hov.members[b]))
    path: List[int] = []
    lat = 0.0
    hops = {"local": 0, "head": 0}
    outcome = "delivered"
    for level, ov, s, d, to_global in legs:
        leg_path, leg_lat, leg_hops, outcome = _leg_single(
            ov, s, d, policy, hop_budget)
        glob = [int(to_global[u]) for u in leg_path]
        path.extend(glob if not path else glob[1:])
        lat += leg_lat
        hops[level] += leg_hops
        if outcome != "delivered":
            break
    ROUTE_REQUESTS.labels(policy=f"hier-{policy}", outcome=outcome).inc()
    if outcome == "delivered":
        HIER_ROUTE_HOPS.labels(level="local").observe(hops["local"])
        if hops["head"]:
            HIER_ROUTE_HOPS.labels(level="head").observe(hops["head"])
    return path, float(lat), hops, outcome
