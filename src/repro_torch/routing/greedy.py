"""Batched greedy routing over an overlay (torch port of
``repro.routing.greedy``).

Diameter says how good an overlay *could* be; greedy routing says how good
it *is* to a node that only knows its neighbours plus a per-destination
potential.  :func:`route_pairs` routes a ``(P, 2)`` batch of
source/destination pairs on the eval device (``batcheval.eval_device()``:
CUDA unless the caller asks for the CPU).  The reference's fixed-length
``lax.scan`` over the hop budget is a Python loop here; each step gathers
the packed neighbours (:func:`_neighbor_table`) of every pair's current
node, scores them, takes a first-min ``argmin`` and applies the same masked
update: delivered and dead-ended pairs freeze while the rest keep walking.
The reference skips settled steps with a batch-wide ``lax.cond``; here the
loop reads "is any pair still live" back to the host once every
``_CHECK_EVERY`` hops and stops when none is.  Settled pairs are frozen by
the update itself, so stopping early changes no result.

Two next-hop policies:

* ``"ring"`` — Papillon-style ring-distance greedy: hop to the neighbour
  minimising circular distance to the destination on the base ring,
  requiring strict progress (so routing on any overlay that embeds the
  full ring always terminates and succeeds — the ±1 ring edges always
  make progress).
* ``"latency"`` — potential descent on ``adj[u, v] + D[v, dst]`` where
  ``D`` is a distance matrix honouring the ``dynamics.incremental``
  contract: exact, or an elementwise LOWER bound (between deletion-
  triggered rebuilds).  With an exact ``D`` the descent follows a
  shortest path (stretch exactly 1); with a stale lower bound it can
  wander, which the hop budget and per-pair failure flags absorb.

The walk never builds the reference's (P, N) key matrix: a step gathers the
potential of the D candidates only — ``D[cand, dst]`` for the latency
policy (``D`` may already be a tensor on the device, which saves its
upload), the circular ring distance from the ring positions for the ring
policy.  The potentials are the reference's float32 values, every score is
one float32 add (``wrow + key``) and latency accumulates in hop order, so
hops, latency and outcomes are bitwise the reference's.

The numpy reference (:func:`route_single_host` / :func:`route_pairs_host`)
applies the *identical* float32 decision rule, so the fig19 parity gate
can assert hop/latency equality bit-for-bit — and it doubles as the one
shared implementation ``repro_torch.service``'s ``/v1/route`` serves paths
from.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batcheval
from repro_torch.core.diameter import INF
from repro_torch.device import upload
from repro_torch.obs import jit_span

__all__ = [
    "POLICIES",
    "RouteResult",
    "ring_positions",
    "ring_distance_keys",
    "latency_keys",
    "route_pairs",
    "route_overlay",
    "route_single_host",
    "route_pairs_host",
]

#: next-hop policies, in the order fig19 reports them
POLICIES = ("ring", "latency")

# score assigned to non-edges / useless hops; must stay above any real
# ``adj + D`` sum (each < INF) yet well inside float32 range
_BLOCKED = np.float32(4.0) * np.float32(INF)
_HALF_INF = float(INF) / 2

# hops between two reads of "is any pair still live" (one host sync each)
_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class RouteResult:
    """Per-pair outcome of one batched routing call.

    ``stretch`` is path latency over the APSP optimum between the
    endpoints: exactly 1.0 for an optimal route, NaN for pairs that were
    not delivered (or whose optimum is unknown/INF).  ``failed`` marks
    dead ends (no useful neighbour); pairs that are neither delivered nor
    failed ran out of hop budget.
    """

    pairs: np.ndarray      # (P, 2) intp src/dst
    hops: np.ndarray       # (P,) int32
    latency: np.ndarray    # (P,) float32 accumulated path latency
    success: np.ndarray    # (P,) bool delivered
    failed: np.ndarray     # (P,) bool dead-ended (vs budget-exhausted)
    optimum: np.ndarray    # (P,) float32 APSP d(src, dst)
    stretch: np.ndarray    # (P,) float32; NaN unless delivered

    @property
    def n_pairs(self) -> int:
        return int(self.pairs.shape[0])

    def outcome(self, p: int) -> str:
        if self.success[p]:
            return "delivered"
        return "dead_end" if self.failed[p] else "exhausted"


# ---------------------------------------------------------------------------
# per-destination potentials ("keys")
# ---------------------------------------------------------------------------

def ring_positions(ring: np.ndarray) -> np.ndarray:
    """``pos[node] = index of node on the ring`` for a ring permutation."""
    ring = np.asarray(ring, np.intp)
    pos = np.empty(ring.shape[0], np.intp)
    pos[ring] = np.arange(ring.shape[0])
    return pos


def ring_distance_keys(ring: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(P, N) circular ring distance from every node to each pair's dst."""
    pos = ring_positions(ring)
    n = pos.shape[0]
    delta = np.abs(pos[None, :] - pos[np.asarray(dst, np.intp)][:, None])
    return np.minimum(delta, n - delta).astype(np.float32)


def latency_keys(dist: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(P, N) lower-bound distance from every node to each pair's dst."""
    return np.asarray(dist, np.float32)[:, np.asarray(dst, np.intp)].T


def _check_policy(policy: str, dist, ring) -> None:
    if policy == "latency":
        if dist is None:
            raise ValueError("latency policy needs the distance matrix")
    elif policy == "ring":
        if ring is None:
            raise ValueError("ring policy needs a base ring permutation")
    else:
        raise ValueError(
            f"unknown routing policy {policy!r}; options {POLICIES}")


def _keys_for(policy: str, dst: np.ndarray, dist: Optional[np.ndarray],
              ring: Optional[np.ndarray]) -> np.ndarray:
    _check_policy(policy, dist, ring)
    if policy == "latency":
        return latency_keys(dist, dst)
    return ring_distance_keys(ring, dst)


# ---------------------------------------------------------------------------
# the device router
# ---------------------------------------------------------------------------

def _neighbor_table(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pack an (N, N) adjacency into a padded neighbour table.

    Returns ``(nbr_idx (N, D) int32, nbr_w (N, D) float32)`` with D the
    max degree: row u lists u's neighbours in ASCENDING node order (so a
    first-min argmin over the row breaks score ties exactly like the host
    reference's argmin over all N nodes) and their edge latencies, padded
    with ``_BLOCKED`` weights.  The walk's per-hop work then scales with
    the overlay degree, not with N.
    """
    adj = np.asarray(adj, np.float32)
    edge = (adj > 0) & (adj < _HALF_INF)
    d = max(int(edge.sum(axis=1).max(initial=0)), 1)
    # stable argsort of ~edge floats edges first, ascending node order
    order = np.argsort(~edge, axis=1, kind="stable")[:, :d].astype(np.int32)
    valid = np.take_along_axis(edge, order, axis=1)
    w = np.take_along_axis(adj, order, axis=1)
    return order, np.where(valid, w, _BLOCKED)


def _dist_on(dist, device: torch.device) -> torch.Tensor:
    """The distance matrix as float32 on ``device`` (a tensor already there
    is used as it is; a host array goes up once)."""
    if isinstance(dist, torch.Tensor):
        return dist.to(device=device, dtype=torch.float32)
    return upload(np.asarray(dist, np.float32), device)


def _ids_on(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return upload(np.asarray(x, np.int64), device)


def _walk(nbr_idx: torch.Tensor, nbr_w: torch.Tensor, policy: str,
          dist: Optional[torch.Tensor], pos: Optional[torch.Tensor],
          src: torch.Tensor, dst: torch.Tensor, budget: int):
    """Route all P pairs: at most ``budget`` masked greedy steps, each one
    gather of the (P, D) candidates, one score, one first-min argmin.

    A step scores only the <= D packed neighbours of each pair's node.
    Real-edge scores are bit-identical to the host reference's dense
    ``where(edge, adj + key, BLOCKED)`` row; pad entries differ
    (``_BLOCKED + key`` vs ``_BLOCKED``) but both stay ``>= _HALF_INF``,
    and a pad argmin winner only occurs on the stuck branch where the
    index is discarded.  Returns ``(hops, lat, done, failed)`` tensors.
    """
    p = src.shape[0]
    cur = src
    lat = torch.zeros(p, dtype=torch.float32, device=src.device)
    hops = torch.zeros(p, dtype=torch.int32, device=src.device)
    done = src == dst
    failed = torch.zeros(p, dtype=torch.bool, device=src.device)
    if pos is not None:
        pos_dst = pos[dst]
        ring_n = pos.shape[0]

        def ring_key(delta):             # circular distance, exact in fp32
            delta = delta.abs()
            return torch.minimum(delta, ring_n - delta).to(torch.float32)

    for step in range(budget):
        if step % _CHECK_EVERY == 0 and not bool((~done & ~failed).any()):
            break
        cands = nbr_idx[cur]                               # (P, D)
        wrow = nbr_w[cur]                                  # (P, D)
        if policy == "latency":
            score = wrow + dist[cands, dst[:, None]]
        else:
            score = torch.where(wrow < _HALF_INF,
                                ring_key(pos[cands] - pos_dst[:, None]),
                                float(_BLOCKED))
        j = score.argmin(dim=1, keepdim=True)              # first minimum
        nxt = cands.gather(1, j)[:, 0]
        best = score.gather(1, j)[:, 0]
        if policy == "latency":
            stuck = best >= _HALF_INF      # no neighbour with a finite bound
        else:
            # ring greedy demands strict progress
            stuck = best >= ring_key(pos[cur] - pos_dst)
        active = ~done & ~failed
        move = active & ~stuck
        failed = failed | (active & stuck)
        lat = lat + torch.where(move, wrow.gather(1, j)[:, 0], 0.0)
        hops = hops + move.to(torch.int32)
        cur = torch.where(move, nxt, cur)
        done = done | (cur == dst)
    return hops, lat, done, failed


def _stretch(lat: np.ndarray, success: np.ndarray,
             optimum: np.ndarray) -> np.ndarray:
    out = np.full(lat.shape, np.nan, np.float32)
    ok = success & (optimum < _HALF_INF)
    pos = ok & (optimum > 0)
    out[pos] = lat[pos] / optimum[pos]
    out[ok & (optimum == 0)] = 1.0          # src == dst: trivially optimal
    return out


def route_pairs(adj: np.ndarray, dist, pairs: np.ndarray, *,
                policy: str = "latency", ring: Optional[np.ndarray] = None,
                hop_budget: Optional[int] = None) -> RouteResult:
    """Route a (P, 2) pair batch over an adjacency on the eval device.

    ``dist`` guides the ``"latency"`` policy (exact or lower bound, per
    the incremental-maintenance contract) and, when given, prices the
    stretch denominator; it may be a numpy array or a tensor (a tensor
    already on the eval device is read in place).  ``ring`` is the base
    ring the ``"ring"`` policy descends on.  ``hop_budget`` defaults to N
    (a strict-descent walk can never need more).  The device is
    ``batcheval.eval_device()``: CUDA unless the caller asks for the CPU
    (``batcheval.eval_options(device="cpu")``); it raises where there is
    no CUDA device and no such request.
    """
    device = batcheval.eval_device()
    adj = np.asarray(adj, np.float32)
    pairs = np.asarray(pairs, np.intp).reshape(-1, 2)
    n = adj.shape[0]
    src, dst = pairs[:, 0], pairs[:, 1]
    budget = n if hop_budget is None else int(hop_budget)
    _check_policy(policy, dist, ring)
    nbr_idx, nbr_w = _neighbor_table(adj)
    d_dev = _dist_on(dist, device) if dist is not None else None
    src_t, dst_t = _ids_on(src, device), _ids_on(dst, device)
    with jit_span("routing.route_pairs",
                  key=(pairs.shape[0], n, nbr_idx.shape[1], policy, budget)):
        hops, lat, done, failed = _walk(
            _ids_on(nbr_idx, device), upload(nbr_w, device), policy,
            d_dev if policy == "latency" else None,
            _ids_on(ring_positions(ring), device) if policy == "ring"
            else None, src_t, dst_t, budget)
        # one copy back: hops (< 2^24) and the flags are exact in fp32
        cols = [hops.to(torch.float32), lat, done.to(torch.float32),
                failed.to(torch.float32)]
        if d_dev is not None:
            cols.append(d_dev[src_t, dst_t])
        out = torch.stack(cols).cpu().numpy()
    hops = out[0].astype(np.int32)
    lat = np.ascontiguousarray(out[1])
    success, failed = out[2] > 0, out[3] > 0
    optimum = (np.ascontiguousarray(out[4]) if dist is not None
               else np.full(len(src), np.nan, np.float32))
    return RouteResult(pairs=pairs, hops=hops, latency=lat, success=success,
                       failed=failed, optimum=optimum,
                       stretch=_stretch(lat, success, optimum))


def route_overlay(ov, pairs: np.ndarray, *, policy: str = "latency",
                  hop_budget: Optional[int] = None) -> RouteResult:
    """Route over an :class:`~repro_torch.overlay.Overlay`: the latency
    policy descends on the overlay's exact APSP matrix (``batcheval``),
    the ring policy on its first embedded ring."""
    ring = np.asarray(ov.rings[0]) if ov.rings else None
    return route_pairs(ov.adjacency, ov.distances(), pairs, policy=policy,
                       ring=ring, hop_budget=hop_budget)


# ---------------------------------------------------------------------------
# numpy reference (parity oracle + the service's path-serving router)
# ---------------------------------------------------------------------------

def route_single_host(adj: np.ndarray, key_to_dst: np.ndarray, src: int,
                      dst: int, *, policy: str = "latency",
                      hop_budget: Optional[int] = None
                      ) -> Tuple[List[int], float, int, str]:
    """Greedy-route ONE pair on the host, recording the path.

    Applies bit-for-bit the same float32 next-hop rule as the batched
    router (same scores, same first-min tie break), so the two agree
    exactly on every hop.  Returns ``(path, latency, hops, outcome)`` with
    outcome one of ``"delivered"`` / ``"dead_end"`` / ``"exhausted"``.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown routing policy {policy!r}; "
                         f"options {POLICIES}")
    adj = np.asarray(adj, np.float32)
    key = np.asarray(key_to_dst, np.float32)
    budget = adj.shape[0] if hop_budget is None else int(hop_budget)
    blocked = _BLOCKED
    cur, lat, hops = int(src), np.float32(0.0), 0
    path = [cur]
    if cur == int(dst):
        return path, float(lat), hops, "delivered"
    for _ in range(budget):
        adjrow = adj[cur]
        edge = (adjrow > 0) & (adjrow < _HALF_INF)
        if policy == "latency":
            score = np.where(edge, adjrow + key, blocked)
            nxt = int(np.argmin(score))
            stuck = float(score[nxt]) >= _HALF_INF
        else:
            score = np.where(edge, key, blocked)
            nxt = int(np.argmin(score))
            stuck = float(score[nxt]) >= float(key[cur])
        if stuck:
            return path, float(lat), hops, "dead_end"
        lat = np.float32(lat + adjrow[nxt])
        hops += 1
        cur = nxt
        path.append(cur)
        if cur == int(dst):
            return path, float(lat), hops, "delivered"
    return path, float(lat), hops, "exhausted"


def route_pairs_host(adj: np.ndarray, dist: Optional[np.ndarray],
                     pairs: np.ndarray, *, policy: str = "latency",
                     ring: Optional[np.ndarray] = None,
                     hop_budget: Optional[int] = None) -> RouteResult:
    """Per-pair host loop over :func:`route_single_host` — the baseline
    the fig19 speedup gate measures and the parity oracle for the
    batched router."""
    adj = np.asarray(adj, np.float32)
    pairs = np.asarray(pairs, np.intp).reshape(-1, 2)
    budget = adj.shape[0] if hop_budget is None else int(hop_budget)
    keys = _keys_for(policy, pairs[:, 1], dist, ring)
    p = pairs.shape[0]
    hops = np.zeros(p, np.int32)
    lat = np.zeros(p, np.float32)
    success = np.zeros(p, bool)
    failed = np.zeros(p, bool)
    for i, (s, d) in enumerate(pairs):
        _, lat_i, hops_i, outcome = route_single_host(
            adj, keys[i], int(s), int(d), policy=policy, hop_budget=budget)
        lat[i], hops[i] = lat_i, hops_i
        success[i] = outcome == "delivered"
        failed[i] = outcome == "dead_end"
    optimum = (latency_keys(dist, pairs[:, 1])[np.arange(p), pairs[:, 0]]
               if dist is not None else np.full(p, np.nan, np.float32))
    return RouteResult(pairs=pairs, hops=hops, latency=lat, success=success,
                       failed=failed, optimum=optimum,
                       stretch=_stretch(lat, success, optimum))
