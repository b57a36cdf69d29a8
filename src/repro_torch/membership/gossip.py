"""Gossip membership plane over the DGRO ring (SWIM-style), in simulation.

A copy of ``repro.membership.gossip`` over the port's ``core.diameter``:
host numpy only, and the same seeds give the same times.

This is the paper's *application*: membership dissemination latency is
bounded by the overlay DIAMETER, which DGRO minimizes.  The simulator is a
discrete-event model over a latency matrix (the same matrices the paper
evaluates) and provides:

* SWIM probe/suspect/confirm failure detection over the DGRO overlay;
* push gossip dissemination with per-edge latency = w(u, v);
* measured dissemination latency (time until X% of members know an event),
  which tests assert is monotone in the overlay diameter;
* hooks used by the elastic layer: on confirmed failure the fleet re-runs
  DGRO over the survivors (see ``repro_torch.membership.elastic``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.diameter import is_edge, neighbour_lists


@dataclasses.dataclass
class GossipEvent:
    time: float
    dst: int
    kind: str           # "update" | "probe" | "ack"
    payload: Tuple


def neighbours(adj: np.ndarray, u: int) -> np.ndarray:
    return np.flatnonzero(is_edge(adj[u]))


def disseminate(
    adj: np.ndarray,
    w: np.ndarray,
    source: int,
    *,
    fanout: int = 2,
    proc_delay: float = 1.0,
    seed: int = 0,
    coverage: float = 1.0,
) -> Tuple[float, np.ndarray]:
    """Push-gossip a single update from ``source`` until ``coverage`` of
    nodes have it.  Each node, on first receipt, forwards to all ring
    neighbours plus ``fanout`` random peers after ``proc_delay`` ms.

    Returns (time until coverage reached, per-node receive times).
    """
    n = adj.shape[0]
    rng = np.random.default_rng(seed)
    neigh = neighbour_lists(adj)
    recv = np.full(n, np.inf)
    recv[source] = 0.0
    heap: List[Tuple[float, int]] = [(0.0, source)]
    covered = 1
    target = int(np.ceil(coverage * n))
    t_cov = 0.0
    while heap and covered < target:
        t, u = heapq.heappop(heap)
        if t > recv[u]:
            continue
        targets = list(neigh[u])
        extra = rng.choice(n, size=min(fanout, n), replace=False)
        targets.extend(int(e) for e in extra if e != u)
        for v in targets:
            t_arr = t + proc_delay + float(w[u, v])
            if t_arr < recv[v]:
                first = np.isinf(recv[v])
                recv[v] = t_arr
                heapq.heappush(heap, (t_arr, v))
        covered = int(np.sum(np.isfinite(recv)))
        if covered >= target:
            t_cov = float(np.sort(recv[np.isfinite(recv)])[target - 1])
    if covered < target:
        return float("inf"), recv
    return t_cov, recv


@dataclasses.dataclass
class SwimConfig:
    probe_period: float = 100.0       # ms between probes
    probe_timeout: float = 50.0       # direct-probe timeout
    indirect_k: int = 3               # SWIM indirect probes
    suspect_timeout: float = 300.0    # suspect -> confirm


@dataclasses.dataclass
class DetectionResult:
    t_failed: float
    t_first_suspect: float
    t_confirmed: float
    t_all_know: float                 # dissemination complete


def _swim_detection(adj: np.ndarray, failed: int, cfg: SwimConfig,
                    rng: np.random.Generator) -> Tuple[float, int]:
    """SWIM probe detection alone: (suspect time, detector node).

    Each ring neighbour probes the dead node at a random phase of its
    period; the direct probe times out, then the indirect probes do too."""
    n = adj.shape[0]
    nbrs = neighbours(adj, failed)
    if len(nbrs) == 0:
        nbrs = np.array([(failed + 1) % n])
    phases = rng.uniform(0, cfg.probe_period, size=len(nbrs))
    detect_times = phases + cfg.probe_timeout + cfg.probe_timeout
    first = int(np.argmin(detect_times))
    return float(detect_times[first]), int(nbrs[first])


def simulate_failure_detection(
    adj: np.ndarray,
    w: np.ndarray,
    failed: int,
    cfg: SwimConfig = SwimConfig(),
    seed: int = 0,
) -> DetectionResult:
    """One failure: node ``failed`` dies at t=0; SWIM probes detect it, the
    confirmation gossips over the overlay.  Event-driven approximation:
    detection by the first ring neighbour whose probe window hits, then
    dissemination via ``disseminate`` from the detector."""
    rng = np.random.default_rng(seed)
    t_suspect, detector = _swim_detection(adj, failed, cfg, rng)
    t_confirm = t_suspect + cfg.suspect_timeout
    t_diss, _ = disseminate(adj, w, detector, seed=seed, coverage=0.99)
    return DetectionResult(
        t_failed=0.0,
        t_first_suspect=t_suspect,
        t_confirmed=t_confirm,
        t_all_know=t_confirm + t_diss,
    )


def confirmed_leave_time(
    adj: np.ndarray,
    failed: int,
    t_fail: float = 0.0,
    cfg: SwimConfig = SwimConfig(),
    seed: int = 0,
) -> float:
    """Absolute time at which a crash at ``t_fail`` becomes an actionable
    membership change: SWIM probe detection + suspect->confirm timeout.

    This is the bridge into ``repro_torch.dynamics``: the churn engine turns a
    Fail event into a Leave event scheduled at this time, so the overlay
    keeps routing through the dead node until the gossip plane has actually
    confirmed the failure.  Only detection is simulated — the dissemination
    sweep of ``simulate_failure_detection`` (which this rng-matches) feeds
    ``t_all_know``, a quantity the confirmation time never uses."""
    rng = np.random.default_rng(seed)
    t_suspect, _ = _swim_detection(adj, failed, cfg, rng)
    return t_fail + t_suspect + cfg.suspect_timeout
