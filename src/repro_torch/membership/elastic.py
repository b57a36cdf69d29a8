"""Elastic scaling + straggler mitigation on top of the membership plane.

A copy of ``repro.membership.elastic`` over the port's ``overlay`` and
``core.selection`` (host numpy): the same seeds give the same plans and
rings.

On a confirmed membership change (failure, join, or straggler demotion) the
fleet computes a RESCALE PLAN:

  1. re-run DGRO ring selection over the surviving hosts' latency matrix
     (the paper's §V adaptive selection — random vs nearest ring by rho);
  2. choose the largest valid mesh (pod, data, model) that the survivors
     support, preferring to shrink the data axis (model-parallel groups must
     stay intact so checkpoint shards stay host-local);
  3. emit a checkpoint-shard remap: which host reads which shard range.

Straggler policy: hosts whose heartbeat-latency EWMA exceeds
``straggler_factor`` x fleet median are demoted — treated as failed for mesh
membership (they can still serve traffic) — the classic tail-latency
mitigation of Dean & Barroso, driven here by the paper's own gossip
measurements (Alg. 3's L_local samples double as heartbeat RTTs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import overlay as overlay_api
from repro_torch.core.selection import (clustering_ratio, measure_latency_stats,
                                  select_ring_kind)


@dataclasses.dataclass
class HostState:
    host_id: int
    alive: bool = True
    ewma_ms: float = 1.0


@dataclasses.dataclass
class RescalePlan:
    hosts: List[int]                  # surviving hosts, DGRO ring order
    mesh_shape: Tuple[int, ...]       # (pods, data, model) in hosts
    ring_kind: str                    # ring chosen by rho selection
    rho: float
    shard_remap: Dict[int, int]       # old shard id -> new owner host
    expected_step_time_factor: float  # ~ new_world/old_world compute scaling


def update_ewma(state: HostState, sample_ms: float, alpha: float = 0.2):
    state.ewma_ms = (1 - alpha) * state.ewma_ms + alpha * sample_ms


def detect_stragglers(hosts: Sequence[HostState],
                      factor: float = 3.0) -> List[int]:
    alive = [h for h in hosts if h.alive]
    med = float(np.median([h.ewma_ms for h in alive])) if alive else 1.0
    return [h.host_id for h in alive if h.ewma_ms > factor * med]


def _largest_mesh(n_hosts: int, model_hosts: int) -> Tuple[int, int, int]:
    """(pods, data, model) host-level factorization: keep model groups whole,
    then the largest power-of-two data axis, pods = what remains."""
    usable = (n_hosts // model_hosts) * model_hosts
    groups = usable // model_hosts
    data = 1 << int(np.floor(np.log2(max(groups, 1))))
    return (groups // data if data else 1, data, model_hosts)


def plan_rescale(
    w: np.ndarray,
    hosts: Sequence[HostState],
    *,
    model_hosts: int = 1,
    old_world: Optional[int] = None,
    straggler_factor: float = 3.0,
    seed: int = 0,
) -> RescalePlan:
    """Compute the post-event mesh + ring + shard remap."""
    stragglers = set(detect_stragglers(hosts, straggler_factor))
    members = [h.host_id for h in hosts if h.alive and h.host_id not in stragglers]
    if not members:
        raise RuntimeError("no live hosts")
    sub = w[np.ix_(members, members)]

    # paper §V: measure rho on a probe (random-ring) overlay and pick the
    # ring kind; both rings come from the overlay builder registry
    rng = np.random.default_rng(seed)
    probe = overlay_api.build("random", sub,
                              overlay_api.RandomRingsConfig(k=1), rng=rng)
    stats = measure_latency_stats(sub, probe.adjacency, seed=seed)
    rho = clustering_ratio(stats)
    kind = select_ring_kind(rho)
    if kind == "nearest":
        chosen = overlay_api.build(
            "nearest", sub, overlay_api.NearestRingsConfig(k=1), rng=rng)
        ring = chosen.rings[0]
    elif kind == "random":
        ring = probe.rings[0]
    else:
        ring = probe.rings[0]
        kind = "keep-random"
    ordered = [members[i] for i in ring]

    pods, data, model = _largest_mesh(len(ordered), model_hosts)
    world = pods * data * model
    ordered = ordered[:world]
    remap = {i: ordered[i % len(ordered)] for i in range(old_world or world)}
    factor = (old_world / world) if old_world else 1.0
    return RescalePlan(hosts=ordered, mesh_shape=(pods, data, model),
                       ring_kind=kind, rho=rho, shard_remap=remap,
                       expected_step_time_factor=factor)


def plan_rescale_from_engine(
    engine,
    *,
    model_hosts: int = 1,
    old_world: Optional[int] = None,
    straggler_factor: Optional[float] = None,
    seed: int = 0,
) -> RescalePlan:
    """Rescale plan driven by a ``repro_torch.dynamics.ChurnEngine``'s live
    state.

    The engine's alive mask and per-node latency factors (its straggler
    view, updated by Straggler events) replace the hand-maintained
    ``HostState`` list: after replaying a churn trace, the surviving fleet
    and its current latency matrix feed directly into ``plan_rescale``.
    ``straggler_factor`` defaults to the engine's own demotion threshold so
    the plan agrees with the replay about who counts as a straggler."""
    if straggler_factor is None:
        straggler_factor = engine.straggler_factor
    return plan_rescale(engine.w, engine.host_states(),
                        model_hosts=model_hosts, old_world=old_world,
                        straggler_factor=straggler_factor, seed=seed)
