"""Churn maintenance for hierarchical overlays (torch port of
``repro.hier.engine``).

:class:`HierChurnEngine` is the two-level counterpart of
:class:`repro_torch.dynamics.engine.ChurnEngine`: node-level events (join /
leave / fail / latency_drift / straggler) dispatch to the OWNING cluster's
:class:`~repro_torch.dynamics.incremental.IncrementalDistances` state —
cluster-local O(P^2) repairs instead of global O(N^2) — and the head ring
is only touched when a head dies (re-election), a cluster drains or
revives, or a ``cluster_split`` / ``cluster_merge`` event reorganizes the
partition.  Every capacity slot is pre-assigned to a cluster at
construction (the assignment covers the FULL trace capacity), so a join
needs no global work: it splices into its home cluster's live members.

Bound semantics match the flat engine's contract: each maintained
distance matrix (per cluster, and the head graph) is exact or an
elementwise LOWER bound between deletion-triggered rebuilds, and the
composed :meth:`diameter` is therefore itself exact-or-lower —
``diameter(exact=True)`` refreshes every level first.

Deliberate simplifications vs the flat engine (documented, not hidden):
failures are applied as immediate confirmed leaves (no SWIM confirmation
delay at the hierarchy level, so :attr:`pending_confirmations` is always
0), and straggler events re-weight the victim's links without the elastic
demotion pass.

Every cluster's distance matrix (and the head graph's) lives on the eval
device (``batcheval.eval_device()`` when its state is made: CUDA unless the
caller asks for the CPU); a boot or a rebuild below 512 slots squares it
with K1 on the card.  Reads copy only the entries, rows or columns they
use back to the host (``IncrementalDistances.distances_at``).

Observability: the engine keeps the pre-registered ``repro_hier_clusters``
and ``repro_hier_headring_diameter`` gauges (``repro_torch.obs``) current, and
counts every applied event in ``repro_engine_events_total{kind}`` — the
same series the flat engine uses, now covering the cluster kinds too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.construction import default_num_rings, k_rings
from repro_torch.core.diameter import (INF, adjacency_from_edges, is_edge,
                                       ring_edges)
from repro_torch.dynamics.engine import RunResult, TrajectorySample
from repro_torch.dynamics.incremental import IncrementalDistances
from repro_torch.dynamics.scenarios import (EVENT_KINDS, Event,
                                            N_FABRIC_SITES, Trace)
from repro_torch.obs import (HIER_CLUSTERS, HIER_HEADRING_DIAMETER,
                             HIER_ROUTE_HOPS, REGISTRY)
from repro_torch.routing.greedy import route_single_host
from repro_torch.routing.metrics import ROUTE_REQUESTS

from .core import HierConfig, default_cluster_size, assign_latency_clusters
from .geo import DenseLatency, LatencyModel, as_latency

__all__ = ["HierChurnEngine"]

_HALF_INF = float(INF) / 2

# same process-global series as the flat engine (idempotent re-register)
_EVENT_KIND = {
    k: REGISTRY.counter("repro_engine_events_total",
                        "churn events applied, by kind",
                        labels=("kind",)).labels(kind=k)
    for k in EVENT_KINDS}


@dataclasses.dataclass
class _ClusterState:
    """One cluster's maintained state: its capacity slots (sorted global
    ids, fixed between reorgs) and the incremental APSP over them."""

    slots: np.ndarray              # sorted global slot ids
    inc: IncrementalDistances      # local (slots.size,) indexing
    head: int                      # global id of the head, -1 if drained

    @property
    def live_slots(self) -> np.ndarray:
        return self.slots[self.inc.alive]

    @property
    def head_local(self) -> int:
        return int(np.searchsorted(self.slots, self.head))


class HierChurnEngine:
    """Replay/ingest churn against a cluster-partitioned overlay."""

    def __init__(self, trace: Trace, cfg: Optional[HierConfig] = None, *,
                 lat: Optional[LatencyModel] = None,
                 rebuild_threshold: int = 8, seed: int = 0):
        """``lat`` overrides ``trace.latency()`` with a lazy latency model
        (required above N ~ 10^4, where the dense matrix stops fitting)."""
        self.trace = trace
        self.cfg = cfg or HierConfig()
        self.rng = np.random.default_rng(seed)
        self.rebuild_threshold = int(rebuild_threshold)
        self.lat = as_latency(lat) if lat is not None \
            else DenseLatency(trace.latency())
        c = trace.capacity
        if self.lat.n != c:
            raise ValueError(f"latency model covers {self.lat.n} slots but "
                             f"the trace has capacity {c}")
        self.latency_factor = np.ones(c, np.float32)
        self.drift_scale = np.ones(c, np.float32)
        alive = np.zeros(c, bool)
        alive[:trace.n0] = True

        target = self.cfg.cluster_size or default_cluster_size(c)
        # pre-assign EVERY capacity slot (dead ones too): a later join
        # already knows its home cluster
        self._slot_cluster = assign_latency_clusters(
            self.lat, target, self.rng).astype(np.int64)
        self._next_cluster = int(self._slot_cluster.max()) + 1
        self.states: Dict[int, _ClusterState] = {}
        for cid in range(self._next_cluster):
            slots = np.flatnonzero(self._slot_cluster == cid)
            self._adopt(cid, self._make_state(slots, alive[slots]))
        self.head_inc: IncrementalDistances = None  # type: ignore
        self._rebuild_head_graph()

        self.reorg_stats = {"splits": 0, "merges": 0, "head_rebuilds": 0}
        self._ran = False
        self.clock = 0.0
        self.events_processed = 0
        self.inc = _HierIncView(self)      # flat-engine-shaped facade

    # -- construction helpers ---------------------------------------------

    def _scaled_block(self, slots: np.ndarray) -> np.ndarray:
        f = (self.latency_factor * self.drift_scale)[slots]
        w = self.lat.block(slots, slots) * f[:, None] * f[None, :]
        np.fill_diagonal(w, 0.0)
        return w.astype(np.float32)

    def _make_state(self, slots: np.ndarray,
                    alive: np.ndarray) -> _ClusterState:
        """Fresh cluster state: nearest rings over the LIVE members, dead
        pre-assigned slots kept as tombstoned capacity."""
        slots = np.asarray(slots, np.intp)
        alive = np.asarray(alive, bool)
        w = self._scaled_block(slots)
        live_local = np.flatnonzero(alive)
        edges = np.zeros((0, 2), np.intp)
        if live_local.size >= 2:
            wl = w[np.ix_(live_local, live_local)]
            k = min(live_local.size - 1,
                    default_num_rings(live_local.size)) or 1
            perms = k_rings(wl, k, "nearest", rng=self.rng)
            edges = live_local[np.concatenate(
                [ring_edges(p) for p in perms], axis=0)]
        inc = IncrementalDistances(w, adjacency_from_edges(w, edges), alive,
                                   rebuild_threshold=self.rebuild_threshold)
        head = int(slots[live_local[np.argmin(
            w[np.ix_(live_local, live_local)].sum(axis=1))]]) \
            if live_local.size else -1
        return _ClusterState(slots=slots, inc=inc, head=head)

    def _adopt(self, cid: int, state: _ClusterState) -> None:
        self.states[cid] = state
        self._slot_cluster[state.slots] = cid

    def _rebuild_head_graph(
            self, edges: Optional[np.ndarray] = None) -> None:
        """Rebuild the ring over cluster heads (cluster-id node space).

        Cheap by design — the head graph has one node per cluster — so any
        head-set change (death, drain, revive, split, merge) just rebuilds
        it exactly rather than patching it incrementally.  ``edges``
        overrides the freshly-built nearest rings with an explicit
        cluster-id edge list (snapshot restore).
        """
        cap = self._next_cluster
        active = sorted(c for c, s in self.states.items() if s.head >= 0)
        heads = np.array([self.states[c].head for c in active], np.intp)
        w = np.full((cap, cap), float(INF), np.float32)
        np.fill_diagonal(w, 0.0)
        alive = np.zeros(cap, bool)
        if len(active) >= 1:
            act = np.asarray(active, np.intp)
            alive[act] = True
            f = (self.latency_factor * self.drift_scale)[heads]
            wh = (self.lat.block(heads, heads)
                  * f[:, None] * f[None, :]).astype(np.float32)
            np.fill_diagonal(wh, 0.0)
            w[np.ix_(act, act)] = wh
            if edges is None:
                edges = np.zeros((0, 2), np.intp)
                if len(active) >= 2:
                    k = min(len(active) - 1,
                            default_num_rings(len(active))) or 1
                    perms = k_rings(wh, k, "nearest", rng=self.rng)
                    edges = act[np.concatenate(
                        [ring_edges(p) for p in perms], axis=0)]
        else:
            edges = np.zeros((0, 2), np.intp)
        self.head_inc = IncrementalDistances(
            w, adjacency_from_edges(w, edges), alive,
            rebuild_threshold=self.rebuild_threshold)
        if hasattr(self, "reorg_stats"):
            self.reorg_stats["head_rebuilds"] += 1
        HIER_CLUSTERS.set(float(len(active)))
        HIER_HEADRING_DIAMETER.set(
            float(self.head_inc.diameter()) if len(active) > 1 else 0.0)

    # -- restore (repro_torch.service snapshots) --------------------------

    @classmethod
    def restore(cls, trace: Trace, cfg: Optional[HierConfig] = None, *,
                slot_cluster: np.ndarray, alive: np.ndarray,
                edges: np.ndarray, heads: Dict[int, int],
                latency_factor: np.ndarray, drift_scale: np.ndarray,
                lat: Optional[LatencyModel] = None,
                clock: float = 0.0, events_processed: int = 0,
                rebuild_threshold: int = 8, seed: int = 0
                ) -> "HierChurnEngine":
        """Rebuild an engine from snapshotted state: the slot->cluster map,
        the live mask, the GLOBAL intra-cluster edge list, and each
        cluster's head.  Distances are recomputed exactly from the restored
        adjacency (no staleness survives a restore); the head ring is
        rebuilt over the restored heads."""
        eng = cls.__new__(cls)
        eng.trace = trace
        eng.cfg = cfg or HierConfig()
        eng.rng = np.random.default_rng(seed)
        eng.rebuild_threshold = int(rebuild_threshold)
        eng.lat = as_latency(lat) if lat is not None \
            else DenseLatency(trace.latency())
        eng.latency_factor = np.asarray(latency_factor, np.float32).copy()
        eng.drift_scale = np.asarray(drift_scale, np.float32).copy()
        eng._slot_cluster = np.asarray(slot_cluster, np.int64).copy()
        eng._next_cluster = int(eng._slot_cluster.max()) + 1
        alive = np.asarray(alive, bool)
        edges = np.asarray(edges, np.intp).reshape(-1, 2)
        eng.states = {}
        for cid in sorted(set(int(c) for c in eng._slot_cluster if c >= 0)):
            slots = np.flatnonzero(eng._slot_cluster == cid)
            w = eng._scaled_block(slots)
            mine = edges[(eng._slot_cluster[edges[:, 0]] == cid)
                         & (eng._slot_cluster[edges[:, 1]] == cid)]
            local = np.searchsorted(slots, mine)
            inc = IncrementalDistances(
                w, adjacency_from_edges(w, local), alive[slots],
                rebuild_threshold=eng.rebuild_threshold)
            eng.states[cid] = _ClusterState(
                slots=slots, inc=inc, head=int(heads.get(cid, -1)))
        eng.head_inc = None  # type: ignore
        eng.reorg_stats = {"splits": 0, "merges": 0, "head_rebuilds": 0}
        # cross-cluster edges in the snapshot ARE the head ring (including
        # any reopt-added head edges): restore them verbatim
        cross = edges[eng._slot_cluster[edges[:, 0]]
                      != eng._slot_cluster[edges[:, 1]]]
        eng._rebuild_head_graph(
            edges=eng._slot_cluster[cross].astype(np.intp)
            if cross.size else None)
        eng.reorg_stats["head_rebuilds"] = 0
        eng._ran = False
        eng.clock = float(clock)
        eng.events_processed = int(events_processed)
        eng.inc = _HierIncView(eng)
        return eng

    # -- conveniences -----------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.trace.capacity

    @property
    def alive(self) -> np.ndarray:
        out = np.zeros(self.capacity, bool)
        for s in self.states.values():
            out[s.live_slots] = True
        return out

    def live_ids(self) -> np.ndarray:
        return np.flatnonzero(self.alive)

    @property
    def n_live(self) -> int:
        return sum(s.inc.n_live for s in self.states.values())

    @property
    def n_clusters(self) -> int:
        """Active (non-drained) clusters."""
        return sum(1 for s in self.states.values() if s.head >= 0)

    @property
    def pending_confirmations(self) -> int:
        """Always 0: hierarchy-level failures apply as immediate confirmed
        leaves (no SWIM confirmation delay — documented simplification)."""
        return 0

    def cluster_of(self, u: int) -> int:
        return int(self._slot_cluster[int(u)])

    def edge_list(self) -> np.ndarray:
        """(E, 2) unique live GLOBAL edges: cluster-local plus head-ring
        edges (head-ring edges mapped through each cluster's head)."""
        parts = []
        for s in self.states.values():
            mask = np.asarray(is_edge(s.inc.adj))
            e = np.argwhere(np.triu(mask, 1))
            if e.size:
                parts.append(s.slots[e])
        hmask = np.asarray(is_edge(self.head_inc.adj))
        he = np.argwhere(np.triu(hmask, 1))
        if he.size:
            head_of = np.full(self._next_cluster, -1, np.intp)
            for cid, s in self.states.items():
                head_of[cid] = s.head
            parts.append(head_of[he])
        if not parts:
            return np.zeros((0, 2), np.intp)
        e = np.sort(np.concatenate(parts, axis=0), axis=1)
        return np.unique(e, axis=0)

    def weighted_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(edges, weights): :meth:`edge_list` plus each edge's CURRENT
        maintained weight (cluster adjacency for intra edges, head-graph
        adjacency for head-ring edges)."""
        edges = self.edge_list()
        wts = np.empty(edges.shape[0], np.float32)
        for i, (u, v) in enumerate(edges):
            a, b = self.cluster_of(int(u)), self.cluster_of(int(v))
            if a == b:
                s = self.states[a]
                lu = int(np.searchsorted(s.slots, u))
                lv = int(np.searchsorted(s.slots, v))
                wts[i] = s.inc.adj[lu, lv]
            else:
                wts[i] = self.head_inc.adj[a, b]
        return edges, wts

    def distance_bound(self, u: int, v: int) -> Tuple[float, str]:
        """Maintained hierarchical distance and its staleness stamp:
        ``"exact"`` when no deletions are pending anywhere, else a provable
        ``"lower"`` bound (same contract the flat service serves)."""
        u, v = int(u), int(v)
        a, b = self.cluster_of(u), self.cluster_of(v)
        sa, sb = self.states[a], self.states[b]
        lu = int(np.searchsorted(sa.slots, u))
        lv = int(np.searchsorted(sb.slots, v))
        stamp = "exact" if self.pending_deletions == 0 else "lower"
        if a == b:
            return float(sa.inc.distances_at(lu, lv)), stamp
        d = (float(sa.inc.distances_at(lu, sa.head_local))
             + float(self.head_inc.distances_at(a, b))
             + float(sb.inc.distances_at(sb.head_local, lv)))
        return d, stamp

    def stats(self) -> Dict[str, int]:
        """Aggregated maintenance counters over every level, plus the
        reorganization counts."""
        agg = {"relaxations": 0, "joins": 0, "leaves": 0, "rebuilds": 0,
               "events": 0}
        for s in self.states.values():
            for k in agg:
                agg[k] += s.inc.stats[k]
        for k in agg:
            agg[k] += self.head_inc.stats[k]
        agg.update(self.reorg_stats)
        return agg

    @property
    def pending_deletions(self) -> int:
        return (sum(s.inc.pending_deletions for s in self.states.values())
                + self.head_inc.pending_deletions)

    # -- diameter (composed, exact-or-lower) ------------------------------

    def refresh(self) -> None:
        for s in self.states.values():
            s.inc.refresh()
        self.head_inc.refresh()

    def diameter(self, exact: bool = False) -> float:
        """Composed hierarchical diameter over the LIVE fleet.

        ``max(max_c diam_c, max_{a != b} ecc_a + D_head(a, b) + ecc_b)``
        from the maintained matrices: exact when nothing is stale at any
        level, otherwise a lower bound (monotone composition of
        elementwise lower bounds).  ``exact=True`` refreshes first.
        """
        if exact:
            self.refresh()
        active = [c for c, s in self.states.items()
                  if s.head >= 0 and s.inc.n_live > 0]
        if not active:
            return 0.0
        intra = 0.0
        ecc = {}
        for c in active:
            s = self.states[c]
            intra = max(intra, s.inc.diameter())
            row = s.inc.distances_at(s.head_local)[s.inc.alive]
            row = row[row < _HALF_INF]
            ecc[c] = float(row.max()) if row.size else 0.0
        if len(active) < 2:
            return float(intra)
        dh = self.head_inc.distances
        best = intra
        for i, a in enumerate(active):
            for b in active[i + 1:]:
                d = float(dh[a, b])
                if d < _HALF_INF:
                    best = max(best, ecc[a] + d + ecc[b])
        return float(best)

    # -- event handlers ---------------------------------------------------

    def _elect_head(self, cid: int) -> None:
        """Re-elect ``cid``'s head (min summed latency over live members)
        and rebuild the head ring."""
        s = self.states[cid]
        live = np.flatnonzero(s.inc.alive)
        if live.size == 0:
            s.head = -1
        else:
            wl = s.inc.w[np.ix_(live, live)]
            s.head = int(s.slots[live[np.argmin(wl.sum(axis=1))]])
        self._rebuild_head_graph()

    def _handle_join(self, u: int) -> None:
        cid = self.cluster_of(u)
        s = self.states[cid]
        local = int(np.searchsorted(s.slots, u))
        if s.inc.alive[local]:
            return
        live = np.flatnonzero(s.inc.alive)
        if live.size:
            k = min(live.size, default_num_rings(max(s.inc.n_live + 1, 2)))
            order = np.argsort(s.inc.w[local, live], kind="stable")[:k]
            s.inc.join(local, sorted(int(live[i]) for i in order))
        else:
            s.inc.join(local, [])
        if s.head < 0:                 # revived a drained cluster
            self._elect_head(cid)

    def _handle_leave(self, u: int) -> None:
        cid = self.cluster_of(u)
        s = self.states[cid]
        local = int(np.searchsorted(s.slots, u))
        if not s.inc.alive[local]:
            return
        was_head = s.head == u
        nbrs = np.flatnonzero(is_edge(s.inc.adj[local]))
        s.inc.leave(local)
        # stitch: reconnect the departed node's neighbours pairwise so the
        # cluster stays connected (same repair shape as the flat policies)
        nbrs = [int(v) for v in nbrs if s.inc.alive[v]]
        for a, b in zip(nbrs, nbrs[1:]):
            s.inc.add_edge(a, b)
        if was_head or s.inc.n_live == 0:
            self._elect_head(cid)

    def _handle_drift(self, factor: float, region: int) -> None:
        """Same per-node drift semantics as the flat engine (FABRIC site =
        slot id mod ``N_FABRIC_SITES``), applied only to the clusters that
        actually contain affected nodes."""
        site_of = np.arange(self.capacity) % N_FABRIC_SITES
        hit = site_of == region if region >= 0 else np.ones(
            self.capacity, bool)
        self.drift_scale = np.where(
            hit, np.float32(np.sqrt(factor)), self.drift_scale)
        for cid, s in self.states.items():
            if hit[s.slots].any():
                s.inc.apply_latency_matrix(self._scaled_block(s.slots))
        self._rebuild_head_graph()     # head-pair latencies moved too

    def _handle_straggler(self, u: int, factor: float) -> None:
        self.latency_factor[u] *= np.float32(factor)
        cid = self.cluster_of(u)
        s = self.states[cid]
        new_w = self._scaled_block(s.slots)
        s.inc.w = new_w.copy()
        local = int(np.searchsorted(s.slots, u))
        if s.inc.alive[local]:
            for v in np.flatnonzero(is_edge(s.inc.adj[local])):
                s.inc.set_latency(local, int(v), float(new_w[local, v]))
        if s.head == u:
            self._rebuild_head_graph()   # the head's uplink latencies moved

    def _handle_split(self, cid: int) -> None:
        """Split cluster ``cid`` by its farthest live pair (2-medoid): each
        live member follows the nearer pole; pre-assigned dead slots stay
        with ``cid``.  No-op (but counted) below 4 live members."""
        if cid not in self.states:
            raise ValueError(f"cluster_split of unknown cluster {cid}")
        s = self.states[cid]
        live = np.flatnonzero(s.inc.alive)
        if live.size < 4:
            return
        wl = s.inc.w[np.ix_(live, live)]
        a = int(np.argmax(wl.sum(axis=1)))
        b = int(np.argmax(wl[a]))
        to_b = wl[b] < wl[a]
        if not to_b.any() or to_b.all():
            return
        keep_slots = np.sort(np.concatenate(
            [s.slots[~s.inc.alive], s.slots[live[~to_b]]]))
        move_slots = np.sort(s.slots[live[to_b]])
        alive_mask = self.alive
        new_cid = self._next_cluster
        self._next_cluster += 1
        self._adopt(cid, self._make_state(keep_slots, alive_mask[keep_slots]))
        self._adopt(new_cid,
                    self._make_state(move_slots, alive_mask[move_slots]))
        self.reorg_stats["splits"] += 1
        self._rebuild_head_graph()

    def _handle_merge(self, cid: int, peer: int) -> None:
        """Absorb cluster ``peer`` into ``cid``: union the slot sets,
        rebuild one cluster state, retire ``peer``'s id."""
        if cid not in self.states or peer not in self.states:
            raise ValueError(
                f"cluster_merge of unknown cluster pair ({cid}, {peer}); "
                f"known clusters: {sorted(self.states)}")
        if cid == peer:
            raise ValueError(f"cluster_merge needs distinct clusters, "
                             f"got {cid} twice")
        union = np.sort(np.concatenate(
            [self.states[cid].slots, self.states[peer].slots]))
        alive_mask = self.alive
        del self.states[peer]
        self._adopt(cid, self._make_state(union, alive_mask[union]))
        self.reorg_stats["merges"] += 1
        self._rebuild_head_graph()

    # -- dispatch / ingest (flat-engine-compatible surface) ---------------

    def _dispatch(self, t: float, e: Event) -> None:
        if e.kind == "join":
            self._handle_join(e.node)
        elif e.kind in ("leave", "fail"):
            # fail == immediate confirmed leave (no SWIM delay at this level)
            self._handle_leave(e.node)
        elif e.kind == "latency_drift":
            self._handle_drift(e.factor, e.region)
        elif e.kind == "straggler":
            self._handle_straggler(e.node, e.factor)
        elif e.kind == "cluster_split":
            self._handle_split(e.node)
        elif e.kind == "cluster_merge":
            self._handle_merge(e.node, e.peer)
        else:
            raise ValueError(f"unknown event kind {e.kind!r}")
        _EVENT_KIND[e.kind].inc()
        self.clock = max(self.clock, t)
        self.events_processed += 1

    def process(self, event: Event) -> int:
        """Apply one externally-arriving event NOW (control-plane path).
        Events must arrive in nondecreasing time order, matching the flat
        engine's ingest contract."""
        if event.time < self.clock:
            raise ValueError(
                f"event at t={event.time} arrived after the clock advanced "
                f"to t={self.clock}; the control plane ingests events in "
                f"nondecreasing time order")
        self._dispatch(event.time, event)
        return 1

    def flush(self, until: float = float("inf")) -> int:
        """Nothing is ever scheduled (failures confirm immediately)."""
        return 0

    def run(self, record: bool = True,
            sample_exact: bool = False) -> RunResult:
        """Replay the trace, sampling the composed diameter per event."""
        if self._ran:
            raise RuntimeError(
                "HierChurnEngine.run() consumed its trace against mutated "
                "state; construct a fresh engine to replay")
        self._ran = True
        samples: List[TrajectorySample] = []
        if record:
            samples.append(TrajectorySample(
                0.0, "init", self.n_live, self.diameter(exact=sample_exact)))
        for e in sorted(self.trace.events, key=lambda e: e.time):
            self._dispatch(e.time, e)
            if record:
                samples.append(TrajectorySample(
                    e.time, e.kind, self.n_live,
                    self.diameter(exact=sample_exact)))
        final = self.diameter(exact=True)
        return RunResult(policy="dgro-hier", trace=self.trace.name,
                         samples=samples, final_diameter=final,
                         stats=self.stats())

    # -- routing (repro_torch.service /v1/route) --------------------------

    def route(self, src: int, dst: int, *, policy: str = "latency",
              hop_budget: Optional[int] = None
              ) -> Tuple[List[int], float, Dict[str, int], str]:
        """Three-leg host route over the MAINTAINED state (same exact-or-
        lower-bound keys the flat service serves).  Returns ``(global
        path, latency, hops_by_level, outcome)``."""
        src, dst = int(src), int(dst)
        a, b = self.cluster_of(src), self.cluster_of(dst)
        sa, sb = self.states[a], self.states[b]
        legs: List[Tuple[str, IncrementalDistances, int, int, np.ndarray]]
        if a == b:
            legs = [("local", sa.inc, int(np.searchsorted(sa.slots, src)),
                     int(np.searchsorted(sa.slots, dst)), sa.slots)]
        else:
            head_of = np.full(self._next_cluster, -1, np.intp)
            for cid, s in self.states.items():
                head_of[cid] = s.head
            legs = [
                ("local", sa.inc, int(np.searchsorted(sa.slots, src)),
                 sa.head_local, sa.slots),
                ("head", self.head_inc, a, b, head_of),
                ("local", sb.inc, sb.head_local,
                 int(np.searchsorted(sb.slots, dst)), sb.slots),
            ]
        path: List[int] = []
        lat = 0.0
        hops = {"local": 0, "head": 0}
        outcome = "delivered"
        for level, inc, s, d, to_global in legs:
            leg_path, leg_lat, leg_hops, outcome = route_single_host(
                inc.adj, inc.distances_at(slice(None), d), s, d,
                policy=policy, hop_budget=hop_budget)
            glob = [int(to_global[u]) for u in leg_path]
            path.extend(glob if not path else glob[1:])
            lat += leg_lat
            hops[level] += leg_hops
            if outcome != "delivered":
                break
        ROUTE_REQUESTS.labels(policy=f"hier-{policy}",
                              outcome=outcome).inc()
        if outcome == "delivered":
            HIER_ROUTE_HOPS.labels(level="local").observe(hops["local"])
            if hops["head"]:
                HIER_ROUTE_HOPS.labels(level="head").observe(hops["head"])
        return path, float(lat), hops, outcome


class _HierIncView:
    """Flat-engine-shaped read facade (``engine.inc``) so the service's
    staleness/liveness gauges and stats bind to either engine unchanged."""

    def __init__(self, eng: HierChurnEngine):
        self._eng = eng

    @property
    def pending_deletions(self) -> int:
        return self._eng.pending_deletions

    @property
    def n_live(self) -> int:
        return self._eng.n_live

    @property
    def capacity(self) -> int:
        return self._eng.capacity

    def live_ids(self) -> np.ndarray:
        return self._eng.live_ids()

    @property
    def stats(self) -> Dict[str, int]:
        return self._eng.stats()

    def diameter(self, exact: bool = False) -> float:
        return self._eng.diameter(exact=exact)

    def refresh(self) -> None:
        self._eng.refresh()
