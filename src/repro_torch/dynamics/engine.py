"""Discrete-event churn engine over the incremental distance state (torch
port of ``repro.dynamics.engine``).

A :class:`ChurnEngine` replays a :class:`Trace` (timestamped Join / Leave /
Fail / LatencyDrift / Straggler events — see ``dynamics.scenarios``) against
an overlay maintained by an :class:`OverlayPolicy` (DGRO, Chord, RAPID or
Perigee rules) on top of
:class:`~repro_torch.dynamics.incremental.IncrementalDistances`, whose
distance matrix lives on the eval device (``batcheval.eval_device()``: CUDA
unless the caller asks for the CPU).  Everything else — the trace heap, the
policies' rings, the one numpy Generator — is host state, drawn from in the
reference's order, so a replay makes the reference's decisions draw for
draw.

Policies are thin adapters over the ``repro_torch.overlay`` builder
registry:
initial construction resolves through ``overlay.build(policy.builder, ...)``
(so the Chord / RAPID / Perigee construction rules live in exactly one
place), and only the *dynamic* rules — ring splices, stitch repairs,
join-time fingers / nearest-neighbour edges (via the registry's shared edge
helpers), and DGRO's periodic ``selection.adapt`` self-repair — live here.

Membership-plane wiring (the paper's application layer):

* **Fail -> Leave**: a crash is not actionable until SWIM detects and
  confirms it — ``detect_failures=True`` asks
  ``repro_torch.membership.gossip.confirmed_leave_time`` for the
  confirmation
  delay and schedules the Leave then; until confirmation the dead node is
  still routed through (the honest stale view).
* **Straggler demotion**: Straggler events inflate a node's latencies; the
  DGRO policy demotes nodes flagged by
  ``repro_torch.membership.elastic.detect_stragglers`` (treated as Leave for the
  overlay, exactly like the elastic layer's mesh rule).
* **DGRO self-repair**: after every ``adapt_every`` confirmed membership
  changes the DGRO policy runs ``repro_torch.core.selection.adapt`` over the live
  fleet's overlay; the winning ring's edges are applied as incremental
  relaxations, so the distance matrix never needs a from-scratch rebuild
  for repair.

Traces are plain data and replay deterministically: engine randomness comes
from one ``numpy`` Generator seeded at construction.

The routing probe (``route_probe > 0``, ``probe_stretch``) routes over an
exact APSP of the live block on the eval device through
``repro_torch.routing``; the cluster event kinds raise the reference's
``ValueError`` (they need ``repro_torch.hier.HierChurnEngine``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple

import numpy as np

from repro_torch import overlay as overlay_api
from repro_torch.core import selection
from repro_torch.core.construction import default_num_rings
from repro_torch.core.diameter import adjacency_from_edges, is_edge
from repro_torch.membership.elastic import HostState, detect_stragglers
from repro_torch.membership.gossip import SwimConfig, confirmed_leave_time
from repro_torch.obs import REGISTRY

from .incremental import IncrementalDistances
from .scenarios import EVENT_KINDS, Event, N_FABRIC_SITES, Trace

__all__ = [
    "TrajectorySample",
    "RunResult",
    "OverlayPolicy",
    "RingOverlayPolicy",
    "DGROPolicy",
    "ChordPolicy",
    "RapidPolicy",
    "PerigeePolicy",
    "POLICIES",
    "ChurnEngine",
]

Edge = Tuple[int, int]

# one series per trace event kind, shared by every engine in the process —
# scrapers diff before/after; children are pre-resolved so the per-event
# cost is one dict lookup + one guarded increment
_ENGINE_EVENTS = REGISTRY.counter(
    "repro_engine_events_total", "churn events applied, by kind",
    labels=("kind",))
_EVENT_KIND = {k: _ENGINE_EVENTS.labels(kind=k) for k in EVENT_KINDS}


@dataclasses.dataclass(frozen=True, eq=False)
class TrajectorySample:
    time: float
    event: str
    n_live: int
    diameter: float
    stretch: float = float("nan")    # routing-probe mean stretch (NaN = off)

    def __eq__(self, other):
        # NaN-tolerant: two replays with the probe off (stretch NaN) must
        # still compare equal sample-for-sample
        if not isinstance(other, TrajectorySample):
            return NotImplemented
        a, b = dataclasses.astuple(self), dataclasses.astuple(other)
        return all(x == y or (x != x and y != y) for x, y in zip(a, b))

    __hash__ = None


@dataclasses.dataclass
class RunResult:
    policy: str
    trace: str
    samples: List[TrajectorySample]
    final_diameter: float            # exact (post-refresh)
    stats: Dict[str, int]

    @property
    def mean_diameter(self) -> float:
        if not self.samples:           # run(record=False) keeps no samples
            return float("nan")
        return float(np.mean([s.diameter for s in self.samples]))

    @property
    def peak_diameter(self) -> float:
        if not self.samples:
            return float("nan")
        return float(np.max([s.diameter for s in self.samples]))

    @property
    def mean_stretch(self) -> float:
        """Mean over the probed samples' routing stretch (NaN when the run
        had ``route_probe=0`` or no probe ever delivered a pair)."""
        vals = [s.stretch for s in self.samples if np.isfinite(s.stretch)]
        return float(np.mean(vals)) if vals else float("nan")


# ---------------------------------------------------------------------------
# overlay policies
# ---------------------------------------------------------------------------

class OverlayPolicy:
    """How a protocol builds its overlay and reacts to membership changes.

    All node ids are *global* capacity-slot indices.  Policies only ever ADD
    edges between live nodes on join/repair — removals happen exclusively
    through tombstoning the departed node, which keeps every repair an exact
    incremental relaxation.
    """

    name = "base"
    demotes_stragglers = False

    def build(self, w: np.ndarray, live: np.ndarray,
              rng: np.random.Generator) -> List[Edge]:
        raise NotImplementedError

    def attach(self, w: np.ndarray, live: np.ndarray,
               rng: np.random.Generator, u: int) -> List[Edge]:
        raise NotImplementedError

    def detach(self, u: int, rng: np.random.Generator) -> List[Edge]:
        raise NotImplementedError

    def maybe_adapt(self, engine: "ChurnEngine") -> None:
        return None


class RingOverlayPolicy(OverlayPolicy):
    """Union-of-K-rings overlays with splice joins and stitch repairs.

    Construction is NOT implemented here: ``build()`` resolves ``builder``
    through the ``repro_torch.overlay`` registry over the live sub-fleet's
    latency block and adopts the resulting
    :class:`~repro_torch.overlay.Overlay`'s rings
    (re-indexed to global slot ids) and edge set.  The built overlay is kept
    on ``initial_overlay`` so traces can snapshot it (``to_json``).

    ``rings`` holds cyclic node-id lists.  A join splices the new node into
    each ring next to a chosen anchor ("random" position, or the "nearest"
    live ring member by latency); the anchor's old successor edge is kept —
    the overlay stays a supergraph of its rings, matching how neighbour
    tables grow before pruning.  A leave removes the node from each ring and
    stitches predecessor to successor.
    """

    name = "rings"
    builder = "rapid"                # registry name resolved by build()
    splice = "random"

    def __init__(self, k_rings: int | None = None):
        self.k_rings = k_rings
        self.rings: List[List[int]] = []
        self.initial_overlay = None

    def _build_config(self, n: int):
        """Registry config for a fresh build over ``n`` live nodes."""
        return overlay_api.RapidConfig(k=self.k_rings)

    def build(self, w, live, rng) -> List[Edge]:
        live = np.asarray(live)
        ov = overlay_api.build(self.builder, w[np.ix_(live, live)],
                               self._build_config(len(live)), rng=rng)
        self.initial_overlay = ov
        self.rings = [[int(live[i]) for i in ring] for ring in ov.rings]
        return [(int(live[a]), int(live[b])) for a, b in ov.edge_list()]

    def _splice(self, ring: List[int], w, rng, u: int) -> List[Edge]:
        if not ring:                 # fleet fully drained: joiner re-seeds it
            ring.append(u)
            return []
        if self.splice == "nearest":
            anchor = min(range(len(ring)), key=lambda i: w[u, ring[i]])
        else:
            anchor = int(rng.integers(len(ring)))
        succ = ring[(anchor + 1) % len(ring)]
        pred = ring[anchor]
        ring.insert(anchor + 1, u)
        return [(pred, u), (u, succ)]

    def attach(self, w, live, rng, u) -> List[Edge]:
        return [e for ring in self.rings for e in self._splice(ring, w, rng, u)]

    def detach(self, u, rng) -> List[Edge]:
        repairs: List[Edge] = []
        for ring in self.rings:
            if u not in ring:
                continue
            i = ring.index(u)
            pred, succ = ring[i - 1], ring[(i + 1) % len(ring)]
            ring.remove(u)
            if pred != succ and pred != u and succ != u:
                repairs.append((pred, succ))
        return repairs


class DGROPolicy(RingOverlayPolicy):
    """DGRO: rho-adaptive ring construction (the registry's ``"dgro"``
    builder), latency-aware splices, and periodic Algorithm-3 ring-selection
    repair applied as incremental relaxations."""

    name = "dgro"
    builder = "dgro"
    splice = "nearest"
    demotes_stragglers = True

    def __init__(self, k_rings: int | None = 2, adapt_every: int = 8):
        super().__init__(k_rings)
        self.adapt_every = adapt_every
        self._changes_since_adapt = 0
        self.adaptations = 0

    def _build_config(self, n: int):
        return overlay_api.DGROConfig(k=self.k_rings)

    def build(self, w, live, rng) -> List[Edge]:
        # reset adaptation state so a policy instance reused across engines
        # starts its cadence and stats fresh (build() already resets rings)
        self._changes_since_adapt = 0
        self.adaptations = 0
        return super().build(w, live, rng)

    def maybe_adapt(self, engine: "ChurnEngine") -> None:
        self._changes_since_adapt += 1
        if self._changes_since_adapt < self.adapt_every:
            return
        live = engine.inc.live_ids()
        if len(live) < 4:
            return                  # keep the pending count; adapt once viable
        self._changes_since_adapt = 0
        wl = engine.w[np.ix_(live, live)]
        adjl = engine.inc.adj[np.ix_(live, live)]
        seed = int(engine.rng.integers(2**31))
        # fold_weights: the engine keeps adj == w at edges, but external
        # callers may have added custom-weight links via inc.add_edge
        live_ov = overlay_api.Overlay.from_adjacency(wl, adjl, policy="dgro",
                                                     fold_weights=True)
        new_ov, kind, _rho = selection.adapt(live_ov, seed=seed)
        if kind == "keep":
            return
        self.adaptations += 1
        added = np.argwhere(np.triu(new_ov.adjacency < adjl, 1))
        for i, j in added:
            engine.inc.add_edge(int(live[i]), int(live[j]),
                                float(new_ov.adjacency[i, j]))


class ChordPolicy(RingOverlayPolicy):
    """Chord: one identifier-space ring plus power-of-two finger edges.

    Joins splice at a random identifier position and add the joiner's own
    fingers (``overlay.chord_finger_edges`` — the same rule the registry
    builder uses); other nodes' fingers are repaired lazily (dead targets
    vanish with the tombstone), which is how Chord's periodic fixups behave
    between stabilization rounds.
    """

    name = "chord"
    builder = "chord"
    splice = "random"

    def __init__(self):
        super().__init__(k_rings=1)

    def _build_config(self, n: int):
        return overlay_api.ChordConfig()

    def attach(self, w, live, rng, u) -> List[Edge]:
        edges = super().attach(w, live, rng, u)
        ring = self.rings[0]
        edges.extend(overlay_api.chord_finger_edges(ring, ring.index(u)))
        return edges


class RapidPolicy(RingOverlayPolicy):
    """RAPID: K independent consistent-hash (random) rings."""

    name = "rapid"
    builder = "rapid"
    splice = "random"

    def __init__(self, k_rings: int | None = None):
        super().__init__(k_rings)


class PerigeePolicy(RingOverlayPolicy):
    """Perigee: per-node d lowest-latency neighbours + one connectivity ring.

    Joins add the joiner's nearest-neighbour edges with the registry
    builder's own rule (``overlay.nearest_neighbour_edges``).
    """

    name = "perigee"
    builder = "perigee"
    splice = "random"

    def __init__(self, degree: int | None = None):
        super().__init__(k_rings=1)
        self.degree = degree

    def _build_config(self, n: int):
        return overlay_api.PerigeeConfig(degree=self.degree)

    def attach(self, w, live, rng, u) -> List[Edge]:
        edges = super().attach(w, live, rng, u)
        d = self.degree or default_num_rings(len(live))
        edges.extend(overlay_api.nearest_neighbour_edges(
            w, np.asarray(live), u, d))
        return edges


POLICIES = {
    "dgro": DGROPolicy,
    "chord": ChordPolicy,
    "rapid": RapidPolicy,
    "perigee": PerigeePolicy,
}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class ChurnEngine:
    """Replay a churn trace against a policy-maintained overlay."""

    def __init__(self, trace: Trace, policy: OverlayPolicy, *,
                 rebuild_threshold: int = 8, mode: str = "incremental",
                 detect_failures: bool = False,
                 swim: SwimConfig | None = None,
                 straggler_factor: float = 3.0, seed: int = 0,
                 route_probe: int = 0, route_pairs: int = 64,
                 route_policy: str = "latency"):
        self.trace = trace
        self.policy = policy
        self.rng = np.random.default_rng(seed)
        self.swim = swim or SwimConfig()
        self.detect_failures = detect_failures
        self.straggler_factor = straggler_factor
        # routing probe: every route_probe-th recorded sample also greedy-
        # routes route_pairs seeded uniform pairs over the live overlay and
        # records the mean stretch (0 = off; see probe_stretch())
        self.route_probe = int(route_probe)
        self.route_pairs = int(route_pairs)
        self.route_policy = route_policy

        self.w_base = trace.latency()
        c = trace.capacity
        self.latency_factor = np.ones(c, np.float32)   # straggler inflation
        self.drift_scale = np.ones(c, np.float32)      # per-node drift factor
        alive = np.zeros(c, bool)
        alive[:trace.n0] = True

        w = self.w_base.copy()
        adj = adjacency_from_edges(
            w, policy.build(w, np.flatnonzero(alive), self.rng))
        self.inc = IncrementalDistances(
            w, adj, alive, rebuild_threshold=rebuild_threshold, mode=mode)
        self._seq = 0
        self._ran = False
        self._pending_failed: set[int] = set()
        # scheduled-but-not-yet-due events (SWIM leave confirmations) for the
        # live-ingest path; run() keeps its own single heap
        self._pending: List[Tuple[float, int, Event]] = []
        self.clock = 0.0          # time of the last processed event
        self.events_processed = 0

    @classmethod
    def restore(cls, trace: Trace, policy: OverlayPolicy, *,
                w: np.ndarray, adj: np.ndarray, alive: np.ndarray,
                latency_factor: np.ndarray, drift_scale: np.ndarray,
                clock: float = 0.0, events_processed: int = 0,
                rebuild_threshold: int = 8, mode: str = "incremental",
                detect_failures: bool = False, swim: SwimConfig | None = None,
                straggler_factor: float = 3.0, seed: int = 0) -> "ChurnEngine":
        """Rebuild an engine from externally-snapshotted state (crash
        recovery; the reference's ``repro.service`` restores through it).

        The policy is adopted as-is — the caller must have restored its ring
        membership (``policy.rings``) to match ``adj`` — and the distance
        matrix is recomputed exactly from the restored adjacency, so a
        restored engine never inherits staleness from before the crash.
        Unconfirmed failures are NOT restored: a crash loses in-flight SWIM
        confirmations, and the victims simply fail again on re-detection
        (the honest outcome for a restarted observer).
        """
        eng = cls.__new__(cls)
        eng.trace = trace
        eng.policy = policy
        eng.rng = np.random.default_rng(seed)
        eng.swim = swim or SwimConfig()
        eng.detect_failures = detect_failures
        eng.straggler_factor = straggler_factor
        eng.w_base = trace.latency()
        c = trace.capacity
        assert np.asarray(w).shape == (c, c), (np.asarray(w).shape, c)
        eng.latency_factor = np.asarray(latency_factor, np.float32).copy()
        eng.drift_scale = np.asarray(drift_scale, np.float32).copy()
        eng.inc = IncrementalDistances(
            np.asarray(w, np.float32), np.asarray(adj, np.float32),
            np.asarray(alive, bool), rebuild_threshold=rebuild_threshold,
            mode=mode)
        eng._seq = 0
        eng._ran = False
        eng._pending_failed = set()
        eng._pending = []
        eng.clock = float(clock)
        eng.events_processed = int(events_processed)
        eng.route_probe = 0
        eng.route_pairs = 64
        eng.route_policy = "latency"
        return eng

    # -- conveniences -----------------------------------------------------

    @property
    def w(self) -> np.ndarray:
        return self.inc.w

    @property
    def alive(self) -> np.ndarray:
        return self.inc.alive

    def live_ids(self) -> np.ndarray:
        return self.inc.live_ids()

    @property
    def initial_overlay(self):
        """The :class:`~repro_torch.overlay.Overlay` the policy built at t=0 over
        the initial live fleet (local node indexing), or ``None`` for
        policies that bypass the registry.  ``to_json()`` it next to the
        trace to snapshot exactly what a replay started from."""
        return getattr(self.policy, "initial_overlay", None)

    def probe_stretch(self, n_pairs: int | None = None,
                      policy: str | None = None) -> float:
        """Greedy-route a seeded uniform pair batch over the LIVE overlay
        and return the mean routing stretch over delivered pairs.

        The probe is a read-only measurement: exact live-block APSP (never
        the maintenance lower bound — a probe must not charge the router
        for the engine's bounded staleness) through ``batcheval`` on the
        eval device (K1 squaring below 512 live nodes on the card, K2 + K1
        tiled from there), then ``repro_torch.routing``'s batched router
        over that device matrix, pairs seeded by ``events_processed`` so
        replays probe identical traffic.  NaN when fewer than 2 nodes are
        live or nothing was delivered.  ``policy="ring"`` routes on the
        policy's first ring (live members only); the default latency
        policy needs no ring embedding.
        """
        import torch

        from repro_torch import routing
        from repro_torch.core.batcheval import batched_apsp, eval_device

        n_pairs = self.route_pairs if n_pairs is None else int(n_pairs)
        policy = self.route_policy if policy is None else policy
        live = self.live_ids()
        m = len(live)
        if m < 2 or n_pairs < 1:
            return float("nan")
        adjl = np.asarray(self.inc.adj, np.float32)[np.ix_(live, live)]
        dist = batched_apsp(torch.from_numpy(adjl)[None].to(
            eval_device()))[0]
        ring = None
        if policy == "ring":
            pos = {int(g): i for i, g in enumerate(live)}
            rings = getattr(self.policy, "rings", None) or [[]]
            ring = np.asarray([pos[g] for g in rings[0] if g in pos],
                              np.int64)
            if ring.size < 2:
                return float("nan")
        res = routing.route_pairs(
            adjl, dist, routing.sample_pairs(
                m, n_pairs, "uniform", seed=self.events_processed),
            policy=policy, ring=ring, hop_budget=m)
        ok = res.success & np.isfinite(res.stretch)
        return float(res.stretch[ok].mean()) if ok.any() else float("nan")

    def host_states(self) -> List[HostState]:
        """Per-slot membership view for the elastic layer (``plan_rescale``):
        EWMA latency stands in for heartbeat RTT via the straggler factor."""
        return [HostState(i, alive=bool(self.alive[i]),
                          ewma_ms=float(self.latency_factor[i]))
                for i in range(self.inc.capacity)]

    # -- event handlers ---------------------------------------------------

    def _push(self, heap, t: float, event: Event) -> None:
        self._seq += 1
        heapq.heappush(heap, (t, self._seq, event))

    def _confirmed_leave(self, u: int) -> None:
        if not self.alive[u]:
            return
        repairs = self.policy.detach(u, self.rng)
        self.inc.leave(u)
        self._pending_failed.discard(u)
        for a, b in repairs:
            if self.alive[a] and self.alive[b]:
                self.inc.add_edge(a, b)
        self.policy.maybe_adapt(self)

    def _handle_join(self, u: int) -> None:
        if self.alive[u]:
            return
        live = self.live_ids()
        edges = self.policy.attach(self.w, live, self.rng, u)
        nbrs = set()
        for a, b in edges:
            if u not in (a, b):
                raise ValueError(
                    f"attach() must return edges incident to the joiner "
                    f"{u}; got {(a, b)}")
            nbrs.add(b if a == u else a)
        nbrs.discard(u)
        self.inc.join(u, sorted(nbrs))
        self.policy.maybe_adapt(self)

    def _handle_fail(self, heap, t: float, u: int) -> None:
        if not self.alive[u] or u in self._pending_failed:
            return
        if not self.detect_failures:
            self._confirmed_leave(u)
            return
        # crashed-but-unconfirmed peers cannot probe or relay: the SWIM
        # detection runs on the live view minus the other pending victims
        live = self.live_ids()
        obs = live[~np.isin(live, list(self._pending_failed))]
        pos = int(np.searchsorted(obs, u))
        t_conf = confirmed_leave_time(
            self.inc.adj[np.ix_(obs, obs)], pos, t_fail=t, cfg=self.swim,
            seed=int(self.rng.integers(2**31)))
        self._pending_failed.add(u)
        self._push(heap, t_conf, Event(time=t_conf, kind="leave", node=u))

    def _scaled_w(self) -> np.ndarray:
        f = self.latency_factor * self.drift_scale
        w = self.w_base * f[:, None] * f[None, :]
        np.fill_diagonal(w, 0.0)
        return w.astype(np.float32)

    def _handle_drift(self, factor: float, region: int) -> None:
        """Latency drift via per-NODE factors: each hit node gets the
        absolute factor ``sqrt(factor)``, and a link scales by the product
        of its endpoints' factors.  Globally (``region < 0``) every link
        scales by exactly ``factor``; for a regional event only the hit
        FABRIC site's intra-site links get the full ``factor`` while
        cross-site links get ``sqrt(factor)`` (one congested endpoint).
        Factors don't compound across events (each drift event overwrites
        the hit nodes' values) and persist through straggler rescales."""
        site_of = np.arange(self.inc.capacity) % N_FABRIC_SITES
        hit = site_of == region if region >= 0 else np.ones(
            self.inc.capacity, bool)
        self.drift_scale = np.where(
            hit, np.float32(np.sqrt(factor)), self.drift_scale)
        self.inc.apply_latency_matrix(self._scaled_w())

    def _handle_straggler(self, u: int, factor: float) -> None:
        self.latency_factor[u] *= np.float32(factor)
        # demote BEFORE re-weighting: detection only needs latency_factor,
        # and demoted nodes' inflated rows then never enter the rebuild
        if self.policy.demotes_stragglers:
            live_hosts = [h for h in self.host_states() if h.alive]
            for sid in detect_stragglers(live_hosts, self.straggler_factor):
                if self.inc.n_live > 3:
                    self._confirmed_leave(sid)
        new_w = self._scaled_w()
        self.inc.w = new_w                  # bulk latency bookkeeping
        if self.alive[u]:
            # only u's incident edges changed weight: route them through
            # set_latency (relax on decrease, bounded staleness on increase)
            # instead of a full apply_latency_matrix rebuild
            for v in np.flatnonzero(is_edge(self.inc.adj[u])):
                self.inc.set_latency(u, int(v), float(new_w[u, v]))
        # demoted: only the tombstoned node's rows changed — nothing to do

    # -- event dispatch (shared by run() replay and live ingest) ----------

    def _dispatch(self, heap, t: float, e: Event) -> None:
        """Apply one due event; SWIM leave confirmations scheduled by a fail
        go into ``heap`` (run()'s replay heap, or ``self._pending`` for the
        live-ingest path)."""
        if e.kind == "join":
            self._handle_join(e.node)
        elif e.kind == "leave":
            self._confirmed_leave(e.node)
        elif e.kind == "fail":
            self._handle_fail(heap, t, e.node)
        elif e.kind == "latency_drift":
            self._handle_drift(e.factor, e.region)
        elif e.kind == "straggler":
            self._handle_straggler(e.node, e.factor)
        elif e.kind in ("cluster_split", "cluster_merge"):
            raise ValueError(
                f"{e.kind} events need a hierarchical engine "
                f"(repro.hier.HierChurnEngine); the flat ChurnEngine has "
                f"no cluster structure to reorganize")
        else:
            raise ValueError(f"unknown event kind {e.kind!r}")
        _EVENT_KIND[e.kind].inc()
        self.clock = max(self.clock, t)
        self.events_processed += 1

    # -- live ingest (the control-plane path) ----------------------------

    def process(self, event: Event) -> int:
        """Apply one externally-arriving event NOW (the control-plane path:
        the event stream is open-ended, so there is no trace heap).

        Scheduled SWIM confirmations that came due strictly before
        ``event.time`` are drained first — identical ordering to run()'s
        single heap, where a trace event at the same timestamp pops before
        the later-pushed confirmation.  Returns the number of events applied
        (1 + drained confirmations).  Events must arrive in nondecreasing
        time order; a stale timestamp raises ``ValueError`` (the service
        maps it to HTTP 409).
        """
        if event.time < self.clock:
            raise ValueError(
                f"event at t={event.time} arrived after the clock advanced "
                f"to t={self.clock}; the control plane ingests events in "
                f"nondecreasing time order")
        n = self._drain_pending(event.time)
        self._dispatch(self._pending, event.time, event)
        return n + 1

    def flush(self, until: float = float("inf")) -> int:
        """Drain scheduled confirmations due at or before ``until`` (all of
        them by default).  Returns the number applied."""
        return self._drain_pending(until, strict=False)

    def _drain_pending(self, until: float, strict: bool = True) -> int:
        n = 0
        while self._pending and (self._pending[0][0] < until or
                                 (not strict and self._pending[0][0] <= until)):
            t, _, e = heapq.heappop(self._pending)
            self._dispatch(self._pending, t, e)
            n += 1
        return n

    @property
    def pending_confirmations(self) -> int:
        """Failures detected but not yet SWIM-confirmed (live-ingest path)."""
        return len(self._pending)

    # -- main loop --------------------------------------------------------

    def run(self, record: bool = True,
            sample_exact: bool = False) -> RunResult:
        """Replay the trace.  ``sample_exact`` refreshes pending deletions
        before every recorded sample so trajectories report true diameters
        rather than the maintenance lower bound — use it when comparing
        policies (the sampling rebuilds then also land in stats)."""
        if self._ran:
            raise RuntimeError(
                "ChurnEngine.run() consumed its trace against mutated state; "
                "construct a fresh engine to replay")
        self._ran = True
        heap: List[Tuple[float, int, Event]] = []
        for e in sorted(self.trace.events, key=lambda e: e.time):
            self._push(heap, e.time, e)
        samples: List[TrajectorySample] = []
        probe = (lambda: self.probe_stretch()) if self.route_probe else \
            (lambda: float("nan"))
        if record:
            samples.append(TrajectorySample(
                0.0, "init", self.inc.n_live,
                self.inc.diameter(exact=sample_exact), probe()))
        while heap:
            t, _, e = heapq.heappop(heap)
            self._dispatch(heap, t, e)
            if record:
                due = (self.route_probe
                       and self.events_processed % self.route_probe == 0)
                samples.append(TrajectorySample(
                    t, e.kind, self.inc.n_live,
                    self.inc.diameter(exact=sample_exact),
                    probe() if due else float("nan")))
        stats = dict(self.inc.stats)     # churn cost only: snapshot before
        final = self.inc.diameter(exact=True)  # ... the exactness refresh
        if isinstance(self.policy, DGROPolicy):
            stats["adaptations"] = self.policy.adaptations
        return RunResult(policy=self.policy.name, trace=self.trace.name,
                         samples=samples, final_diameter=final, stats=stats)
