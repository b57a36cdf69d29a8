"""The control plane's live state: one lock, one engine, one served Overlay
(torch port of ``repro.service.state``).

:class:`ServiceState` owns

* a :class:`~repro_torch.dynamics.engine.ChurnEngine` ingesting Trace-format
  events through the live
  :meth:`~repro_torch.dynamics.engine.ChurnEngine.process`
  path (SWIM-confirmed failures, splice joins, tombstoned leaves — exactly
  the replay semantics, fed one event at a time);
* the **served Overlay** — a lazily-rebuilt, immutable
  :class:`~repro_torch.overlay.Overlay` snapshot of the live sub-fleet.  The
  async re-optimizer computes its candidate on a *frozen copy* (the second
  buffer) and :meth:`commit_reopt` swaps the result in under the lock in
  O(ring) relaxations — queries never wait on the optimization itself;
* the snapshot cadence for crash recovery
  (``repro_torch.service.snapshots``).

The engine's distance state lives on one device, CUDA unless the state was
made with ``device="cpu"``.  ``batcheval.eval_options`` is thread-local,
and the HTTP handler threads and the re-optimizer's thread do not see the
options of the thread that made the state, so the state holds its device
(:attr:`ServiceState.device`, read off the engine) and every method it
serves runs under ``eval_options(device=state.device)``.

Staleness contract (inherited from ``dynamics.incremental``): between
deletion-triggered rebuilds the distance matrix is an elementwise LOWER
bound on the live truth, so every distance the API serves is either exact
(``pending_deletions == 0``) or a provable lower bound — never an
overestimate.  ``/v1/stats`` exposes which.

Locking: one ``RLock`` over engine mutations and reads.  Every query is
O(C) – O(C^2) host work plus at most a row or column of the device's
distance matrix copied back; the only expensive operations are the explicit
``exact=True`` diameter refresh and the re-optimizer's candidate scoring,
which runs outside the lock by design.
"""
from __future__ import annotations

import dataclasses
import functools
import time as _time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import serde
from repro_torch.core import batcheval
from repro_torch.core.diameter import INF, is_edge
from repro_torch.dynamics.engine import POLICIES, ChurnEngine
from repro_torch.dynamics.scenarios import Event, Trace
from repro_torch.obs import REGISTRY, TimedRLock, get_logger, kv, span
from repro_torch.overlay import Overlay

from . import snapshots as snaps

__all__ = ["ServiceState", "ReoptJob"]

_log = get_logger(__name__)

# -- instruments (process-global; registration is idempotent) ---------------
_EVENTS = REGISTRY.counter(
    "repro_service_events_ingested_total",
    "events accepted through ServiceState.ingest (POST /v1/events)")
_INGEST_BATCHES = REGISTRY.counter(
    "repro_service_ingest_batches_total", "ingest calls (event batches)")
_QUERIES = REGISTRY.counter(
    "repro_service_queries_total",
    "state queries served, by endpoint kind and staleness bound",
    labels=("kind", "bound"))
_SNAPSHOTS = REGISTRY.counter(
    "repro_service_snapshots_total", "committed snapshots, by reason",
    labels=("reason",))
_REOPT_EDGES = REGISTRY.counter(
    "repro_service_reopt_edges_applied_total",
    "re-optimization edges landed as incremental relaxations")

_STALE_GAUGE = REGISTRY.gauge(
    "repro_service_stale_entries",
    "pending tombstoned deletions (distance matrix is a lower bound when > 0)")
_VERSION_GAUGE = REGISTRY.gauge(
    "repro_service_overlay_version", "served overlay swap generation")
_NLIVE_GAUGE = REGISTRY.gauge(
    "repro_service_n_live", "live nodes in the served fleet")
_PENDING_CONF_GAUGE = REGISTRY.gauge(
    "repro_service_pending_confirmations",
    "failures detected but not yet SWIM-confirmed")
_SNAP_AGE_GAUGE = REGISTRY.gauge(
    "repro_service_snapshot_age_seconds",
    "monotonic seconds since the last committed snapshot (-1 before any)")
_UPTIME_GAUGE = REGISTRY.gauge(
    "repro_service_uptime_seconds", "monotonic seconds since state boot")


def _bind_state_gauges(state: "ServiceState") -> None:
    """Point the scrape-time gauges at ``state`` (the newest instance wins —
    one daemon per process in production).  Callbacks hold only a weakref
    and read plain ints/floats WITHOUT the state lock: a scrape never
    blocks on (or deadlocks with) an in-flight ingest."""
    ref = weakref.ref(state)

    def fld(fn, default=0.0):
        def read():
            s = ref()
            return float(fn(s)) if s is not None else default
        return read

    _STALE_GAUGE.set_function(fld(lambda s: s.engine.inc.pending_deletions))
    _VERSION_GAUGE.set_function(fld(lambda s: s.version))
    _NLIVE_GAUGE.set_function(fld(lambda s: s.engine.inc.n_live))
    _PENDING_CONF_GAUGE.set_function(
        fld(lambda s: s.engine.pending_confirmations))
    _SNAP_AGE_GAUGE.set_function(fld(
        lambda s: (_time.monotonic() - s.last_snapshot_monotonic
                   if s.last_snapshot_monotonic is not None else -1.0),
        default=-1.0))
    _UPTIME_GAUGE.set_function(fld(lambda s: s.uptime_s))
    if state.is_hier:
        # scrape-time hier gauges (pre-registered in repro_torch.obs; the
        # engine .set()s them too, but the callback always reads the live
        # value)
        from repro_torch.obs import HIER_CLUSTERS, HIER_HEADRING_DIAMETER
        HIER_CLUSTERS.set_function(fld(lambda s: s.engine.n_clusters))
        HIER_HEADRING_DIAMETER.set_function(
            fld(lambda s: s.engine.head_inc.diameter()
                if s.engine.n_clusters > 1 else 0.0))


def _on_device(fn):
    """Run a :class:`ServiceState` method under
    ``eval_options(device=state.device)``, whichever thread calls it."""
    @functools.wraps(fn)
    def call(self, *args, **kw):
        with batcheval.eval_options(device=self.device):
            return fn(self, *args, **kw)
    return call


def _booted_on_device(fn):
    """A :class:`ServiceState` constructor that takes ``device=`` (None =
    CUDA unless an enclosing ``eval_options`` asks for the CPU) and builds
    the engine there."""
    @functools.wraps(fn)
    def call(cls, *args, device=None, **kw):
        with batcheval.eval_options(device=batcheval.eval_device(device)):
            return fn(cls, *args, **kw)
    return call


@dataclasses.dataclass(frozen=True)
class ReoptJob:
    """A frozen copy of the live fleet for the background optimizer: the
    second overlay buffer.  ``version`` records the swap generation the copy
    was taken at (informational — commit reconciles against the CURRENT
    alive set, so a stale job is still safe to land)."""
    live: np.ndarray          # global slot ids, ascending
    overlay: Overlay          # live-subfleet overlay (local indexing)
    version: int


class ServiceState:
    """Lock-guarded live overlay + distance state behind the /v1 API."""

    def __init__(self, engine: ChurnEngine, *, policy_name: str,
                 snapshot_dir: Optional[str] = None, keep_snapshots: int = 3,
                 version: int = 0, events_ingested: int = 0,
                 snapshot_seq: int = 0):
        self.lock = TimedRLock(
            registry=REGISTRY, name="repro_service_lock_wait_seconds",
            help="wait to acquire the ServiceState lock (handler threads "
                 "vs re-optimizer contention)")
        self.engine = engine
        self.is_hier = hasattr(engine, "head_inc")
        # the device the engine's distance state lives on
        self.device = (engine.head_inc if self.is_hier
                       else engine.inc).device
        self.policy_name = policy_name
        self.snapshot_dir = snapshot_dir
        self.keep_snapshots = keep_snapshots
        self.version = version                  # bumped on every reopt swap
        self.events_ingested = events_ingested  # externally submitted events
        self.queries_served = 0
        self.reopts_completed = 0
        self.reopts_kept = 0                    # adapt said "keep"
        self.snapshot_seq = snapshot_seq
        self.events_since_snapshot = 0
        self.events_since_reopt = 0
        # wall clock is metadata only (snapshots, logs); every duration —
        # uptime, snapshot age — comes from the monotonic clock, so a step
        # of the system clock never corrupts them
        self.started_at = _time.time()
        self._started_monotonic = _time.monotonic()
        self.last_snapshot_monotonic: Optional[float] = None
        self._overlay: Optional[Overlay] = None
        self._overlay_live: Optional[np.ndarray] = None
        _bind_state_gauges(self)
        _log.info(kv("state.boot", policy=policy_name, version=version,
                     n_live=engine.inc.n_live, capacity=engine.inc.capacity))

    @property
    def uptime_s(self) -> float:
        return _time.monotonic() - self._started_monotonic

    # -- constructors -----------------------------------------------------

    @classmethod
    @_booted_on_device
    def fresh(cls, world: Trace, *, policy: str = "dgro",
              k_rings: Optional[int] = None, detect_failures: bool = True,
              rebuild_threshold: int = 8, seed: int = 0,
              snapshot_dir: Optional[str] = None,
              keep_snapshots: int = 3) -> "ServiceState":
        """Boot from a world spec (a :class:`Trace`; its events, if any, are
        ignored — the service ingests events over the API).

        The policy's *inline* self-repair cadence is disabled for DGRO: in
        the service the re-optimizer owns adaptation, asynchronously, so an
        ingest never blocks on ring selection.

        ``policy="dgro-hier"`` boots a
        :class:`repro_torch.hier.HierChurnEngine` instead: cluster-
        partitioned state, cluster-local maintenance, the re-optimizer then
        owns the HEAD RING.  ``k_rings`` and ``detect_failures`` do not
        apply there (hier failures confirm immediately).

        ``device=`` places the engine's distance state: CUDA unless it (or
        an enclosing ``batcheval.eval_options``) asks for the CPU.
        """
        if policy == "dgro-hier":
            from repro_torch.hier import HierChurnEngine
            engine = HierChurnEngine(
                Trace(n0=world.n0, capacity=world.capacity, dist=world.dist,
                      seed=world.seed, events=[], name=world.name),
                rebuild_threshold=rebuild_threshold, seed=seed)
            return cls(engine, policy_name=policy, snapshot_dir=snapshot_dir,
                       keep_snapshots=keep_snapshots)
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; options "
                f"{sorted(POLICIES) + ['dgro-hier']}")
        kw: Dict = {}
        if policy in ("dgro", "rapid"):
            kw["k_rings"] = k_rings
        if policy == "dgro":
            kw["adapt_every"] = 2**31          # async reopt replaces inline
        pol = POLICIES[policy](**kw)
        engine = ChurnEngine(
            Trace(n0=world.n0, capacity=world.capacity, dist=world.dist,
                  seed=world.seed, events=[], name=world.name),
            pol, detect_failures=detect_failures,
            rebuild_threshold=rebuild_threshold, seed=seed)
        return cls(engine, policy_name=policy, snapshot_dir=snapshot_dir,
                   keep_snapshots=keep_snapshots)

    @classmethod
    @_booted_on_device
    def restore(cls, snapshot_dir: str, *,
                keep_snapshots: int = 3) -> "ServiceState":
        """Recover from the newest committed snapshot (crash restart).

        The distance matrix is recomputed exactly from the snapshot
        adjacency, so the restored service starts torn-state-free: it serves
        precisely the overlay the snapshot committed, and nothing newer.
        ``device=`` as for :meth:`fresh`.
        """
        found = snaps.latest_snapshot(snapshot_dir)
        if found is None:
            raise FileNotFoundError(
                f"no committed service snapshot under {snapshot_dir}")
        seq, p = found
        wd = p["world"]
        world = Trace(n0=wd["n0"], capacity=wd["capacity"], dist=wd["dist"],
                      seed=wd["seed"], events=[], name=wd.get("name", "world"))
        if p.get("kind") == "service_snapshot_hier":
            return cls._restore_hier(world, seq, p, snapshot_dir,
                                     keep_snapshots)
        c = world.capacity
        pol = POLICIES[p["policy"]]()
        pol.rings = [list(map(int, ring)) for ring in p["policy_rings"]]
        if p["policy"] == "dgro":
            pol.adapt_every = 2**31
        w = np.asarray(p["w"], np.float32)
        adj = np.full((c, c), float(INF), np.float32)
        np.fill_diagonal(adj, 0.0)
        for u, v, wt in p["edges"]:
            adj[int(u), int(v)] = adj[int(v), int(u)] = np.float32(wt)
        alive = np.zeros(c, bool)
        alive[np.asarray(p["alive"], np.intp)] = True
        engine = ChurnEngine.restore(
            world, pol, w=w, adj=adj, alive=alive,
            latency_factor=np.asarray(p["latency_factor"], np.float32),
            drift_scale=np.asarray(p["drift_scale"], np.float32),
            clock=p["time"], events_processed=p["events_processed"],
            detect_failures=p["detect_failures"],
            rebuild_threshold=p["rebuild_threshold"], seed=p["seed"])
        state = cls(engine, policy_name=p["policy"],
                    snapshot_dir=snapshot_dir, keep_snapshots=keep_snapshots,
                    version=p["version"], events_ingested=p["events_ingested"],
                    snapshot_seq=seq)
        return state

    @classmethod
    def _restore_hier(cls, world: Trace, seq: int, p: Dict,
                      snapshot_dir: str, keep_snapshots: int
                      ) -> "ServiceState":
        """Recover a hierarchical deployment from a schema-2 snapshot."""
        from repro_torch.hier import (HierChurnEngine, HierConfig,
                                      latency_from_spec)
        c = world.capacity
        alive = np.zeros(c, bool)
        alive[np.asarray(p["alive"], np.intp)] = True
        lat = (latency_from_spec(p["latency"])
               if p.get("latency") is not None else None)
        engine = HierChurnEngine.restore(
            world, HierConfig(cluster_size=int(p.get("cluster_size", 0))),
            slot_cluster=np.asarray(p["slot_cluster"], np.int64),
            alive=alive,
            edges=np.asarray(p["edges"], np.intp).reshape(-1, 2),
            heads={int(k): int(v) for k, v in p["heads"].items()},
            latency_factor=np.asarray(p["latency_factor"], np.float32),
            drift_scale=np.asarray(p["drift_scale"], np.float32),
            lat=lat, clock=p["time"],
            events_processed=p["events_processed"],
            rebuild_threshold=p["rebuild_threshold"], seed=p["seed"])
        return cls(engine, policy_name=p["policy"],
                   snapshot_dir=snapshot_dir, keep_snapshots=keep_snapshots,
                   version=p["version"],
                   events_ingested=p["events_ingested"], snapshot_seq=seq)

    @classmethod
    def open(cls, world: Trace, snapshot_dir: Optional[str] = None,
             **fresh_kw) -> "ServiceState":
        """Restore if a committed snapshot exists, else boot fresh."""
        if snapshot_dir and snaps.latest_snapshot(snapshot_dir) is not None:
            return cls.restore(
                snapshot_dir, keep_snapshots=fresh_kw.get("keep_snapshots", 3),
                device=fresh_kw.get("device"))
        return cls.fresh(world, snapshot_dir=snapshot_dir, **fresh_kw)

    # -- ingest -----------------------------------------------------------

    @_on_device
    def ingest(self, events: Sequence[Event]) -> Dict:
        """Apply externally-arriving events in order.  Events applied before
        a failure stay applied (the caller sees the index that failed)."""
        applied = 0
        with self.lock:
            for i, e in enumerate(events):
                try:
                    applied += self.engine.process(e)
                except ValueError as err:
                    raise ValueError(
                        f"event {i} ({e.kind} t={e.time}) rejected after "
                        f"{applied} applied: {err}") from err
            self.events_ingested += len(events)
            self.events_since_snapshot += len(events)
            self.events_since_reopt += len(events)
            self._overlay = None
            _EVENTS.inc(len(events))
            _INGEST_BATCHES.inc()
            return {"accepted": len(events), "applied": applied,
                    "clock": self.engine.clock, "n_live": self.engine.inc.n_live,
                    "pending_confirmations": self.engine.pending_confirmations,
                    "version": self.version}

    # -- queries ----------------------------------------------------------

    def _count_query(self, kind: str = "stats") -> None:
        """Count one served query, labelled by endpoint kind and by whether
        the answer came from an exact matrix or a staleness lower bound —
        the scraped exact-vs-lower ratio is the staleness health signal."""
        self.queries_served += 1
        bound = ("exact" if self.engine.inc.pending_deletions == 0
                 else "lower")
        _QUERIES.labels(kind=kind, bound=bound).inc()

    @_on_device
    def stats(self) -> Dict:
        with self.lock:
            self._count_query("stats")
            inc = self.engine.inc
            extra = ({"clusters": self.engine.n_clusters,
                      "reorg": dict(self.engine.reorg_stats)}
                     if self.is_hier else {})
            return {
                **extra,
                "policy": self.policy_name,
                "version": self.version,
                "clock": self.engine.clock,
                "n_live": inc.n_live,
                "capacity": inc.capacity,
                "events_ingested": self.events_ingested,
                "events_processed": self.engine.events_processed,
                "pending_confirmations": self.engine.pending_confirmations,
                "pending_deletions": inc.pending_deletions,
                "distances_are": ("exact" if inc.pending_deletions == 0
                                  else "lower-bound"),
                "maintenance": dict(inc.stats),
                "reopts_completed": self.reopts_completed,
                "reopts_kept": self.reopts_kept,
                "queries_served": self.queries_served,
                "snapshot_seq": self.snapshot_seq,
                "started_at_unixtime": self.started_at,
                "uptime_s": self.uptime_s,
            }

    @_on_device
    def diameter(self, exact: bool = False) -> Dict:
        with self.lock:
            self._count_query("diameter")
            inc = self.engine.inc
            d = inc.diameter(exact=exact)
            return {"diameter": d,
                    "exact": bool(exact or inc.pending_deletions == 0),
                    "pending_deletions": inc.pending_deletions,
                    "n_live": inc.n_live, "version": self.version}

    @_on_device
    def route(self, src: int, dst: int) -> Dict:
        """Distance + greedy next-hop path from the maintained matrix.

        The distance is exact when no deletions are pending, otherwise a
        provable lower bound.  The path comes from the SHARED greedy
        router (``repro_torch.routing.route_single_host`` — the same float32
        next-hop rule as the device batch router and the fig19
        benchmark): latency-greedy descent over ``adj[u, v] + D[v, dst]``.
        Under a stale matrix the descent can dead-end or exhaust its hop
        budget, in which case ``path`` is ``None`` and only the distance
        bound is served.

        Only the column ``D[:, dst]`` comes back from the device, not the
        (C, C) matrix.

        Response keys beyond the original contract (additive only):
        ``hops`` (path edge count, ``None`` when undelivered), ``stretch``
        (delivered latency / served distance — >= 1 against a lower
        bound), and ``hop_bounds`` (per-hop ``"exact"``/``"lower"`` stamp
        of the distance estimate that guided the descent).
        """
        from repro_torch.routing import record_route, route_single_host
        with self.lock:
            self._count_query("route")
            inc = self.engine.inc
            if self.is_hier:
                return self._route_hier(src, dst)
            for name, u in (("src", src), ("dst", dst)):
                if not 0 <= u < inc.capacity:
                    raise ValueError(f"{name}={u} outside capacity "
                                     f"[0, {inc.capacity})")
                if not inc.alive[u]:
                    raise ValueError(f"{name}={u} is not a live node")
            col = inc.distances_at(slice(None), dst)     # D[:, dst]
            d = float(col[src])
            reachable = d < float(INF) / 2
            stale = inc.pending_deletions > 0
            bound = "lower" if stale else "exact"
            path: Optional[List[int]] = None
            hops: Optional[int] = None
            stretch: Optional[float] = None
            if reachable:
                walk, lat, n_hops, outcome = route_single_host(
                    np.asarray(inc.adj, np.float32), col, src, dst,
                    policy="latency", hop_budget=int(inc.n_live))
                if outcome == "delivered":
                    path, hops = walk, n_hops
                    stretch = float(lat) / d if d > 0 else 1.0
            else:
                outcome = "unreachable"
            record_route("latency", outcome, hops)
            return {"src": src, "dst": dst,
                    "distance": d if reachable else None,
                    "reachable": reachable, "stale": stale,
                    "bound": bound, "path": path,
                    "hops": hops, "stretch": stretch,
                    "hop_bounds": [bound] * hops if hops else None,
                    "version": self.version}

    def _route_hier(self, src: int, dst: int) -> Dict:
        """Hier branch of :meth:`route` (caller holds the lock): the
        distance bound composes cluster legs through the head ring; the
        path is the engine's three-leg greedy walk.  Same response keys,
        plus ``hops_by_level``."""
        from repro_torch.routing import record_route
        eng = self.engine
        for name, u in (("src", src), ("dst", dst)):
            if not 0 <= u < eng.capacity:
                raise ValueError(f"{name}={u} outside capacity "
                                 f"[0, {eng.capacity})")
            s = eng.states[eng.cluster_of(u)]
            if not s.inc.alive[int(np.searchsorted(s.slots, u))]:
                raise ValueError(f"{name}={u} is not a live node")
        d, bound = eng.distance_bound(src, dst)
        reachable = d < float(INF) / 2
        stale = bound == "lower"
        path: Optional[List[int]] = None
        hops: Optional[int] = None
        stretch: Optional[float] = None
        hops_by_level: Optional[Dict[str, int]] = None
        if reachable:
            walk, lat, levels, outcome = eng.route(src, dst)
            if outcome == "delivered":
                path, hops_by_level = walk, levels
                hops = levels["local"] + levels["head"]
                stretch = float(lat) / d if d > 0 else 1.0
        else:
            outcome = "unreachable"
        record_route("latency", outcome, hops)
        return {"src": src, "dst": dst,
                "distance": float(d) if reachable else None,
                "reachable": reachable, "stale": stale,
                "bound": bound, "path": path,
                "hops": hops, "stretch": stretch,
                "hops_by_level": hops_by_level,
                "hop_bounds": [bound] * hops if hops else None,
                "version": self.version}

    @_on_device
    def adjacency(self) -> Dict:
        with self.lock:
            self._count_query("adjacency")
            if self.is_hier:
                e, wts = self.engine.weighted_edges()
                live = self.engine.live_ids()
                return {"nodes": [int(u) for u in live],
                        "edges": [[int(u), int(v), float(wt)]
                                  for (u, v), wt in zip(e, wts)],
                        "n_live": int(live.size), "version": self.version}
            inc = self.engine.inc
            live = inc.live_ids()
            sub = inc.adj[np.ix_(live, live)]
            ii, jj = np.nonzero(np.triu(np.asarray(is_edge(sub)), 1))
            edges = [[int(live[i]), int(live[j]), float(sub[i, j])]
                     for i, j in zip(ii, jj)]
            return {"nodes": [int(u) for u in live], "edges": edges,
                    "n_live": int(len(live)), "version": self.version}

    # -- the served Overlay (double buffer A) -----------------------------

    def _head_ring_copy(self) -> "tuple[Overlay, np.ndarray, np.ndarray]":
        """(head-ring Overlay, active cluster ids, their heads' global
        ids) from the maintained head graph — the hierarchical stand-ins
        for the flat path's dense live copies.  Caller holds the lock."""
        eng = self.engine
        act = np.array(sorted(c for c, s in eng.states.items()
                              if s.head >= 0), np.intp)
        heads = np.array([eng.states[int(c)].head for c in act], np.intp)
        wl = eng.head_inc.w[np.ix_(act, act)].copy()
        adjl = eng.head_inc.adj[np.ix_(act, act)].copy()
        ov = Overlay.from_adjacency(wl, adjl, policy="dgro-hier-head",
                                    fold_weights=True)
        return ov, act, heads

    @_on_device
    def overlay(self) -> "tuple[Overlay, np.ndarray]":
        """(served Overlay over the live sub-fleet, global slot ids).

        Rebuilt lazily after mutations; the rebuilt object is immutable, so
        handing it out of the lock is safe.  Hierarchical deployments
        serve the HEAD RING here (ids = the heads' global node ids) — the
        dense whole-fleet overlay is exactly what the hierarchy exists to
        avoid; per-cluster topologies are reachable via ``/v1/adjacency``.
        """
        with self.lock:
            if self._overlay is None:
                if self.is_hier:
                    ov, _act, heads = self._head_ring_copy()
                    self._overlay = ov
                    self._overlay_live = heads
                else:
                    live = self.engine.inc.live_ids().copy()
                    wl = self.engine.w[np.ix_(live, live)]
                    adjl = self.engine.inc.adj[np.ix_(live, live)]
                    self._overlay = Overlay.from_adjacency(
                        wl, adjl, policy=self.policy_name, fold_weights=True)
                    self._overlay_live = live
            return self._overlay, self._overlay_live

    # -- re-optimization (double buffer B) --------------------------------

    @_on_device
    def capture(self) -> ReoptJob:
        """Freeze a copy of the live fleet for the background optimizer.

        Hierarchical deployments freeze the HEAD RING instead (``live``
        holds cluster ids): the optimizer then improves inter-cluster
        latency — cluster-interior maintenance is already local and
        cheap — and the unchanged ``adapt``/``dqn`` machinery runs on it
        as on any flat overlay.
        """
        with self.lock:
            if self.is_hier:
                ov, act, _heads = self._head_ring_copy()
                return ReoptJob(live=act, overlay=ov, version=self.version)
            live = self.engine.inc.live_ids().copy()
            wl = self.engine.w[np.ix_(live, live)].copy()
            adjl = self.engine.inc.adj[np.ix_(live, live)].copy()
            version = self.version
        # Overlay construction is O(C^2) validation — outside the lock
        ov = Overlay.from_adjacency(wl, adjl, policy=self.policy_name,
                                    fold_weights=True)
        return ReoptJob(live=live, overlay=ov, version=version)

    @_on_device
    def commit_reopt(self, job: ReoptJob, new_overlay: Overlay) -> Dict:
        """Atomically swap the optimized overlay in.

        The candidate was computed on ``job``'s frozen copy; membership may
        have moved on since, so the merge applies the candidate's NEW edges
        only between still-live nodes, as exact incremental relaxations
        (distances only improve — the staleness lower bound is preserved).
        One lock acquisition covers relax + version bump + served-overlay
        swap, so a query sees either the old topology or the new one,
        never a half-merged state.
        """
        new_edges = np.argwhere(np.triu(
            np.asarray(is_edge(new_overlay.adjacency))
            & ~np.asarray(is_edge(job.overlay.adjacency)), 1))
        with self.lock:
            applied = 0
            if self.is_hier:
                # job.live holds CLUSTER ids; land head-ring edges between
                # clusters that are still active
                eng = self.engine
                for i, j in new_edges:
                    a, b = int(job.live[i]), int(job.live[j])
                    if (eng.states.get(a) is not None
                            and eng.states.get(b) is not None
                            and eng.states[a].head >= 0
                            and eng.states[b].head >= 0):
                        eng.head_inc.add_edge(
                            a, b, float(new_overlay.adjacency[i, j]))
                        applied += 1
            else:
                alive = self.engine.alive
                for i, j in new_edges:
                    u, v = int(job.live[i]), int(job.live[j])
                    if alive[u] and alive[v]:
                        self.engine.inc.add_edge(
                            u, v, float(new_overlay.adjacency[i, j]))
                        applied += 1
            self.version += 1
            self.reopts_completed += 1
            self.events_since_reopt = 0
            self._overlay = None             # next overlay() serves buffer B
            _REOPT_EDGES.inc(applied)
            _log.info(kv("reopt.commit", version=self.version,
                         edges_added=applied,
                         edges_proposed=int(len(new_edges))))
            return {"version": self.version, "edges_added": applied,
                    "edges_proposed": int(len(new_edges))}

    # -- snapshots --------------------------------------------------------

    @_on_device
    def snapshot_payload(self) -> Dict:
        """Full capacity-level state as a serde-versioned dict.  Refreshes
        pending deletions first so the recorded diameter is exact — the
        restart-consistency invariant the fig17 gate checks."""
        with self.lock:
            if self.is_hier:
                return self._snapshot_payload_hier()
            eng = self.engine
            inc = eng.inc
            inc.refresh()
            live = inc.live_ids()
            sub_is_edge = np.triu(np.asarray(is_edge(inc.adj)), 1)
            ii, jj = np.nonzero(sub_is_edge)
            return {
                "kind": "service_snapshot",
                "time": eng.clock,
                "events_processed": eng.events_processed,
                "events_ingested": self.events_ingested,
                "version": self.version,
                "policy": self.policy_name,
                "policy_rings": [[int(u) for u in ring]
                                 for ring in getattr(eng.policy, "rings", [])],
                "world": {"n0": eng.trace.n0, "capacity": eng.trace.capacity,
                          "dist": eng.trace.dist, "seed": eng.trace.seed,
                          "name": eng.trace.name},
                "w": [[float(x) for x in row] for row in inc.w],
                "latency_factor": [float(x) for x in eng.latency_factor],
                "drift_scale": [float(x) for x in eng.drift_scale],
                "alive": [int(u) for u in live],
                "edges": [[int(u), int(v), float(inc.adj[u, v])]
                          for u, v in zip(ii, jj)],
                "diameter": inc.diameter(),
                "detect_failures": eng.detect_failures,
                "rebuild_threshold": inc.rebuild_threshold,
                "seed": 0,
                # wall clock is snapshot METADATA only — restore logic and
                # all durations use event clocks / the monotonic clock
                "wall_time": _time.time(),
            }

    def _snapshot_payload_hier(self) -> Dict:
        """Hier snapshot (serde schema 2; caller holds the lock): the
        slot->cluster map, heads, live ids, and the GLOBAL edge list
        (intra-cluster + head ring).  Edge weights rehydrate on restore
        from the latency model and the drift/straggler factors — the
        restored topology is edge-for-edge the committed one."""
        from repro_torch.hier import DenseLatency
        eng = self.engine
        eng.refresh()
        return {
            "kind": "service_snapshot_hier",
            "time": eng.clock,
            "events_processed": eng.events_processed,
            "events_ingested": self.events_ingested,
            "version": self.version,
            "policy": self.policy_name,
            "world": {"n0": eng.trace.n0, "capacity": eng.trace.capacity,
                      "dist": eng.trace.dist, "seed": eng.trace.seed,
                      "name": eng.trace.name},
            # None = dense latency from the world trace (recomputed on
            # restore); lazy models serialize their (tiny) spec instead
            "latency": (None if isinstance(eng.lat, DenseLatency)
                        else eng.lat.to_spec()),
            "cluster_size": eng.cfg.cluster_size,
            "slot_cluster": [int(c) for c in eng._slot_cluster],
            "heads": {str(c): int(s.head) for c, s in eng.states.items()},
            "alive": [int(u) for u in eng.live_ids()],
            "edges": [[int(u), int(v)] for u, v in eng.edge_list()],
            "latency_factor": [float(x) for x in eng.latency_factor],
            "drift_scale": [float(x) for x in eng.drift_scale],
            "diameter": eng.diameter(),
            "rebuild_threshold": eng.rebuild_threshold,
            "seed": 0,
            "wall_time": _time.time(),
        }

    @_on_device
    def write_snapshot(self, reason: str = "periodic") -> Optional[str]:
        """Atomic-commit a snapshot (no-op without a snapshot dir)."""
        if not self.snapshot_dir:
            return None
        with span("snapshot.write"):
            payload = self.snapshot_payload()
            payload["reason"] = reason
            with self.lock:
                self.snapshot_seq += 1
                seq = self.snapshot_seq
                self.events_since_snapshot = 0
            path = snaps.write_snapshot(
                self.snapshot_dir, seq, payload, keep=self.keep_snapshots,
                schema=serde.HIER_SCHEMA if self.is_hier else None)
        self.last_snapshot_monotonic = _time.monotonic()
        _SNAPSHOTS.labels(reason=reason).inc()
        _log.info(kv("snapshot.committed", seq=seq, reason=reason,
                     path=path))
        return path
