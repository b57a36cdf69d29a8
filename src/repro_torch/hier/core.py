"""Two-level hierarchical overlays (paper §VI, composed construction;
torch port of ``repro.hier.core``).

The flat :class:`~repro_torch.overlay.Overlay` carries a dense (N, N) latency
matrix and dense APSP caches — O(N^2) memory caps it around N=4096.  This
module composes the paper's partitioned construction into a two-level
hierarchy that reaches N=10^5-10^6:

* nodes are partitioned into latency clusters (recursive farthest-point
  splitting over a lazy :class:`~repro_torch.hier.geo.LatencyModel` — never a
  dense matrix);
* each cluster gets a flat cluster-local :class:`Overlay` whose rings are
  built by the device-batched engine (``core.construction
  .nearest_rings_batched`` on the eval device: CUDA unless the caller asks
  for the CPU): all clusters in a chunk build their k rings in one call
  over an INF-padded (M·k, P, P) block stack;
* each cluster elects a **head** (latency medoid), and a DGRO ring overlay
  is built over the heads.

Heads are each cluster's only gateway, which makes the two-level distance
composition *exact for the hierarchical topology*: for u in cluster a and
v in cluster b != a,

    d(u, v) = d_a(u, h_a) + D_head(a, b) + d_b(h_b, v)

(any excursion into a third cluster's interior enters and leaves through
the same head, a non-negative cycle).  :meth:`HierarchicalOverlay
.diameter_bound` therefore stamps ``"exact"`` when it evaluates full
cluster APSPs, and ``"upper"`` for the cheap eccentricity composition
``max_{a,b} ecc_a + D_head(a, b) + ecc_b`` (a == b included: 2·ecc bounds
the intra-cluster diameter) that needs only one Dijkstra per cluster.

:class:`HierarchicalOverlay` satisfies the
:class:`repro_torch.overlay.Topology` protocol; the ``"dgro-hier"``
registry builder returns one from a dense
latency matrix, and :func:`build_hier` accepts any lazy latency model for
the large-N path.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import serde
from repro_torch.core import batcheval
from repro_torch.core.construction import (default_num_rings,
                                           nearest_rings_batched)
from repro_torch.core.diameter import INF, is_edge
from repro_torch.device import upload
from repro_torch.overlay import Overlay, register
from repro_torch.overlay import build as build_overlay
from .geo import (DenseLatency, LatencyModel, SubsetLatency, as_latency,
                  latency_from_spec)

__all__ = ["HierConfig", "HierarchicalOverlay", "build_hier",
           "assign_latency_clusters", "default_cluster_size"]


def default_cluster_size(n: int) -> int:
    """Target cluster size: sqrt(N) balances the two levels (cluster state
    and head ring are then both ~sqrt(N)), capped at 512 so a cluster's
    dense (P, P) state stays small at any N.  The balance matters: a cap
    far below sqrt(N) pushes all the nodes into the head ring, whose
    guided DGRO build is the O(M^2)-and-up term."""
    return int(min(512, max(8, math.ceil(math.sqrt(max(n, 1))))))


@dataclasses.dataclass(frozen=True)
class HierConfig:
    """Config for the ``"dgro-hier"`` builder / :func:`build_hier`.

    ``cluster_size=0`` / ``k_local=0`` pick :func:`default_cluster_size` and
    ``ceil(log2 cluster_size)`` rings (the paper's per-node degree budget)
    respectively.  ``head_policy`` names any registered *flat* builder for
    the ring over cluster heads.  ``chunk`` bounds how many clusters share
    one fused device build (memory/compile-shape knob, not semantics).
    """

    cluster_size: int = 0
    k_local: int = 0
    head_policy: str = "dgro"
    chunk: int = 64


# ---------------------------------------------------------------------------
# latency clustering (lazy model, O(N * M) time, O(N) memory)
# ---------------------------------------------------------------------------

def _split_group(lat: LatencyModel, mem: np.ndarray, k: int,
                 rng: np.random.Generator) -> List[np.ndarray]:
    """Partition ``mem`` into ``k`` groups by nearest of k farthest-point
    seeds (distances asked from the lazy model one column at a time)."""
    seeds = [int(mem[rng.integers(mem.size)])]
    near = lat.block(mem, seeds[:1])[:, 0].astype(np.float64)
    assign = np.zeros(mem.size, np.int64)
    for c in range(1, k):
        s = int(mem[np.argmax(near)])
        seeds.append(s)
        d = lat.block(mem, [s])[:, 0].astype(np.float64)
        closer = d < near
        near[closer] = d[closer]
        assign[closer] = c
    groups = [mem[assign == c] for c in range(k)]
    groups = [g for g in groups if g.size]
    if len(groups) == 1 and k > 1:
        # degenerate metric (e.g. co-located nodes): chop by distance rank
        order = mem[np.argsort(near, kind="stable")]
        groups = [g for g in np.array_split(order, k) if g.size]
    return groups


def _merge_small_leaves(lat: LatencyModel, leaves: List[np.ndarray],
                        target: int, cap: int) -> List[np.ndarray]:
    """Fold leaves below ``target // 2`` into their nearest neighbour leaf
    (by representative latency) while the union stays under ``cap``.

    Nearest-seed splitting is uneven under skewed node density — seeds in
    sparse regions capture few nodes — and every undersized leaf becomes a
    head-ring node, inflating the level whose guided build is the
    expensive one.  This greedy pass restores the ~sqrt(N) balance.
    """
    floor = max(2, target // 2)
    reps = np.array([int(g[g.size // 2]) for g in leaves], np.intp)
    sizes = np.array([g.size for g in leaves], np.int64)
    alive = np.ones(len(leaves), bool)
    groups: List[np.ndarray] = list(leaves)
    while alive.sum() > 1:
        small = np.flatnonzero(alive & (sizes < floor))
        if not small.size:
            break
        i = int(small[np.argmin(sizes[small])])
        cand = np.flatnonzero(alive & (sizes + sizes[i] <= cap))
        cand = cand[cand != i]
        if not cand.size:      # nothing can absorb it without bursting cap
            alive[i] = False   # keep as-is, stop reconsidering it
            continue
        d = lat.pairs(np.full(cand.size, reps[i], np.intp), reps[cand])
        j = int(cand[np.argmin(d)])
        groups[j] = np.sort(np.concatenate([groups[j], groups[i]]))
        sizes[j] += sizes[i]
        alive[i] = False
        groups[i] = np.zeros(0, np.intp)
        sizes[i] = 0
    return [g for g in groups if g.size]


def assign_latency_clusters(lat: LatencyModel, target: int,
                            rng: np.random.Generator) -> np.ndarray:
    """(N,) cluster assignment with every cluster below ~1.5x ``target``.

    Recursive farthest-point splitting: any group above the cap is split
    ``ceil(size / target)``-ways (at most 64 per round) by nearest-seed.
    Unlike one global farthest-point pass, this stays balanced under skewed
    node density (a metro site with 10^4 co-located nodes still ends up in
    ~``size / target`` clusters).  Clusters are numbered by their smallest
    member id, so the labelling is stable and members are sorted.
    """
    if target < 2:
        raise ValueError(f"target cluster size must be >= 2, got {target}")
    cap = max(3, int(1.5 * target))
    queue: List[np.ndarray] = [np.arange(lat.n)]
    leaves: List[np.ndarray] = []
    while queue:
        mem = queue.pop()
        if mem.size <= cap:
            leaves.append(mem)
            continue
        k = min(64, math.ceil(mem.size / target))
        queue.extend(_split_group(lat, mem, k, rng))
    leaves = _merge_small_leaves(lat, leaves, target, cap)
    leaves.sort(key=lambda g: int(g[0]))
    assignment = np.empty(lat.n, np.int32)
    for c, mem in enumerate(leaves):
        assignment[mem] = c
    return assignment


# ---------------------------------------------------------------------------
# fused cluster-local ring construction
# ---------------------------------------------------------------------------

def _round_up(x: int, mult: int = 16) -> int:
    return ((x + mult - 1) // mult) * mult


def _build_cluster_overlays(lat: LatencyModel, members: List[np.ndarray],
                            k_local: int, rng: np.random.Generator,
                            chunk: int) -> Tuple[List[Overlay], List[int]]:
    """Cluster-local overlays + head election, via fused device builds.

    Clusters are sorted by size into chunks; each chunk pads its latency
    blocks to one (P, P) shape (INF sentinel keeps pad nodes unreachable
    until the real nodes are exhausted) and builds all ``len(chunk) *
    k_local`` nearest rings in one ``nearest_rings_batched`` call on the
    eval device — distinct random starts make the k rings of a cluster
    distinct.
    """
    device = batcheval.eval_device()
    m = len(members)
    overlays: List[Optional[Overlay]] = [None] * m
    heads: List[int] = [0] * m
    order = sorted(range(m), key=lambda c: members[c].size)
    # chunk is additionally capped so a chunk's padded block stack stays
    # under ~256 MB of float32 whatever the cluster sizes are
    budget = 1 << 26
    lo = 0
    while lo < m:
        hi = lo + 1
        while (hi < m and hi - lo < chunk
               and (hi - lo + 1) * k_local
               * _round_up(members[order[hi]].size) ** 2 <= budget):
            hi += 1
        cs = order[lo:hi]
        lo = hi
        pad = _round_up(max(members[c].size for c in cs))
        blocks = np.full((len(cs) * k_local, pad, pad), float(INF), np.float32)
        starts = np.zeros(len(cs) * k_local, np.int32)
        w_blocks = []
        for i, c in enumerate(cs):
            mem = members[c]
            wb = lat.block(mem, mem)
            w_blocks.append(wb)
            blocks[i * k_local:(i + 1) * k_local, :mem.size, :mem.size] = wb
            if mem.size >= k_local:
                starts[i * k_local:(i + 1) * k_local] = rng.choice(
                    mem.size, size=k_local, replace=False)
            else:
                starts[i * k_local:(i + 1) * k_local] = rng.integers(
                    0, mem.size, size=k_local)
        perms = nearest_rings_batched(
            upload(blocks, device),
            upload(starts.astype(np.int64), device)).cpu().numpy()
        for i, c in enumerate(cs):
            size = members[c].size
            rings = [perms[i * k_local + j][:size].astype(np.intp)
                     for j in range(k_local)]
            overlays[c] = Overlay.from_rings(w_blocks[i], rings,
                                             policy="dgro-hier-local")
            heads[c] = int(members[c][np.argmin(w_blocks[i].sum(axis=1))])
    return overlays, heads    # type: ignore[return-value]


def _build_head_overlay(w_heads: np.ndarray, head_policy: str,
                        rng: np.random.Generator) -> Overlay:
    m = w_heads.shape[0]
    if m < 4:
        # too small for the guided builders: a single ring IS the topology
        return Overlay.from_rings(w_heads, [np.arange(m)], policy=head_policy)
    return build_overlay(head_policy, w_heads, rng=rng)


# ---------------------------------------------------------------------------
# the hierarchical overlay
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class HierarchicalOverlay:
    """Two-level topology: cluster-local overlays + a head ring.

    Satisfies the :class:`repro_torch.overlay.Topology` protocol.  Node ids are
    global (``range(n)``); cluster ``c``'s local node order is its sorted
    member ids (derived from ``assignment``, so serialization only carries
    the assignment vector).  ``heads[c]`` is the global id of cluster
    ``c``'s gateway; ``head_overlay`` is a flat overlay whose node ``c`` is
    cluster ``c``'s head.
    """

    lat: LatencyModel
    assignment: np.ndarray
    clusters: Tuple[Overlay, ...]
    heads: np.ndarray
    head_overlay: Overlay
    head_policy: str = "dgro"
    policy: str = "dgro-hier"

    def __post_init__(self):
        self.assignment = np.asarray(self.assignment, np.int32)
        self.heads = np.asarray(self.heads, np.intp)
        self.clusters = tuple(self.clusters)
        m = len(self.clusters)
        if self.assignment.ndim != 1 or self.assignment.size != self.lat.n:
            raise ValueError(
                f"assignment must be ({self.lat.n},), got "
                f"{self.assignment.shape}")
        if self.heads.shape != (m,) or self.head_overlay.n != m:
            raise ValueError(
                f"need one head per cluster: {m} clusters, "
                f"{self.heads.size} heads, head overlay n={self.head_overlay.n}")
        self.members: Tuple[np.ndarray, ...] = tuple(
            np.flatnonzero(self.assignment == c) for c in range(m))
        self._local = np.zeros(self.n, np.intp)
        for c, mem in enumerate(self.members):
            if mem.size != self.clusters[c].n:
                raise ValueError(
                    f"cluster {c} overlay has n={self.clusters[c].n} but "
                    f"{mem.size} assigned members")
            if mem.size == 0:
                raise ValueError(f"cluster {c} is empty")
            self._local[mem] = np.arange(mem.size)
            if self.assignment[self.heads[c]] != c:
                raise ValueError(
                    f"head {int(self.heads[c])} of cluster {c} is assigned "
                    f"to cluster {int(self.assignment[self.heads[c]])}")
        self._cache: Dict[str, object] = {}

    # -- basic shape ------------------------------------------------------

    @property
    def n(self) -> int:
        return self.assignment.size

    @property
    def n_clusters(self) -> int:
        return len(self.clusters)

    def cluster_of(self, u: int) -> int:
        return int(self.assignment[int(u)])

    def local_id(self, u: int) -> int:
        return int(self._local[int(u)])

    def cluster_sizes(self) -> np.ndarray:
        return np.array([mem.size for mem in self.members], np.int64)

    def edge_list(self) -> np.ndarray:
        """(E, 2) unique undirected global edges (u < v): the union of every
        cluster's edges and the head overlay's edges."""
        if "edge_list" not in self._cache:
            parts = [mem[ov.edge_list()]
                     for mem, ov in zip(self.members, self.clusters)]
            he = self.head_overlay.edge_list()
            if he.size:
                parts.append(self.heads[he])
            e = np.concatenate(parts, axis=0) if parts else \
                np.zeros((0, 2), np.intp)
            e = e[e[:, 0] != e[:, 1]]          # 1-node cluster self-loops
            e = np.sort(e, axis=1)
            self._cache["edge_list"] = np.unique(e, axis=0)
        return self._cache["edge_list"]

    # -- distance / diameter bounds (topology protocol) -------------------

    def _head_local(self) -> np.ndarray:
        return self._local[self.heads]

    def distance_bound(self, u: int, v: int) -> Tuple[float, str]:
        """Exact hierarchical shortest-path latency.

        Heads are the only inter-cluster gateways, so the three-leg
        composition is exact for this topology (see module docstring).
        """
        u, v = int(u), int(v)
        a, b = self.cluster_of(u), self.cluster_of(v)
        lu, lv = self.local_id(u), self.local_id(v)
        if a == b:
            return float(self.clusters[a].distances()[lu, lv]), "exact"
        hl = self._head_local()
        da = float(self.clusters[a].distances()[lu, hl[a]])
        db = float(self.clusters[b].distances()[hl[b], lv])
        dh = float(self.head_overlay.distances()[a, b])
        return da + dh + db, "exact"

    def distance_bound_pairs(self, us, vs) -> Tuple[np.ndarray, str]:
        """Vectorized :meth:`distance_bound` over aligned id arrays."""
        us = np.asarray(us, np.intp)
        vs = np.asarray(vs, np.intp)
        a, b = self.assignment[us], self.assignment[vs]
        lu, lv = self._local[us], self._local[vs]
        hl = self._head_local()
        dh = self.head_overlay.distances()
        out = np.empty(us.shape, np.float64)
        for i in range(us.size):
            ca, cb = int(a[i]), int(b[i])
            if ca == cb:
                out[i] = self.clusters[ca].distances()[lu[i], lv[i]]
            else:
                out[i] = (self.clusters[ca].distances()[lu[i], hl[ca]]
                          + dh[ca, cb]
                          + self.clusters[cb].distances()[hl[cb], lv[i]])
        return out, "exact"

    def _head_eccentricities(self, exact: bool) -> np.ndarray:
        """Per-cluster max distance from the head to any member.

        ``exact=True`` reads the (cached) full cluster APSPs; otherwise one
        sparse Dijkstra per cluster — O(E log P), no (P, P) cache.
        """
        key = "ecc_exact" if exact else "ecc"
        if key not in self._cache:
            hl = self._head_local()
            ecc = np.empty(self.n_clusters, np.float64)
            if exact:
                for c, ov in enumerate(self.clusters):
                    ecc[c] = ov.distances()[hl[c]].max()
            else:
                from scipy.sparse import csr_matrix
                from scipy.sparse.csgraph import dijkstra
                for c, ov in enumerate(self.clusters):
                    adj = np.asarray(ov.adjacency, np.float64)
                    sp = csr_matrix(np.where(np.asarray(is_edge(adj)),
                                             adj, 0.0))
                    d = dijkstra(sp, directed=False, indices=int(hl[c]))
                    ecc[c] = d[np.isfinite(d)].max()
            self._cache[key] = ecc
        return self._cache[key]

    def diameter_bound(self, method: str = "auto") -> Tuple[float, str]:
        """Hierarchical diameter: exact or a cheap upper bound.

        * ``"exact"`` — full cluster APSPs: max over per-cluster diameters
          and the head-composed cross terms ``ecc_a + D_head(a, b) + ecc_b``
          (a != b).  Exact for this topology; stamp ``"exact"``.
        * ``"ecc"`` — one Dijkstra per cluster: max over ``ecc_a +
          D_head(a, b) + ecc_b`` including a == b (2·ecc bounds each
          intra-cluster diameter).  Never an underestimate; stamp
          ``"upper"``.
        * ``"auto"`` — ``"exact"`` up to N = 4096 (where caching every
          cluster APSP is trivially cheap), else ``"ecc"``.
        """
        if method == "auto":
            method = "exact" if self.n <= 4096 else "ecc"
        if method not in ("exact", "ecc"):
            raise ValueError(f"unknown diameter method {method!r}")
        key = f"diameter_{method}"
        if key not in self._cache:
            dh = self.head_overlay.distances().astype(np.float64)
            if method == "exact":
                ecc = self._head_eccentricities(exact=True)
                cross = ecc[:, None] + dh + ecc[None, :]
                np.fill_diagonal(cross, -np.inf)
                intra = max(ov.diameter() for ov in self.clusters)
                value = float(max(intra, cross.max())) \
                    if self.n_clusters > 1 else float(intra)
                self._cache[key] = (value, "exact")
            else:
                ecc = self._head_eccentricities(exact=False)
                cross = ecc[:, None] + dh + ecc[None, :]
                self._cache[key] = (float(cross.max()), "upper")
        return self._cache[key]

    # -- materialization (small-N verification only) ----------------------

    def materialize(self) -> Overlay:
        """Flatten to a dense global :class:`Overlay` (exact-APSP oracle
        for tests/benchmarks).  Refuses above N=4096 — the whole point of
        the hierarchy is that the dense form does not fit there."""
        if self.n > 4096:
            raise ValueError(
                f"refusing to materialize n={self.n} > 4096 as a dense "
                f"Overlay; use distance_bound / diameter_bound instead")
        from repro_torch.core.diameter import adjacency_from_edges
        w = self.lat.dense()
        adj = adjacency_from_edges(w, self.edge_list())
        return Overlay.from_adjacency(w, adj, policy=self.policy)

    # -- subset (churn) ---------------------------------------------------

    def subset(self, alive) -> "HierarchicalOverlay":
        """Restrict to live nodes, reindexing to ``range(n_live)``.

        Per-cluster subsetting reuses :meth:`Overlay.subset`; emptied
        clusters are dropped, dead heads are re-elected (latency medoid of
        the survivors), and the head ring is rebuilt with ``head_policy``
        whenever the head set changed.  The latency model becomes a lazy
        :class:`~repro_torch.hier.geo.SubsetLatency` view — nothing dense is
        materialized.
        """
        alive = np.asarray(alive)
        if alive.dtype == bool:
            if alive.shape != (self.n,):
                raise ValueError(
                    f"boolean subset mask must have shape ({self.n},), got "
                    f"{alive.shape}")
            idx = np.flatnonzero(alive)
        else:
            idx = np.unique(np.asarray(alive, np.intp).ravel())
            if idx.size and (idx[0] < 0 or idx[-1] >= self.n):
                raise ValueError(
                    f"subset indices must lie in [0, {self.n})")
        if idx.size == 0:
            raise ValueError("subset() needs at least one live node")
        keep = np.zeros(self.n, bool)
        keep[idx] = True
        remap = np.full(self.n, -1, np.intp)
        remap[idx] = np.arange(idx.size)

        new_clusters: List[Overlay] = []
        new_heads_old: List[int] = []        # global ids in OLD numbering
        new_assign = np.empty(idx.size, np.int32)
        heads_changed = False
        for c, mem in enumerate(self.members):
            live_local = np.flatnonzero(keep[mem])
            if live_local.size == 0:
                heads_changed = True
                continue
            sub = self.clusters[c].subset(live_local)
            live_global = mem[live_local]
            if keep[self.heads[c]]:
                head = int(self.heads[c])
            else:
                heads_changed = True
                head = int(live_global[np.argmin(sub.w.sum(axis=1))])
            new_assign[remap[live_global]] = len(new_clusters)
            new_clusters.append(sub)
            new_heads_old.append(head)
        if len(new_clusters) != self.n_clusters:
            heads_changed = True
        heads_old = np.asarray(new_heads_old, np.intp)
        if heads_changed:
            w_heads = self.lat.block(heads_old, heads_old)
            head_overlay = _build_head_overlay(
                w_heads, self.head_policy, np.random.default_rng(0))
        else:
            head_overlay = self.head_overlay
        return HierarchicalOverlay(
            lat=SubsetLatency(self.lat, idx), assignment=new_assign,
            clusters=tuple(new_clusters), heads=remap[heads_old],
            head_overlay=head_overlay, head_policy=self.head_policy,
            policy=self.policy)

    # -- serialization (schema 2) -----------------------------------------

    def to_json(self) -> str:
        """Schema-2 snapshot (``"kind": "hier_overlay"``).

        Members/local ordering are derived from ``assignment`` on load, so
        the payload carries assignment + heads + the latency spec + nested
        flat-overlay payloads (each schema 1, as written by
        :meth:`Overlay.to_json`).
        """
        return serde.dumps({
            "kind": "hier_overlay",
            "policy": self.policy,
            "head_policy": self.head_policy,
            "n": self.n,
            "assignment": [int(c) for c in self.assignment],
            "heads": [int(h) for h in self.heads],
            "latency": self.lat.to_spec(),
            "clusters": [json.loads(ov.to_json()) for ov in self.clusters],
            "head_overlay": json.loads(self.head_overlay.to_json()),
        }, schema=serde.HIER_SCHEMA, indent=None)

    @classmethod
    def from_json(cls, s: str) -> "HierarchicalOverlay":
        d = serde.loads(s, what="HierarchicalOverlay JSON")
        if serde.payload_schema(d) != serde.HIER_SCHEMA \
                or d.get("kind") != "hier_overlay":
            raise ValueError(
                "payload is not a schema-2 hierarchical overlay; flat "
                "Overlay payloads load with "
                "repro_torch.overlay.Overlay.from_json or "
                "repro_torch.overlay.from_topology_json")
        return cls(
            lat=latency_from_spec(d["latency"]),
            assignment=np.asarray(d["assignment"], np.int32),
            clusters=tuple(Overlay.from_json(json.dumps(p))
                           for p in d["clusters"]),
            heads=np.asarray(d["heads"], np.intp),
            head_overlay=Overlay.from_json(json.dumps(d["head_overlay"])),
            head_policy=d["head_policy"],
            policy=d["policy"])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "HierarchicalOverlay":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- misc -------------------------------------------------------------

    def equals(self, other: "HierarchicalOverlay") -> bool:
        return (self.policy == other.policy
                and self.head_policy == other.head_policy
                and np.array_equal(self.assignment, other.assignment)
                and np.array_equal(self.heads, other.heads)
                and self.head_overlay.equals(other.head_overlay)
                and len(self.clusters) == len(other.clusters)
                and all(a.equals(b)
                        for a, b in zip(self.clusters, other.clusters)))

    def __repr__(self) -> str:
        sizes = self.cluster_sizes()
        return (f"HierarchicalOverlay(policy={self.policy!r}, n={self.n}, "
                f"clusters={self.n_clusters}, "
                f"cluster_size=[{int(sizes.min())}..{int(sizes.max())}], "
                f"head_policy={self.head_policy!r})")


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def build_hier(lat, cfg: Optional[HierConfig] = None, *,
               rng: Optional[np.random.Generator] = None,
               seed: int = 0) -> HierarchicalOverlay:
    """Build a two-level hierarchical overlay over any latency source.

    ``lat`` is a :class:`~repro_torch.hier.geo.LatencyModel` or a dense matrix
    (coerced).  This is the large-N entry point — with a lazy model the
    build never allocates anything bigger than one cluster chunk's padded
    block stack and the (M, M) head matrix.
    """
    lat = as_latency(lat)
    cfg = cfg or HierConfig()
    rng = rng if rng is not None else np.random.default_rng(seed)
    n = lat.n
    target = cfg.cluster_size or default_cluster_size(n)
    k_local = cfg.k_local or default_num_rings(min(target, n))
    assignment = assign_latency_clusters(lat, target, rng)
    m = int(assignment.max()) + 1
    members = [np.flatnonzero(assignment == c) for c in range(m)]
    clusters, heads = _build_cluster_overlays(lat, members, k_local, rng,
                                              max(1, cfg.chunk))
    heads_arr = np.asarray(heads, np.intp)
    w_heads = lat.block(heads_arr, heads_arr)
    head_overlay = _build_head_overlay(w_heads, cfg.head_policy, rng)
    return HierarchicalOverlay(
        lat=lat, assignment=assignment, clusters=tuple(clusters),
        heads=heads_arr, head_overlay=head_overlay,
        head_policy=cfg.head_policy, policy="dgro-hier")


@register("dgro-hier", config=HierConfig, kind="hier")
def _build_dgro_hier(w: np.ndarray, cfg: HierConfig,
                     rng: np.random.Generator) -> HierarchicalOverlay:
    """Registry builder: dense latency matrix in, hierarchy out.  Large-N
    callers with a lazy latency model use :func:`build_hier` directly."""
    return build_hier(DenseLatency(np.asarray(w, np.float32)), cfg, rng=rng)
