"""The :class:`Overlay` type — the repo's core currency.

An overlay is what every DGRO workload manipulates: a weighted latency
matrix ``w`` over N nodes, the ring permutations embedded in the topology
(the part ring selection is allowed to swap, paper §V), and any extra
non-ring edges a protocol adds (Chord fingers, Perigee nearest-neighbour
links).  The weighted adjacency (0 diagonal, INF sentinel on non-edges) is
*derived* from ``(w, rings, extra_edges)`` at construction, so an Overlay
can never hold an adjacency that disagrees with its rings.

Design:

* **immutable** — a frozen dataclass; "mutations" are functional updates
  (:meth:`replace_rings`, :meth:`add_ring`, :meth:`subset`) that return new
  instances and share ``w``.
* **host state** — every field is a numpy array, as in the JAX package;
  only :mod:`repro_torch.core.batcheval` moves an adjacency to the device
  (CUDA unless ``eval_options(device="cpu")`` asks for the CPU).  There is
  no pytree registration: nothing in the port traces an Overlay.
* **lazily cached analytics** — :meth:`distances` (APSP), :meth:`diameter`
  (largest-CC rule, §IV-C) and degree statistics are computed on first use
  through :mod:`repro_torch.core.batcheval` and memoized on the instance;
  the cache is dropped (never copied) by functional updates.

The JSON snapshot is the state the port shares with the JAX package:
``to_json`` is byte-identical to ``repro.overlay.Overlay.to_json`` and
``from_json`` reads the reference's payloads; :meth:`from_numpy_state`
builds an Overlay from the reference's numpy fields.

Legacy code that wants the old ``(adjacency, rings)`` tuple calls
:meth:`to_tuple`; :meth:`from_adjacency` wraps an existing adjacency whose
edge weights come from ``w`` (the invariant every builder in this repo
maintains).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import serde
from repro_torch.core import batcheval
from repro_torch.core.diameter import (INF, adjacency_from_edges, is_edge,
                                       largest_cc_diameter, ring_edges)

__all__ = ["Overlay"]


def _as_ring_tuple(rings) -> Tuple[np.ndarray, ...]:
    return tuple(np.asarray(r, dtype=np.intp) for r in rings)


def _validate_rings(rings: Tuple[np.ndarray, ...], n: int) -> None:
    ident = np.arange(n)
    for i, p in enumerate(rings):
        if p.shape != (n,) or not np.array_equal(np.sort(p), ident):
            raise ValueError(
                f"ring {i} is not a permutation of range({n}): "
                f"shape {p.shape}, unique {np.unique(p).size}")


@dataclasses.dataclass(frozen=True, eq=False)
class Overlay:
    """Immutable overlay: latency matrix + rings (+ extra edges).

    ``adjacency`` is ALWAYS derived in ``__post_init__`` (it is not an init
    field, so ``dataclasses.replace`` re-derives it too).
    """

    w: np.ndarray
    rings: Tuple[np.ndarray, ...] = ()
    extra_edges: np.ndarray | None = None
    policy: str = "custom"
    adjacency: np.ndarray = dataclasses.field(init=False)
    _cache: Dict[str, object] = dataclasses.field(
        default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        w = np.asarray(self.w, dtype=np.float32)
        n = w.shape[0]
        if w.ndim != 2 or w.shape[0] != w.shape[1]:
            raise ValueError(f"w must be square, got shape {w.shape}")
        rings = _as_ring_tuple(self.rings)
        _validate_rings(rings, n)
        extra = (np.zeros((0, 2), dtype=np.intp) if self.extra_edges is None
                 else np.asarray(self.extra_edges, dtype=np.intp).reshape(-1, 2))
        object.__setattr__(self, "w", w)
        object.__setattr__(self, "rings", rings)
        object.__setattr__(self, "extra_edges", extra)
        object.__setattr__(self, "adjacency",
                           adjacency_from_edges(w, self._all_edges()))

    def _all_edges(self) -> np.ndarray:
        parts = [ring_edges(p) for p in self.rings] + [self.extra_edges]
        return np.concatenate(parts, axis=0)

    # -- basic shape ------------------------------------------------------

    @property
    def n(self) -> int:
        """Number of nodes."""
        return self.w.shape[0]

    @property
    def num_rings(self) -> int:
        return len(self.rings)

    def edge_list(self) -> np.ndarray:
        """(E, 2) unique undirected edges (u < v) of the overlay."""
        return np.argwhere(np.triu(np.asarray(is_edge(self.adjacency)), 1))

    # -- lazily cached analytics (via core.batcheval) ---------------------

    def distances(self) -> np.ndarray:
        """(N, N) all-pairs shortest-path matrix (INF = unreachable)."""
        if "distances" not in self._cache:
            adj = torch.from_numpy(self.adjacency)[None]
            d = batcheval.batched_apsp(adj.to(batcheval.eval_device()))[0]
            self._cache["distances"] = d.cpu().numpy()
        return self._cache["distances"]

    def diameter(self) -> float:
        """Weighted diameter of the largest connected component (§IV-C)."""
        if "diameter" not in self._cache:
            d = torch.from_numpy(self.distances())
            self._cache["diameter"] = float(
                largest_cc_diameter(d.to(batcheval.eval_device())))
        return self._cache["diameter"]

    # -- topology-protocol bounds (repro_torch.overlay.protocol) ----------
    # The flat Overlay's distances are always exact, so the bound stamps
    # are constant; these wrappers exist so flat and hierarchical overlays
    # answer the same questions through the same surface.

    def distance_bound(self, u: int, v: int) -> Tuple[float, str]:
        """(exact shortest-path latency, ``"exact"``)."""
        return float(self.distances()[int(u), int(v)]), "exact"

    def diameter_bound(self) -> Tuple[float, str]:
        """(exact diameter, ``"exact"``)."""
        return self.diameter(), "exact"

    def cache_diameter(self, d: float) -> "Overlay":
        """Pre-seed the diameter cache and return self.

        The sanctioned entry point for builders (GA, DQN, rho-selection)
        that already scored this exact topology — saves the second APSP
        without reaching into the private cache."""
        self._cache["diameter"] = float(d)
        return self

    def is_connected(self) -> bool:
        return bool((self.distances() < float(INF) / 2).all())

    def degrees(self) -> np.ndarray:
        """Per-node overlay degree."""
        if "degrees" not in self._cache:
            self._cache["degrees"] = np.asarray(
                is_edge(self.adjacency)).sum(axis=1)
        return self._cache["degrees"]

    def degree_stats(self) -> Dict[str, float]:
        deg = self.degrees()
        return {"min": float(deg.min()), "mean": float(deg.mean()),
                "max": float(deg.max())}

    # -- functional updates -----------------------------------------------

    def replace_rings(self, new_rings: Sequence[np.ndarray]) -> "Overlay":
        """Swap the ring set (DGRO ring selection); extra edges are kept.

        The replacement must have the SAME ring count — a silently changed
        count would alter per-node degree budgets (one ring buys one
        outgoing edge per node, §IV-B).
        """
        new_rings = _as_ring_tuple(new_rings)
        if len(new_rings) != len(self.rings):
            raise ValueError(
                f"replacement ring count {len(new_rings)} != current "
                f"{len(self.rings)}; use add_ring() to grow the ring set")
        return Overlay(self.w, new_rings, self.extra_edges, self.policy)

    def add_ring(self, perm: np.ndarray) -> "Overlay":
        """Augment the overlay with one more ring (Alg. 3 repair step)."""
        return Overlay(self.w, self.rings + (np.asarray(perm, np.intp),),
                       self.extra_edges, self.policy)

    def subset(self, alive) -> "Overlay":
        """Restrict to the live nodes (churn): drop dead nodes from every
        ring (stitching predecessor to successor) and from the extra edges,
        reindexing to ``range(n_live)``.  Accepts a boolean mask or an index
        array.

        The index path validates once and sorts at most once (already-
        sorted inputs — the common case: ``live_ids()`` output, cluster
        member lists — pass through untouched), and the latency matrix is
        sliced in a single advanced-indexing step, so the only (k, k)
        allocation is the submatrix itself.  Out-of-range or duplicate
        indices raise instead of being silently dropped.
        """
        alive = np.asarray(alive)
        if alive.dtype == bool:
            if alive.shape != (self.n,):
                raise ValueError(
                    f"boolean subset mask must have shape ({self.n},), got "
                    f"{alive.shape}")
            idx = np.flatnonzero(alive)
        else:
            idx = np.asarray(alive, dtype=np.intp).ravel()
            if idx.size:
                if int(idx.min()) < 0 or int(idx.max()) >= self.n:
                    raise ValueError(
                        f"subset indices must lie in [0, {self.n}), got "
                        f"range [{idx.min()}, {idx.max()}]")
                d = np.diff(idx)
                if (d < 0).any():               # sort once, only if needed
                    idx = np.sort(idx)
                    d = np.diff(idx)
                if (d == 0).any():
                    raise ValueError(
                        "subset indices contain duplicates; pass each live "
                        "node at most once")
        if idx.size == 0:
            raise ValueError("subset() needs at least one live node")
        keep = np.zeros(self.n, dtype=bool)
        keep[idx] = True
        remap = np.full(self.n, -1, dtype=np.intp)
        remap[idx] = np.arange(idx.size)
        rings = tuple(remap[p[keep[p]]] for p in self.rings)
        e = self.extra_edges
        e = e[keep[e[:, 0]] & keep[e[:, 1]]] if e.size else e
        return Overlay(self.w[np.ix_(idx, idx)], rings,
                       remap[e] if e.size else None, self.policy)

    # -- conversions ------------------------------------------------------

    def to_tuple(self) -> Tuple[np.ndarray, List]:
        """Legacy ``(adjacency, rings)`` view (pre-Overlay call sites)."""
        return self.adjacency, [np.asarray(r) for r in self.rings]

    @classmethod
    def from_rings(cls, w: np.ndarray, rings: Sequence[np.ndarray],
                   policy: str = "custom") -> "Overlay":
        """Union-of-rings overlay (no extra edges)."""
        return cls(w, _as_ring_tuple(rings), None, policy)

    @classmethod
    def from_numpy_state(cls, w: np.ndarray, rings: Sequence[np.ndarray],
                         extra_edges: np.ndarray | None,
                         policy: str) -> "Overlay":
        """The port's Overlay from the JAX package's numpy fields
        (``ov.w``, ``ov.rings``, ``ov.extra_edges``, ``ov.policy``); the
        adjacency is re-derived, so it equals the reference's bit for bit."""
        return cls(w, _as_ring_tuple(rings), extra_edges, policy)

    @classmethod
    def from_adjacency(cls, w: np.ndarray, adj: np.ndarray,
                       rings: Sequence[np.ndarray] = (),
                       policy: str = "custom",
                       fold_weights: bool = False) -> "Overlay":
        """Wrap an existing adjacency whose edge weights come from ``w``.

        All edges not covered by ``rings`` are recorded as extra edges; the
        derived adjacency must reproduce ``adj`` exactly (edge weights equal
        ``w`` at the edges — the invariant every builder here maintains).

        ``fold_weights=True`` accepts adjacencies with custom edge weights
        (e.g. ``IncrementalDistances.add_edge(weight=...)`` set a link below
        its latency): the deviating weights are folded into the stored ``w``
        so the overlay is representable; off-edge latencies keep ``w``.
        """
        adj = np.asarray(adj, dtype=np.float32)
        if fold_weights:
            w = np.where(np.asarray(is_edge(adj)), adj,
                         np.asarray(w, np.float32))
        rings = _as_ring_tuple(rings)
        covered = np.zeros(adj.shape, dtype=bool)
        for p in rings:
            e = ring_edges(p)
            covered[e[:, 0], e[:, 1]] = covered[e[:, 1], e[:, 0]] = True
        extra = np.argwhere(np.triu(np.asarray(is_edge(adj)) & ~covered, 1))
        ov = cls(w, rings, extra, policy)
        mask = np.asarray(is_edge(adj))
        if not (np.allclose(ov.adjacency[mask], adj[mask], rtol=1e-5, atol=1e-5)
                and np.array_equal(mask, np.asarray(is_edge(ov.adjacency)))):
            raise ValueError(
                "adjacency disagrees with w at its edges; Overlay can only "
                "represent overlays whose edge weights come from w")
        return ov

    # -- serialization ----------------------------------------------------

    def to_json(self) -> str:
        """Snapshot (w + rings + extra edges + policy) as JSON.

        ``from_json`` rebuilds the identical Overlay (adjacency re-derived),
        so churn traces and benchmark artifacts can record the overlay they
        started from next to the events they replayed.  The payload carries
        the repo-wide ``"schema"`` field (``repro_torch.serde``); the
        historical ``"version": 1`` field is kept so pre-schema readers
        still load it.
        """
        return serde.dumps({
            "version": 1,
            "policy": self.policy,
            "n": self.n,
            "w": [[float(x) for x in row] for row in self.w],
            "rings": [[int(x) for x in p] for p in self.rings],
            "extra_edges": [[int(u), int(v)] for u, v in self.extra_edges],
        }, indent=None)

    @classmethod
    def from_json(cls, s: str) -> "Overlay":
        d = serde.loads(s, what="Overlay JSON")
        if serde.payload_schema(d) != 1 or d.get("kind") == "hier_overlay":
            raise ValueError(
                "payload is a hierarchical (schema-2) topology; the flat "
                "Overlay does not load it (the port's hierarchical "
                "overlays come with its hier slice)")
        if d.get("version", 1) != 1:
            raise ValueError(f"unknown Overlay JSON version {d.get('version')!r}")
        return cls(np.asarray(d["w"], np.float32),
                   _as_ring_tuple(d["rings"]),
                   np.asarray(d["extra_edges"], np.intp).reshape(-1, 2),
                   d["policy"])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Overlay":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- misc -------------------------------------------------------------

    def equals(self, other: "Overlay") -> bool:
        """Structural equality (arrays compared by value)."""
        return (self.policy == other.policy
                and self.num_rings == other.num_rings
                and np.array_equal(self.w, other.w)
                and np.array_equal(self.extra_edges, other.extra_edges)
                and all(np.array_equal(a, b)
                        for a, b in zip(self.rings, other.rings))
                and np.array_equal(self.adjacency, other.adjacency))

    def __repr__(self) -> str:  # compact: matrices don't belong in repr
        return (f"Overlay(policy={self.policy!r}, n={self.n}, "
                f"rings={self.num_rings}, extra_edges={len(self.extra_edges)})")
