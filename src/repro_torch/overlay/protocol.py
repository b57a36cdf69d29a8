"""The topology protocol — what every layer above ``repro.overlay`` needs.

A copy of ``repro.overlay.protocol``.  Historically the whole stack
(dynamics, routing, service, benchmarks) hard-assumed *the*
:class:`~repro.overlay.Overlay` dataclass and its dense (N, N) latency
matrix.  That caps the repo around N=4096.  The protocol
below is the small surface those layers actually consume, so a topology can
be the flat ``Overlay`` (unchanged semantics, bit-identical caches) or the
two-level :class:`~repro.hier.HierarchicalOverlay` (paper §VI composed:
cluster-local DGRO rings + a DGRO ring over cluster heads) without any call
site caring which.

Distance semantics are *bounds with a stamp* — the same ``exact | lower``
contract ``dynamics.incremental`` and the service already serve:

* ``distance_bound(u, v) -> (value, "exact" | "lower")`` — never an
  overestimate; ``"exact"`` when nothing is stale at either level;
* ``diameter_bound() -> (value, "exact" | "upper")`` — never an
  underestimate of the topology's true diameter (the flat implementation
  is always exact; the hierarchical one is exact when its cluster
  distance matrices are, and an eccentricity-composed upper bound when
  they are evaluated lazily at large N).
"""
from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch import serde

__all__ = ["Topology", "from_topology_json"]


@runtime_checkable
class Topology(Protocol):
    """Structural protocol both overlay implementations satisfy.

    ``n`` / ``policy`` are attributes; everything else is behaviour.  Node
    ids in ``edge_list`` / ``distance_bound`` / ``subset`` are indices into
    ``range(n)`` (the implementation's own node numbering).
    """

    policy: str

    @property
    def n(self) -> int: ...

    def edge_list(self) -> np.ndarray:
        """(E, 2) unique undirected edges (u < v)."""
        ...

    def distance_bound(self, u: int, v: int) -> Tuple[float, str]:
        """(shortest-path value, ``"exact" | "lower"``) — never an
        overestimate."""
        ...

    def diameter_bound(self) -> Tuple[float, str]:
        """(diameter value, ``"exact" | "upper"``) — never an
        underestimate."""
        ...

    def subset(self, alive) -> "Topology":
        """Restrict to the live nodes, reindexing to ``range(n_live)``."""
        ...

    def to_json(self) -> str:
        """Serde-stamped snapshot; ``from_topology_json`` restores it."""
        ...


def from_topology_json(s: str) -> "Topology":
    """Parse either topology implementation from its JSON snapshot.

    Flat ``Overlay`` payloads are schema 1; ``HierarchicalOverlay``
    payloads are schema 2 with ``"kind": "hier_overlay"``.  Dispatch is by
    payload, so callers that accept "a topology" (service snapshots, trace
    sidecars) need exactly one entry point.
    """
    d = serde.loads(s, what="topology JSON")
    if serde.payload_schema(d) >= 2 or d.get("kind") == "hier_overlay":
        from repro_torch.hier import HierarchicalOverlay
        return HierarchicalOverlay.from_json(s)
    from .core import Overlay
    return Overlay.from_json(s)
