"""Incremental APSP / diameter maintenance under churn (torch port of
``repro.dynamics.incremental``).

The static stack (``core.diameter`` / ``core.batcheval``) recomputes
all-pairs distances from scratch — O(N^3) per overlay.  Under churn most
events touch one node or one edge, and the distance matrix can be repaired
far cheaper:

* **edge insert** (and any latency *decrease*): the O(N^2) relaxation
  ``D' = min(D, D[:,u] + w_uv + D[v,:], D[:,v] + w_uv + D[u,:])`` is exact —
  with positive weights a new shortest path crosses the new edge at most
  once.
* **node join**: activate a tombstoned capacity slot, compute the new row
  by one min-plus vector step over the attach edges, then relax all pairs
  through the new node — O(N^2) total, exact for the same reason.
* **node leave** (and any latency *increase*): distances can only grow,
  which a relaxation cannot express.  The node is tombstoned (isolated in
  the adjacency, its distance row/col set to INF) and a bounded staleness
  counter is incremented; when accumulated deletions reach
  ``rebuild_threshold`` a full rebuild runs through ``core.batcheval``
  (on the card: K1 squaring below 512 slots, K2 + K1 tiled from there).
  Between rebuilds the matrix is a *lower bound*: ``D_stale <= D_true``
  elementwise — ``refresh()`` restores exactness on demand.

The reference's jitted updates are plain functions on tensors here, out of
place as the reference's are (a caller may keep the old matrix).  They
only launch elementwise work on the tensor's device — gathers, adds, mins —
and never wait for it: no host sync per event.  The relax is elementwise
fp32 in the reference's order, so every update is bitwise the
reference's.  The state is allocated at a fixed ``capacity`` and dead slots
are isolated singletons, which the largest-connected-component diameter
rule (paper §IV-C) ignores.  The ``*_batched`` variants advance B
independent replicas in one set of launches over a (B, C, C) stack, and
``relax_edge_stream_batched`` folds a whole (T, B) insert stream into one
Python loop over T with no host sync.  The relax is a broadcast min-add in
the reference too, with no Pallas kernel; it stays plain torch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import batcheval
from repro_torch.core.diameter import (INF, is_edge, largest_cc_diameter,
                                       relax_edge_update)
from repro_torch.device import upload
from repro_torch.obs import jit_span

__all__ = [
    "relax_edge",
    "relax_edges_batched",
    "relax_edge_stream_batched",
    "join_node",
    "join_nodes_batched",
    "tombstone",
    "tombstones_batched",
    "IncrementalDistances",
]


# ---------------------------------------------------------------------------
# pure updates (single replica + batched variants)
# ---------------------------------------------------------------------------

# Exact O(N^2) edge-insert repair: one (C, C) matrix with scalar u, v, w,
# or a (B, C, C) stack with (B,) tensors.  It lives in ``core.diameter``,
# shared with the deep-Q rollout.
relax_edge = relax_edge_update


def _on(x, like: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` (array, tensor or list) as a tensor of ``dtype`` on ``like``'s
    device."""
    return torch.as_tensor(np.asarray(x) if isinstance(x, (list, tuple))
                           else x, dtype=dtype, device=like.device)


def join_nodes_batched(dists: torch.Tensor, rows, us) -> torch.Tensor:
    """Activate node ``us[b]`` (previously isolated) in replica b with
    one-hop weights ``rows[b]`` (INF where no attach edge).  Exact: a
    shortest path visits u at most once, so u's row is one min-plus vector
    step over exact old distances and every other pair improves only via
    ``d(i,u) + d(u,j)``.  With ``du[u] = 0`` the outer sum's row and column
    u are ``du`` itself, so one ``min`` covers the reference's row, column
    and all-pairs updates with the same candidates (bitwise equal)."""
    rows = _on(rows, dists, dists.dtype)
    us = _on(us, dists, torch.int64)
    du = torch.amin(rows[:, :, None] + dists, dim=1)       # d(u, j), (B, C)
    du = du.scatter(1, us[:, None], 0.0)
    return torch.minimum(dists, du[:, :, None] + du[:, None, :])


def join_node(dist: torch.Tensor, row, u: int) -> torch.Tensor:
    """:func:`join_nodes_batched` for one (C, C) matrix (``u`` a host
    int, so nothing is copied to the device but ``row``)."""
    du = torch.amin(_on(row, dist, dist.dtype)[:, None] + dist, dim=0)
    du[int(u)].fill_(0.0)            # a fill kernel: no host-to-device copy
    return torch.minimum(dist, du[:, None] + du[None, :])


def tombstones_batched(dists: torch.Tensor, us) -> torch.Tensor:
    """Isolate node ``us[b]`` in replica b (INF row/col, 0 self)."""
    us = _on(us, dists, torch.int64)
    hit = torch.arange(dists.shape[-1], device=dists.device)[None, :] \
        == us[:, None]                                     # (B, C)
    row, col = hit[:, :, None], hit[:, None, :]
    out = torch.where(row | col, float(INF), dists)
    return torch.where(row & col, 0.0, out)


def tombstone(dist: torch.Tensor, u: int) -> torch.Tensor:
    """Isolate node ``u`` in the distance matrix (INF row/col, 0 self)."""
    out = dist.clone()
    out[u, :] = float(INF)
    out[:, u] = float(INF)
    out[u, u].fill_(0.0)             # a fill kernel: no host-to-device copy
    return out


def relax_edges_batched(dists: torch.Tensor, us, vs, ws) -> torch.Tensor:
    """(B, C, C) replicas, each relaxed over its own edge (us[b], vs[b])
    of weight ws[b]."""
    return relax_edge_update(dists, _on(us, dists, torch.int64),
                             _on(vs, dists, torch.int64),
                             _on(ws, dists, dists.dtype))


def relax_edge_stream_batched(dists: torch.Tensor, us, vs,
                              ws) -> torch.Tensor:
    """Apply a (T, B) stream of edge inserts to (B, C, C) replicas: the
    reference's ``lax.scan`` over time as a Python loop over T, every step
    :func:`relax_edges_batched`.  The stream is moved to the device once;
    the loop only launches (no host sync)."""
    us = _on(us, dists, torch.int64)
    vs = _on(vs, dists, torch.int64)
    ws = _on(ws, dists, dists.dtype)
    for t in range(us.shape[0]):
        dists = relax_edge_update(dists, us[t], vs[t], ws[t])
    return dists


# ---------------------------------------------------------------------------
# host-side stateful wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IncrementalDistances:
    """Churn-maintained overlay adjacency + APSP distance matrix.

    ``w``, ``adj`` and ``alive`` stay host numpy, as in the reference; the
    (C, C) distance matrix ``_dist`` is a float32 tensor on the eval device
    (``batcheval.eval_device()``: CUDA unless the caller asks for the CPU
    through ``eval_options(device="cpu")``; it raises where there is no
    CUDA device and no such request).

    ``mode="incremental"`` applies the O(N^2) repairs above and amortizes
    deletions through the staleness counter; ``mode="full"`` rebuilds from
    scratch (through ``batcheval``) after every mutation — the baseline the
    maintenance-throughput comparison runs against.
    """

    w: np.ndarray                    # (C, C) latency matrix, mutable
    adj: np.ndarray                  # (C, C) overlay, INF non-edges, 0 diag
    alive: np.ndarray                # (C,) bool; dead slots are isolated
    rebuild_threshold: int = 8       # deletions tolerated before a rebuild
    mode: str = "incremental"        # "incremental" | "full"

    def __post_init__(self):
        assert self.mode in ("incremental", "full"), self.mode
        self.device = batcheval.eval_device()
        self.w = np.asarray(self.w, np.float32).copy()
        self.adj = np.asarray(self.adj, np.float32).copy()
        c = self.w.shape[0]
        assert self.adj.shape == (c, c), (self.adj.shape, c)
        if self.alive is None:
            self.alive = np.ones(c, bool)
        self.alive = np.asarray(self.alive, bool).copy()
        # isolate dead slots so they are singleton components
        dead = np.flatnonzero(~self.alive)
        self.adj[dead, :] = float(INF)
        self.adj[:, dead] = float(INF)
        self.adj[np.arange(c), np.arange(c)] = 0.0
        self.pending_deletions = 0
        self.stats: Dict[str, int] = {"relaxations": 0, "joins": 0,
                                      "leaves": 0, "rebuilds": 0,
                                      "events": 0}
        self._dist: Optional[torch.Tensor] = None
        self.rebuild()
        self.stats["rebuilds"] = 0       # the initial APSP is not churn cost

    # -- queries ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.w.shape[0]

    @property
    def n_live(self) -> int:
        return int(self.alive.sum())

    def live_ids(self) -> np.ndarray:
        return np.flatnonzero(self.alive)

    @property
    def distances(self) -> np.ndarray:
        """Current (C, C) distance matrix, copied to the host.  Exact when
        no deletions are pending; otherwise an elementwise lower bound on
        the live truth."""
        return self._dist.cpu().numpy()

    def distances_at(self, rows=slice(None), cols=slice(None)) -> np.ndarray:
        """``distances[rows, cols]`` copied to the host alone: an entry, a
        row or a column costs one small copy, not one of the whole (C, C)
        matrix."""
        return self._dist[rows, cols].cpu().numpy()

    def live_distances(self) -> np.ndarray:
        live = self.live_ids()
        return self.distances[np.ix_(live, live)]

    def diameter(self, exact: bool = False) -> float:
        """Largest-CC diameter of the maintained overlay, computed on the
        device and read with one ``float()``.  ``exact`` forces a rebuild
        first if deletions are pending."""
        if exact:
            self.refresh()
        return float(largest_cc_diameter(self._dist))

    # -- mutations --------------------------------------------------------

    def add_edge(self, u: int, v: int, weight: float | None = None) -> None:
        """Insert (or improve) the undirected edge (u, v)."""
        assert self.alive[u] and self.alive[v], (u, v)
        wuv = np.float32(self.w[u, v] if weight is None else weight)
        self.stats["events"] += 1
        if u == v or wuv >= self.adj[u, v]:
            return                        # no improvement: relax is a no-op
        self.adj[u, v] = self.adj[v, u] = wuv
        if self.mode == "full":
            self.rebuild()
            return
        with jit_span("incremental.relax", key=self.capacity):
            self._dist = relax_edge(self._dist, u, v, wuv)
        self.stats["relaxations"] += 1

    def remove_edge(self, u: int, v: int) -> None:
        """Delete the undirected edge (u, v); distances may go stale."""
        self.stats["events"] += 1
        if not is_edge(np.float32(self.adj[u, v])):
            return
        self.adj[u, v] = self.adj[v, u] = float(INF)
        self._note_deletion()

    def join(self, u: int, neighbours: Sequence[int],
             weights: Sequence[float] | None = None) -> None:
        """Activate slot ``u`` and attach it to live ``neighbours``."""
        assert not self.alive[u], u
        nbrs = np.asarray(list(neighbours), np.intp)
        assert self.alive[nbrs].all(), "attach edges must target live nodes"
        ws = (self.w[u, nbrs] if weights is None
              else np.asarray(list(weights), np.float32))
        self.alive[u] = True
        self.adj[u, nbrs] = np.minimum(self.adj[u, nbrs], ws)
        self.adj[nbrs, u] = self.adj[u, nbrs]
        self.stats["events"] += 1
        self.stats["joins"] += 1
        if self.mode == "full":
            self.rebuild()
            return
        row = np.full(self.capacity, float(INF), np.float32)
        row[nbrs] = self.adj[u, nbrs]
        with jit_span("incremental.join", key=self.capacity):
            self._dist = join_node(self._dist, upload(row, self.device),
                                   u)
        self.stats["relaxations"] += 1

    def leave(self, u: int) -> None:
        """Tombstone node ``u``: isolate it and count the deletion."""
        if not self.alive[u]:
            return
        self.alive[u] = False
        self.adj[u, :] = float(INF)
        self.adj[:, u] = float(INF)
        self.adj[u, u] = 0.0
        self.stats["events"] += 1
        self.stats["leaves"] += 1
        if self.mode != "full":        # full mode rebuilds anyway below
            with jit_span("incremental.tombstone", key=self.capacity):
                self._dist = tombstone(self._dist, u)
        self._note_deletion()

    def set_latency(self, u: int, v: int, ms: float) -> None:
        """Point latency change; decreases relax, increases count as stale.

        The increase/decrease split compares against the CURRENT edge
        weight (``adj``, which ``add_edge`` may have set below ``w``) —
        comparing against ``w`` could misread an edge-weight increase as a
        decrease and break the lower-bound contract."""
        ms = float(ms)
        self.w[u, v] = self.w[v, u] = ms
        if not is_edge(np.float32(self.adj[u, v])):
            return
        old_edge = float(self.adj[u, v])
        self.stats["events"] += 1
        self.adj[u, v] = self.adj[v, u] = np.float32(ms)
        if self.mode == "full":
            self.rebuild()
        elif ms < old_edge:
            with jit_span("incremental.relax", key=self.capacity):
                self._dist = relax_edge(self._dist, u, v, np.float32(ms))
            self.stats["relaxations"] += 1
        elif ms > old_edge:
            self._note_deletion()

    def apply_latency_matrix(self, new_w: np.ndarray) -> None:
        """Bulk latency change (e.g. diurnal drift): re-weight every existing
        edge and rebuild — a matrix-wide shift has no cheap exact repair."""
        new_w = np.asarray(new_w, np.float32)
        assert new_w.shape == self.w.shape
        self.w = new_w.copy()
        mask = is_edge(self.adj)
        self.adj = np.where(mask, new_w, self.adj).astype(np.float32)
        self.stats["events"] += 1
        self.rebuild()

    # -- rebuild machinery ------------------------------------------------

    def _note_deletion(self) -> None:
        self.pending_deletions += 1
        if self.mode == "full" or self.pending_deletions >= self.rebuild_threshold:
            self.rebuild()

    def rebuild(self) -> None:
        """Full from-scratch APSP over the live adjacency via the
        instrumented ``batcheval`` engine; resets the staleness counter.

        Precision is PINNED to float32 regardless of ambient
        ``eval_options`` / ``REPRO_APSP_*`` overrides: the incremental
        relaxations layered on top of this matrix assume an exact base
        (every served distance is "exact or lower bound"), so a quantized
        rebuild would silently poison that contract.  The adjacency goes
        up, the distances come back to the host (``apsp_matrices``'
        contract) and go up again as the maintained tensor, as in the
        reference.
        """
        with jit_span("incremental.rebuild", key=self.capacity):
            d = batcheval.apsp_matrices(self.adj[None], dtype="float32",
                                        device=self.device)[0]
            self._dist = upload(d, self.device)
        self.pending_deletions = 0
        self.stats["rebuilds"] += 1

    def refresh(self) -> None:
        """Restore exactness if deletions are pending."""
        if self.pending_deletions:
            self.rebuild()
