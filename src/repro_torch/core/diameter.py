"""Diameter / APSP primitives (torch port of ``repro.core.diameter``).

* ``apsp`` / ``diameter``: min-plus matrix-squaring APSP (O(N^3 log N)) on
  tensors; each squaring is ``kernels.minplus.ops.minplus`` -- the CUDA
  kernel K1 with a batch of one on the card, its plain twin on the CPU.
* ``diameter_scipy``: host-side Dijkstra oracle (scipy csgraph).

Graph assembly stays numpy, as in the reference.  Disconnected graphs
follow the paper (§IV-C): "the diameter of the largest connected component
is adopted".
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.minplus import ops as minplus_ops

INF = np.float32(1e9)  # finite "infinity": avoids inf-inf NaN in min-plus

__all__ = [
    "INF",
    "is_edge",
    "neighbour_lists",
    "adjacency_from_edges",
    "ring_edges",
    "adjacency_from_rings",
    "minplus",
    "apsp",
    "relax_edge_update",
    "largest_cc_diameter",
    "diameter",
    "diameter_of_rings",
    "diameter_scipy",
]


# ---------------------------------------------------------------------------
# graph assembly (host)
# ---------------------------------------------------------------------------

def is_edge(adj):
    """Boolean mask of actual edges in a weighted adjacency matrix: strictly
    positive (excludes the 0 diagonal) and below ``INF / 2``.  Works on
    numpy arrays and torch tensors alike."""
    return (adj > 0) & (adj < float(INF) / 2)


def neighbour_lists(adj: np.ndarray) -> list:
    """Per-node neighbour index lists, from one vectorized ``is_edge`` pass."""
    mask = np.asarray(is_edge(adj))
    return [np.flatnonzero(mask[u]) for u in range(mask.shape[0])]


def ring_edges(perm: np.ndarray) -> np.ndarray:
    """Edges of the ring perm[0] -> perm[1] -> ... -> perm[-1] -> perm[0]."""
    perm = np.asarray(perm)
    return np.stack([perm, np.roll(perm, -1)], axis=1)


def adjacency_from_edges(w: np.ndarray,
                         edges: Iterable[Sequence[int]]) -> np.ndarray:
    """Weighted adjacency with INF on non-edges, 0 diagonal (undirected);
    parallel edges keep the min weight."""
    n = w.shape[0]
    d = np.full((n, n), float(INF), dtype=np.float32)
    np.fill_diagonal(d, 0.0)
    e = np.asarray(edges if isinstance(edges, np.ndarray) else list(edges),
                   dtype=np.intp).reshape(-1, 2)
    if e.size:
        if e.min() < 0 or e.max() >= n:
            raise ValueError(
                f"edge endpoints must lie in [0, {n}); got range "
                f"[{e.min()}, {e.max()}]")
        u, v = e[:, 0], e[:, 1]
        np.minimum.at(d, (u, v), w[u, v].astype(np.float32))
        np.minimum.at(d, (v, u), w[v, u].astype(np.float32))
    return d


def adjacency_from_rings(w: np.ndarray,
                         perms: Sequence[np.ndarray]) -> np.ndarray:
    """Union of K rings as a weighted adjacency matrix; every ring must be
    a permutation of ``range(n)``."""
    n = w.shape[0]
    ident = np.arange(n)
    for i, p in enumerate(perms):
        p = np.asarray(p)
        if p.shape != (n,) or not np.array_equal(np.sort(p), ident):
            raise ValueError(
                f"ring {i} is not a permutation of range({n}): "
                f"shape {p.shape}, unique {np.unique(p).size}")
    edges = np.concatenate([ring_edges(p) for p in perms], axis=0)
    return adjacency_from_edges(w, edges)


# ---------------------------------------------------------------------------
# min-plus APSP on tensors
# ---------------------------------------------------------------------------

def minplus(a: torch.Tensor, b: torch.Tensor, *,
            use_kernel: bool = False) -> torch.Tensor:
    """(A ⊗ B)[i,j] = min_k A[i,k] + B[k,j] — the tropical-semiring matmul,
    in float32.

    Dispatch is by the operands' device, as everywhere in the port: CUDA
    tensors run ``kernels.minplus.ops.minplus`` (the kernel K1 with a batch
    of one), CPU tensors its plain twin.  ``use_kernel`` is the reference's
    keyword (it picks the Pallas kernel there) and changes nothing here:
    both give the same bits, a min over the same sums being exact."""
    del use_kernel
    return minplus_ops.minplus(a, b)


def apsp(adj: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths of one (N, N) adjacency (0 diag, INF
    non-edges) by ceil(log2(N-1)) min-plus squarings, in float32."""
    n = adj.shape[0]
    n_iters = max(1, int(np.ceil(np.log2(max(n - 1, 2)))))
    d = adj
    for _ in range(n_iters):
        d = minplus(d, d)
    return d


def relax_edge_update(dist: torch.Tensor, u, v, wuv) -> torch.Tensor:
    """Exact O(N^2) repair of an APSP matrix after inserting edge (u, v):
    ``D' = min(D, D[:,u] + w + D[v,:], D[:,v] + w + D[u,:])``.

    One (N, N) matrix with scalar ``u``, ``v``, ``wuv``, or a (B, N, N)
    stack with (B,) index and weight tensors (gathers: no host sync)."""
    if dist.dim() == 2:
        def one(x, dtype):
            return torch.full((1,), x, dtype=dtype, device=dist.device)
        return relax_edge_update(dist[None], one(int(u), torch.int64),
                                 one(int(v), torch.int64),
                                 one(float(wuv), dist.dtype))[0]
    b, n = dist.shape[0], dist.shape[-1]

    def col(i):
        return dist.gather(2, i[:, None, None].expand(b, n, 1))

    def row(i):
        return dist.gather(1, i[:, None, None].expand(b, 1, n))

    w = wuv[:, None, None]
    return torch.minimum(dist, torch.minimum(col(u) + w + row(v),
                                             col(v) + w + row(u)))


def largest_cc_diameter(d: torch.Tensor) -> torch.Tensor:
    """Diameter of the largest connected component given APSP distances
    (paper §IV-C), for one (N, N) matrix or a (B, N, N) stack.

    Widens to float32 first (bf16 rounds the 1e9 sentinel to ~9.98e8,
    still above the ``INF / 2`` threshold).  The anchor is the FIRST node
    of maximal component size, as ``jnp.argmax`` picks it: on equal
    component sizes another anchor would give another diameter.
    """
    d = d.float()
    finite = d < float(INF) / 2
    sizes = finite.sum(dim=-1)                              # (..., N)
    n = sizes.shape[-1]
    idx = torch.arange(n, device=d.device).expand_as(sizes)
    first = torch.where(sizes == sizes.amax(dim=-1, keepdim=True), idx, n)
    anchor = first.amin(dim=-1, keepdim=True)               # (..., 1)
    mask = torch.take_along_dim(finite, anchor[..., None], dim=-2)[..., 0, :]
    pair = mask[..., :, None] & mask[..., None, :]
    return torch.where(pair, d, 0.0).amax(dim=(-2, -1))


def diameter(adj: torch.Tensor) -> torch.Tensor:
    """Weighted diameter of the largest connected component (paper §IV-C)."""
    return largest_cc_diameter(apsp(adj))


def diameter_of_rings(w: np.ndarray, perms: Sequence[np.ndarray], *,
                      device=None) -> float:
    """Diameter of the union-of-rings overlay, via min-plus squaring on
    ``device`` (``repro_torch.device`` rule: CUDA unless asked for CPU)."""
    adj = torch.from_numpy(adjacency_from_rings(w, perms))
    return float(diameter(adj.to(resolve_device(device))))


# ---------------------------------------------------------------------------
# scipy oracle (host)
# ---------------------------------------------------------------------------

def diameter_scipy(adj: np.ndarray) -> float:
    """Host-side oracle: Dijkstra over the sparse overlay."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components, dijkstra

    adj = np.asarray(adj, dtype=np.float64)
    sp = csr_matrix(np.where(is_edge(adj), adj, 0.0))
    ncomp, labels = connected_components(sp, directed=False)
    if ncomp > 1:
        largest = np.bincount(labels).argmax()
        keep = np.flatnonzero(labels == largest)
        sp = sp[np.ix_(keep, keep)]
    dist = dijkstra(sp, directed=False)
    return float(dist.max())
