"""Meshes of ranks, with DGRO-optimized host ordering (torch port of
``repro.launch.mesh``).

A :class:`Mesh` is a grid of global ranks with named axes: rank d stands
for JAX's device id d.  It is a plan, built without a process group; its
:meth:`Mesh.group` makes the ``torch.distributed`` groups of one axis when
the ranks run, each holding its members in grid order along the axis --
the ring order the collectives (``repro_torch.distributed``,
``train.collectives``) hop in.

``make_production_mesh`` builds the JAX package's meshes:
  * single-pod: (16, 16) over ("data", "model") -- 256 ranks;
  * multi-pod:  (2, 16, 16) over ("pod", "data", "model") -- 512 ranks.

**DGRO integration.**  The axes that cross hosts or pods run their ring
collectives over the data-centre network, where the hop order is the
software's choice.  ``dgro_host_order`` picks that order from a
host-to-host latency matrix by the paper's §V selection (rho -> random or
nearest ring, whichever has the smaller diameter), and
``make_production_mesh(dgro_order=True)`` permutes the DCN-facing rows of
the grid by it, leaving the ``model`` axis in hardware order.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from .. import distributed as D
from ..core.construction import nearest_ring, random_ring
from ..core.diameter import adjacency_from_rings, diameter_scipy
from ..core.selection import (clustering_ratio, measure_latency_stats,
                              select_ring_kind)

__all__ = ["Mesh", "dgro_host_order", "model_dcn_latency", "make_eval_mesh",
           "make_production_mesh"]

Axes = Union[str, Sequence[str]]


class Mesh:
    """A grid of global ranks over named axes.

    ``shape`` is an ordered name -> size mapping, as
    ``jax.sharding.Mesh.shape`` is.  :meth:`group` needs a process group
    whose world is exactly the mesh's ranks; everything else is a plan."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"a {self.ranks.ndim}-d grid cannot take the "
                             f"axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if sorted(self.ranks.flat) != list(range(self.ranks.size)):
            raise ValueError("a mesh holds each of the ranks 0..size-1 once")
        self._groups: Dict[Tuple[str, ...], D.Group] = {}

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise KeyError(f"no axis {a!r} in {self.axis_names}")
        return axes

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def coords(self, rank: int) -> Tuple[int, ...]:
        hit = np.argwhere(self.ranks == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not in the mesh")
        return tuple(int(c) for c in hit[0])

    def axis_index(self, axes: Axes) -> int:
        """This process's index along ``axes`` (row-major over several)."""
        axes = self._axes(axes)
        c = self.coords(D.rank())
        idx = [c[self.axis_names.index(a)] for a in axes]
        return int(np.ravel_multi_index(idx, [self.shape[a] for a in axes]))

    def lines(self, axes: Axes) -> np.ndarray:
        """(n_lines, size along ``axes``) global ranks: each row the ranks
        that share every other coordinate, in grid order along ``axes``
        (row-major over several)."""
        axes = self._axes(axes)
        rest = [a for a in self.axis_names if a not in axes]
        perm = [self.axis_names.index(a) for a in rest + list(axes)]
        return self.ranks.transpose(perm).reshape(-1, self.axis_size(axes))

    def group(self, axes: Axes) -> D.Group:
        """This rank's :class:`repro_torch.distributed.Group` along
        ``axes``, its members in grid order.  The first call for ``axes``
        makes every line's group, in one fixed order, so every rank must
        make it (as every collective entry point is called by every rank);
        later calls return the cached group.  Raises where the process
        group's world is not the mesh."""
        axes = self._axes(axes)
        if D.world_size() != self.size:
            raise ValueError(
                f"the mesh holds {self.size} ranks but the process group "
                f"has {D.world_size()}: start one rank per mesh position")
        if axes not in self._groups:
            mine = None
            me = D.rank()
            for line in self.lines(axes):
                g = D.new_group(line.tolist())
                if me in g.ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)})"


def dgro_host_order(latency: np.ndarray, seed: int = 0,
                    eps: float = 0.3) -> Tuple[np.ndarray, dict]:
    """DGRO ring order for ``n`` hosts given a latency matrix.

    Applies the paper's adaptive selection: measure rho on a probe (random)
    ring; if the latency field is informative (rho high) try the nearest
    ring too, and keep the candidate with the smaller diameter.  Returns
    (order, report)."""
    n = latency.shape[0]
    rng = np.random.default_rng(seed)
    probe = random_ring(rng, n)
    adj = adjacency_from_rings(latency, [probe])
    stats = measure_latency_stats(latency, adj, seed=seed)
    rho = clustering_ratio(stats)
    kind = select_ring_kind(rho, eps)
    candidates = {"random": probe}
    if kind in ("nearest", "keep"):
        candidates["nearest"] = nearest_ring(latency, start=0)
    best_kind, best_order, best_diam = None, None, float("inf")
    for k, order in candidates.items():
        d = diameter_scipy(adjacency_from_rings(latency, [order]))
        if d < best_diam:
            best_kind, best_order, best_diam = k, order, d
    report = {
        "rho": rho, "selected": best_kind, "diameter": best_diam,
        "random_diameter": diameter_scipy(adjacency_from_rings(latency,
                                                               [probe])),
    }
    return best_order, report


def model_dcn_latency(n_hosts: int, n_pods: int = 1,
                      seed: int = 0) -> np.ndarray:
    """Synthetic DCN host latency model: intra-pod ~10us, cross-pod ~80us,
    plus per-host jitter -- the stand-in for Alg. 3 measurements."""
    rng = np.random.default_rng(seed)
    pod_of = np.arange(n_hosts) // max(1, n_hosts // n_pods)
    base = np.where(pod_of[:, None] == pod_of[None, :], 10.0, 80.0)
    jitter = rng.gamma(2.0, 1.5, size=(n_hosts, n_hosts))
    lat = np.triu(base + jitter, 1)
    lat = lat + lat.T
    np.fill_diagonal(lat, 0.0)
    return lat.astype(np.float32)


def make_eval_mesh(n: Optional[int] = None, axis: str = "batch") -> Mesh:
    """1-D mesh over the first ``min(n or world, world)`` ranks, for
    sharded bulk evaluation (``batcheval.diameters_sharded`` /
    ``apsp_rowshard``).  Without a process group the world is one rank."""
    world = D.world_size()
    k = min(n or world, world)
    return Mesh(np.arange(k), (axis,))


def make_production_mesh(*, multi_pod: bool = False, dgro_order: bool = False,
                         latency: Optional[np.ndarray] = None,
                         chips_per_host: int = 4) -> Mesh:
    """The production mesh (optionally DGRO-ordered), as a plan of ranks.

    With ``dgro_order``, the rows of the grid along the leading
    (DCN-facing) axes are permuted by the DGRO ring over those rows, each
    row standing for a host; the trailing ``model`` axis stays in hardware
    order.  ``chips_per_host`` is unused: it is kept only to match the
    reference's signature, whose grid ignores it too.  The report stays on
    the mesh as ``dgro_report``."""
    del chips_per_host
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    ranks = np.arange(n)
    if not dgro_order:
        return Mesh(ranks.reshape(shape), axes)
    n_model = shape[-1]
    n_dcn = n // n_model                       # pod*data rows, one a host
    lat = latency if latency is not None else model_dcn_latency(
        n_dcn, n_pods=shape[0] if multi_pod else 1)
    order, report = dgro_host_order(lat)
    grid = ranks.reshape(n_dcn, n_model)[order]
    mesh = Mesh(grid.reshape(shape), axes)
    mesh.dgro_report = report
    return mesh
