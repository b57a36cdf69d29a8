"""Lazy latency models — the (N, N) matrix N=10^5 cannot afford (a copy
of ``repro.hier.geo``: host numpy, no device work).

A flat N=10^5 float32 latency matrix is 40 GB; the hierarchical builder
never materializes it.  Instead it consumes a :class:`LatencyModel`: an
object that answers ``block(rows, cols)`` — the (R, C) latency submatrix
between two id sets — on demand.  Two implementations:

* :class:`DenseLatency` — wraps an existing (N, N) matrix (the small/mid-N
  path; every ``core.topology`` distribution and every :class:`Trace`
  world goes through this, so hierarchical and flat builds see identical
  numbers);
* :class:`SyntheticGeo` — the large-N synthetic-geo world: ``sites``
  random ground stations, nodes multinomially assigned with local
  coordinate jitter, latency = great-circle distance at 2/3 c + router
  overhead + both endpoints' processing latency (the same physical model
  as ``core.topology.fabric_latency``, minus the fixed 17-site table).
  O(N) state — coordinates and per-node processing times — and any block
  is computed vectorized on demand.

Both serialize to a small spec dict (``to_spec`` / :func:`latency_from_spec`)
so a :class:`~repro_torch.hier.HierarchicalOverlay` snapshot can restore its
world: dense specs embed the matrix, synthetic-geo specs embed only
``(n, sites, seed)`` and regenerate deterministically.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np

__all__ = ["LatencyModel", "DenseLatency", "SyntheticGeo", "SubsetLatency",
           "synthetic_geo", "as_latency", "latency_from_spec"]

# one-way propagation: great-circle km at 0.66 c, plus router/queuing
# overhead — identical constants to core.topology._greatcircle_ms
_KM_PER_MS = 0.66 * 299.79
_ROUTER_MS = 2.0


class LatencyModel:
    """Protocol-ish base: latency lookups over node-id sets, no (N, N)."""

    @property
    def n(self) -> int:
        raise NotImplementedError

    def block(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """(R, C) float32 latency submatrix (0 where the same node)."""
        raise NotImplementedError

    def pairs(self, us: np.ndarray, vs: np.ndarray) -> np.ndarray:
        """Elementwise latency for aligned id vectors."""
        us = np.asarray(us, np.intp)
        vs = np.asarray(vs, np.intp)
        out = np.empty(us.shape, np.float32)
        for i, (u, v) in enumerate(zip(us, vs)):
            out[i] = self.block(np.array([u]), np.array([v]))[0, 0]
        return out

    def dense(self) -> np.ndarray:
        """The full (N, N) matrix — small-N convenience only."""
        ids = np.arange(self.n)
        return self.block(ids, ids)

    def to_spec(self) -> Dict:
        raise NotImplementedError


class DenseLatency(LatencyModel):
    """A plain (N, N) matrix behind the lazy-block interface."""

    def __init__(self, w: np.ndarray):
        w = np.asarray(w, np.float32)
        if w.ndim != 2 or w.shape[0] != w.shape[1]:
            raise ValueError(f"w must be square, got shape {w.shape}")
        self.w = w

    @property
    def n(self) -> int:
        return self.w.shape[0]

    def block(self, rows, cols) -> np.ndarray:
        return self.w[np.ix_(np.asarray(rows, np.intp),
                             np.asarray(cols, np.intp))]

    def pairs(self, us, vs) -> np.ndarray:
        return self.w[np.asarray(us, np.intp), np.asarray(vs, np.intp)]

    def dense(self) -> np.ndarray:
        return self.w

    def to_spec(self) -> Dict:
        return {"kind": "dense",
                "w": [[float(x) for x in row] for row in self.w]}


class SyntheticGeo(LatencyModel):
    """Synthetic-geo world: O(N) coordinates, lazy great-circle blocks."""

    def __init__(self, n: int, *, sites: int = 64, seed: int = 0):
        if n < 1 or sites < 1:
            raise ValueError(f"need n >= 1 and sites >= 1, got {n}, {sites}")
        self._n = int(n)
        self.sites = int(sites)
        self.seed = int(seed)
        rng = np.random.default_rng(seed)
        # ground stations over the populated latitude band; node density per
        # site is Dirichlet-skewed (a few metros, many small sites)
        site_lon = rng.uniform(-180.0, 180.0, size=sites)
        site_lat = rng.uniform(-50.0, 65.0, size=sites)
        weights = rng.dirichlet(np.full(sites, 1.5))
        self.site_of = rng.choice(sites, size=n, p=weights).astype(np.int32)
        jitter = rng.normal(0.0, 1.5, size=(n, 2))
        self.coords = np.stack([site_lon[self.site_of] + jitter[:, 0],
                                site_lat[self.site_of] + jitter[:, 1]],
                               axis=1)
        self.proc_ms = np.clip(rng.normal(5.0, 1.0, size=n),
                               0.1, None).astype(np.float32)

    @property
    def n(self) -> int:
        return self._n

    def block(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, np.intp)
        cols = np.asarray(cols, np.intp)
        a, b = self.coords[rows], self.coords[cols]
        lon_a, lat_a = np.radians(a[:, 0])[:, None], np.radians(a[:, 1])[:, None]
        lon_b, lat_b = np.radians(b[:, 0])[None, :], np.radians(b[:, 1])[None, :]
        cosd = (np.sin(lat_a) * np.sin(lat_b)
                + np.cos(lat_a) * np.cos(lat_b) * np.cos(lon_a - lon_b))
        km = 6371.0 * np.arccos(np.clip(cosd, -1.0, 1.0))
        ms = (km / _KM_PER_MS + _ROUTER_MS
              + self.proc_ms[rows][:, None] + self.proc_ms[cols][None, :])
        ms[rows[:, None] == cols[None, :]] = 0.0
        return ms.astype(np.float32)

    def pairs(self, us, vs) -> np.ndarray:
        us = np.asarray(us, np.intp)
        vs = np.asarray(vs, np.intp)
        a, b = self.coords[us], self.coords[vs]
        lon_a, lat_a = np.radians(a[:, 0]), np.radians(a[:, 1])
        lon_b, lat_b = np.radians(b[:, 0]), np.radians(b[:, 1])
        cosd = (np.sin(lat_a) * np.sin(lat_b)
                + np.cos(lat_a) * np.cos(lat_b) * np.cos(lon_a - lon_b))
        km = 6371.0 * np.arccos(np.clip(cosd, -1.0, 1.0))
        ms = km / _KM_PER_MS + _ROUTER_MS + self.proc_ms[us] + self.proc_ms[vs]
        return np.where(us == vs, 0.0, ms).astype(np.float32)

    def to_spec(self) -> Dict:
        return {"kind": "synthetic-geo", "n": self._n, "sites": self.sites,
                "seed": self.seed}


class SubsetLatency(LatencyModel):
    """A reindexed view onto another model: new id ``i`` = base id ``ids[i]``.

    Produced by ``HierarchicalOverlay.subset`` so the surviving topology
    keeps lazy latency access without materializing anything.
    """

    def __init__(self, base: "LatencyModel", ids):
        self.base = base
        self.ids = np.asarray(ids, np.intp)
        if self.ids.size and (self.ids.min() < 0 or self.ids.max() >= base.n):
            raise ValueError(
                f"subset ids must lie in [0, {base.n}), got range "
                f"[{self.ids.min()}, {self.ids.max()}]")

    @property
    def n(self) -> int:
        return self.ids.size

    def block(self, rows, cols) -> np.ndarray:
        return self.base.block(self.ids[np.asarray(rows, np.intp)],
                               self.ids[np.asarray(cols, np.intp)])

    def pairs(self, us, vs) -> np.ndarray:
        return self.base.pairs(self.ids[np.asarray(us, np.intp)],
                               self.ids[np.asarray(vs, np.intp)])

    def to_spec(self) -> Dict:
        return {"kind": "subset", "ids": [int(i) for i in self.ids],
                "base": self.base.to_spec()}


def synthetic_geo(n: int, *, sites: int = 64, seed: int = 0) -> SyntheticGeo:
    """The fig21 large-N world (deterministic in ``seed``)."""
    return SyntheticGeo(n, sites=sites, seed=seed)


def as_latency(x: Union[LatencyModel, np.ndarray, Sequence]) -> LatencyModel:
    """Coerce a dense matrix to :class:`DenseLatency`; pass models through."""
    if isinstance(x, LatencyModel):
        return x
    return DenseLatency(np.asarray(x, np.float32))


def latency_from_spec(d: Dict) -> LatencyModel:
    """Inverse of ``to_spec`` (snapshot restore)."""
    kind = d.get("kind")
    if kind == "dense":
        return DenseLatency(np.asarray(d["w"], np.float32))
    if kind == "synthetic-geo":
        return SyntheticGeo(int(d["n"]), sites=int(d["sites"]),
                            seed=int(d["seed"]))
    if kind == "subset":
        return SubsetLatency(latency_from_spec(d["base"]), d["ids"])
    raise ValueError(f"unknown latency spec kind {kind!r}")
