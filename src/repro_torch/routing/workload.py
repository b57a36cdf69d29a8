"""Seeded source/destination pair sampling for routing workloads.

Three traffic mixes, all returning a ``(P, 2)`` intp array of distinct
src/dst pairs from one ``numpy`` Generator (deterministic per seed):

* ``"uniform"`` — both endpoints uniform over the fleet (the classic
  all-to-all probe);
* ``"hotspot"`` — a small set of hot destinations receives
  ``hotspot_frac`` of the traffic (aggregation points, bootstrap seeds);
* ``"regional"`` — with probability ``locality`` the destination shares
  the source's FABRIC site (``i % N_FABRIC_SITES``, the same assignment
  ``core.topology`` and the regional churn scenarios use), modelling
  intra-site chatter with occasional cross-country hops.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.topology import N_FABRIC_SITES

__all__ = ["WORKLOADS", "sample_pairs"]

#: workload mixes, in the order fig19 reports them
WORKLOADS = ("uniform", "hotspot", "regional")


def _uniform_pair(rng: np.random.Generator, n: int) -> tuple:
    src = int(rng.integers(n))
    dst = int(rng.integers(n - 1))
    return src, dst + (dst >= src)          # uniform over the other n-1


def sample_pairs(n: int, n_pairs: int, kind: str = "uniform", *,
                 seed: int = 0, rng: np.random.Generator | None = None,
                 hotspots: int = 4, hotspot_frac: float = 0.8,
                 locality: float = 0.8) -> np.ndarray:
    """Sample ``n_pairs`` distinct src/dst pairs over ``n`` nodes."""
    if kind not in WORKLOADS:
        raise ValueError(f"unknown workload {kind!r}; options {WORKLOADS}")
    if n < 2:
        raise ValueError(f"need >= 2 nodes to sample pairs, got {n}")
    rng = np.random.default_rng(seed) if rng is None else rng
    pairs = np.empty((n_pairs, 2), np.intp)
    if kind == "uniform":
        for i in range(n_pairs):
            pairs[i] = _uniform_pair(rng, n)
        return pairs
    if kind == "hotspot":
        hot = rng.choice(n, size=min(int(hotspots), n), replace=False)
        for i in range(n_pairs):
            if rng.random() < hotspot_frac:
                dst = int(hot[rng.integers(len(hot))])
                src = int(rng.integers(n - 1))
                pairs[i] = src + (src >= dst), dst
            else:
                pairs[i] = _uniform_pair(rng, n)
        return pairs
    # regional: prefer a same-FABRIC-site destination
    site_of = np.arange(n) % N_FABRIC_SITES
    for i in range(n_pairs):
        src = int(rng.integers(n))
        mates = np.flatnonzero(site_of == site_of[src])
        mates = mates[mates != src]
        if mates.size and rng.random() < locality:
            pairs[i] = src, int(mates[rng.integers(mates.size)])
        else:
            dst = int(rng.integers(n - 1))
            pairs[i] = src, dst + (dst >= src)
    return pairs
