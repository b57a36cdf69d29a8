"""Latency-matrix generators for the four distributions evaluated in the paper.

The paper (§VII-A) evaluates DGRO on:
  * Uniform{1..10}            (synthetic)
  * Gaussian N(5, 1)          (synthetic)
  * FABRIC   (17 physical sites: 14 US, 1 JP, 2 EU; per-node jitter N(5,1))
  * Bitnode  (nodes sampled over 7 geographic regions, iPlane latencies)

All generators return a symmetric (n, n) float32 latency matrix with zero
diagonal, in milliseconds (WAN).  A numpy copy of ``repro.core.topology``
(the port imports nothing of ``repro``); the tests hold the two
bit-identical for every distribution.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "uniform_latency",
    "gaussian_latency",
    "fabric_latency",
    "bitnode_latency",
    "make_latency",
    "DISTRIBUTIONS",
    "N_FABRIC_SITES",
]


def _symmetrize(m: np.ndarray) -> np.ndarray:
    out = np.triu(m, 1)
    out = out + out.T
    np.fill_diagonal(out, 0.0)
    return out.astype(np.float32)


def uniform_latency(rng: np.random.Generator, n: int) -> np.ndarray:
    """X ~ Uniform{1, 2, ..., 10} (paper §VII-A.1)."""
    m = rng.integers(1, 11, size=(n, n)).astype(np.float32)
    return _symmetrize(m)


def gaussian_latency(rng: np.random.Generator, n: int) -> np.ndarray:
    """Y ~ N(5, 1), clipped to be strictly positive (paper §VII-A.1)."""
    m = rng.normal(5.0, 1.0, size=(n, n)).astype(np.float32)
    m = np.clip(m, 0.1, None)
    return _symmetrize(m)


# --- FABRIC ----------------------------------------------------------------
# 17 sites: 14 across the US, 1 in Japan, 2 in Europe (paper §VII-A.1).  We
# model inter-site one-way latency from great-circle distance at ~2/3 c plus a
# small router overhead; coordinates approximate the public FABRIC sites.
_FABRIC_SITES = np.array([
    # lon, lat
    (-122.27, 37.87),   # UCSD/SDSC-ish west coast
    (-122.06, 36.97),
    (-118.24, 34.05),   # LA
    (-111.89, 40.76),   # SLC
    (-104.99, 39.74),   # Denver
    (-96.80, 32.78),    # Dallas
    (-95.37, 29.76),    # Houston
    (-87.63, 41.88),    # Chicago (StarLight)
    (-86.16, 39.77),    # Indiana
    (-84.39, 33.75),    # Atlanta
    (-77.04, 38.91),    # Washington DC
    (-74.01, 40.71),    # New York
    (-71.06, 42.36),    # Boston
    (-122.33, 47.61),   # Seattle
    (139.69, 35.69),    # Tokyo
    (-0.13, 51.51),     # London
    (8.68, 50.11),      # Frankfurt
], dtype=np.float64)

# node i is assigned to site i % N_FABRIC_SITES (see fabric_latency);
# regional churn scenarios rely on the same assignment
N_FABRIC_SITES = len(_FABRIC_SITES)


def _greatcircle_ms(coords: np.ndarray) -> np.ndarray:
    lon = np.radians(coords[:, 0])[:, None]
    lat = np.radians(coords[:, 1])[:, None]
    dlon = lon - lon.T
    cosd = np.sin(lat) * np.sin(lat.T) + np.cos(lat) * np.cos(lat.T) * np.cos(dlon)
    dist_km = 6371.0 * np.arccos(np.clip(cosd, -1.0, 1.0))
    # one-way latency: distance / (0.66 c) + 2 ms router/queuing overhead
    ms = dist_km / (0.66 * 299.79) + 2.0
    np.fill_diagonal(ms, 0.0)
    return ms


def fabric_latency(rng: np.random.Generator, n: int) -> np.ndarray:
    """FABRIC model: latency(u, v) = site_latency(i, j) + jitter(u) + jitter(v).

    Nodes are assigned round-robin to the 17 sites (paper: 1..58 nodes per
    site); per-node response times ~ N(5, 1) (paper §VII-A.3).
    """
    site_ms = _greatcircle_ms(_FABRIC_SITES)
    site_of = np.arange(n) % len(_FABRIC_SITES)
    node_ms = np.clip(rng.normal(5.0, 1.0, size=n), 0.1, None)
    m = site_ms[np.ix_(site_of, site_of)] + node_ms[:, None] + node_ms[None, :]
    # intra-site pairs still pay both endpoints' processing latency
    return _symmetrize(m)


# --- Bitnode ---------------------------------------------------------------
# 7 regions (paper: North America, South America, Europe, Asia, Africa,
# China, Oceania) with an iPlane-style inter-region RTT/2 table (ms).
_BITNODE_REGIONS = ["NA", "SA", "EU", "AS", "AF", "CN", "OC"]
_BITNODE_WEIGHTS = np.array([0.32, 0.04, 0.36, 0.12, 0.02, 0.06, 0.08])
_BITNODE_MS = np.array([
    #  NA    SA    EU    AS    AF    CN    OC
    [ 20.0,  75., 45.0,  90., 120.,  95., 80.],   # NA
    [ 75.0,  25., 95.0, 160., 150., 170., 140.],  # SA
    [ 45.0,  95., 12.0,  80.,  70., 110., 130.],  # EU
    [ 90.0, 160., 80.0,  30.,  130., 50., 65.],   # AS
    [120.0, 150., 70.0, 130.,  40., 150., 160.],  # AF
    [ 95.0, 170., 110.,  50., 150.,  18., 90.],   # CN
    [ 80.0, 140., 130.,  65., 160.,  90., 15.],   # OC
], dtype=np.float64)


def bitnode_latency(rng: np.random.Generator, n: int) -> np.ndarray:
    """Bitnode model: nodes sampled over 7 geographic regions (paper §VII-A)."""
    region_of = rng.choice(len(_BITNODE_REGIONS), size=n, p=_BITNODE_WEIGHTS)
    base = _BITNODE_MS[np.ix_(region_of, region_of)]
    jitter = rng.gamma(2.0, 2.5, size=(n, n))  # heavy-ish tail, last-mile variance
    return _symmetrize(base + jitter)


DISTRIBUTIONS = {
    "uniform": uniform_latency,
    "gaussian": gaussian_latency,
    "fabric": fabric_latency,
    "bitnode": bitnode_latency,
}


def make_latency(dist: str, n: int, seed: int = 0) -> np.ndarray:
    """Build an (n, n) latency matrix for a named distribution."""
    try:
        fn = DISTRIBUTIONS[dist]
    except KeyError:
        raise ValueError(f"unknown distribution {dist!r}; options {list(DISTRIBUTIONS)}")
    return fn(np.random.default_rng(seed), n)
