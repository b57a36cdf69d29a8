"""Per-policy overlay builders + their config dataclasses.

One builder per topology policy the paper evaluates; each maps to a paper
section (see ``repro_torch.overlay.__doc__`` for the table).  The builders
are copies of ``repro.overlay.policies``: with the same generator they draw
the same rings, and the ones that score candidates (``"dgro"``, ``"ga"``,
``"parallel"`` with the scored stitch) do so through the port's
``batcheval``.  ``"dgro-dqn"`` initialises its Q-network from a
``torch.Generator`` (the reference draws with ``jax.random``), so its rings
match the reference's only with the reference's parameters carried across.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import batcheval
from repro_torch.core.construction import (default_num_rings, k_rings,
                                           nearest_ring, random_ring)
from repro_torch.core.ga import GAConfig, evolve
from repro_torch.core.selection import (clustering_ratio,
                                        measure_latency_stats,
                                        select_ring_kind)

from .core import Overlay
from .registry import register

__all__ = [
    "RandomRingsConfig", "NearestRingsConfig", "ChordConfig", "RapidConfig",
    "PerigeeConfig", "DGROConfig", "DGRODQNConfig", "GAConfig",
    "ParallelConfig", "KleinbergConfig", "PapillonConfig",
    "chord_finger_edges", "nearest_neighbour_edges",
]


# ---------------------------------------------------------------------------
# shared edge rules (also used by dynamics.engine join repairs)
# ---------------------------------------------------------------------------

def chord_finger_edges(ring: Sequence[int], pos: int) -> List[Tuple[int, int]]:
    """Chord finger edges of the node at ring position ``pos``: one edge to
    the 2^j-th successor for every 2^j < n (Stoica et al. 2001)."""
    n = len(ring)
    u = int(ring[pos])
    edges = []
    j = 1
    while (1 << j) < n:
        edges.append((u, int(ring[(pos + (1 << j)) % n])))
        j += 1
    return edges


def nearest_neighbour_edges(w: np.ndarray, candidates: np.ndarray, u: int,
                            degree: int) -> List[Tuple[int, int]]:
    """Perigee rule: ``u``'s ``degree`` lowest-latency peers among
    ``candidates`` (Mao et al. 2020).  Stable sort keeps ties deterministic."""
    candidates = np.asarray(candidates)
    others = candidates[candidates != u]
    order = others[np.argsort(w[u, others], kind="stable")]
    return [(int(u), int(v)) for v in order[:degree]]


def _connectivity_ring(kind: str, w: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    """The one connectivity ring Chord / Perigee embed: "random" (stock
    consistent-hash) or "nearest" (the swap DGRO's selection applies)."""
    if kind == "random":
        return random_ring(rng, w.shape[0])
    if kind == "nearest":
        return nearest_ring(w, start=int(rng.integers(w.shape[0])))
    raise ValueError(f"unknown ring kind {kind!r}; options ('random', "
                     f"'nearest')")


# ---------------------------------------------------------------------------
# baseline rings (§IV-B constructors as stand-alone topologies)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RandomRingsConfig:
    """K consistent-hash (uniformly random) rings; K defaults to ceil(log2 N)
    (the paper's per-node log(N) connection budget)."""
    k: Optional[int] = None


def _k_random_rings(w: np.ndarray, k: Optional[int],
                    rng: np.random.Generator, policy: str) -> Overlay:
    n = w.shape[0]
    k = default_num_rings(n) if k is None else k
    return Overlay.from_rings(w, [random_ring(rng, n) for _ in range(k)],
                              policy=policy)


@register("random", config=RandomRingsConfig)
def _build_random(w: np.ndarray, cfg: RandomRingsConfig,
                  rng: np.random.Generator) -> Overlay:
    return _k_random_rings(w, cfg.k, rng, "random")


@dataclasses.dataclass(frozen=True)
class NearestRingsConfig:
    """K greedy nearest-neighbour ("shortest", §V last ¶) rings from random
    start nodes."""
    k: int = 1


@register("nearest", config=NearestRingsConfig)
def _build_nearest(w: np.ndarray, cfg: NearestRingsConfig,
                   rng: np.random.Generator) -> Overlay:
    n = w.shape[0]
    starts = rng.integers(0, n, size=cfg.k)
    return Overlay.from_rings(
        w, [nearest_ring(w, start=int(s)) for s in starts], policy="nearest")


# ---------------------------------------------------------------------------
# protocol baselines (§V-A, §VII)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChordConfig:
    """Identifier ring + power-of-two fingers; ``ring`` picks the
    connectivity ring kind ("random" = stock Chord, "nearest" = the swap
    DGRO's selection applies in Figs. 7/11/15)."""
    ring: str = "random"


@register("chord", config=ChordConfig)
def _build_chord(w: np.ndarray, cfg: ChordConfig,
                 rng: np.random.Generator) -> Overlay:
    n = w.shape[0]
    perm = _connectivity_ring(cfg.ring, w, rng)
    fingers = [e for pos in range(n) for e in chord_finger_edges(perm, pos)]
    return Overlay(w, (perm,), np.asarray(fingers, np.intp).reshape(-1, 2),
                   policy="chord")


@dataclasses.dataclass(frozen=True)
class RapidConfig:
    """K independent consistent-hash rings (Suresh et al. 2018); K defaults
    to ceil(log2 N)."""
    k: Optional[int] = None


@register("rapid", config=RapidConfig)
def _build_rapid(w: np.ndarray, cfg: RapidConfig,
                 rng: np.random.Generator) -> Overlay:
    return _k_random_rings(w, cfg.k, rng, "rapid")


@dataclasses.dataclass(frozen=True)
class PerigeeConfig:
    """Per-node ``degree`` lowest-latency neighbours + one connectivity ring
    ("the paper always combines Perigee with a ring"); ``degree`` defaults
    to ceil(log2 N)."""
    degree: Optional[int] = None
    ring: str = "random"


@register("perigee", config=PerigeeConfig)
def _build_perigee(w: np.ndarray, cfg: PerigeeConfig,
                   rng: np.random.Generator) -> Overlay:
    n = w.shape[0]
    degree = default_num_rings(n) if cfg.degree is None else cfg.degree
    everyone = np.arange(n)
    edges = [e for u in range(n)
             for e in nearest_neighbour_edges(w, everyone, u, degree)]
    ring = _connectivity_ring(cfg.ring, w, rng)
    return Overlay(w, (ring,), np.asarray(edges, np.intp).reshape(-1, 2),
                   policy="perigee")


# ---------------------------------------------------------------------------
# routing-native small-world baselines (repro.routing workloads)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KleinbergConfig:
    """Navigable small world (Kleinberg 2000): a base connectivity ring
    plus ``q`` long links per node, drawn with probability proportional to
    ``ringdist^-exponent`` (exponent 1 is the harmonic distribution — the
    greedy-routable optimum for a 1-D ring).  ``q`` defaults to
    ceil(log2 N), matching the paper's per-node connection budget."""
    q: Optional[int] = None
    exponent: float = 1.0
    ring: str = "random"


@register("kleinberg", config=KleinbergConfig)
def _build_kleinberg(w: np.ndarray, cfg: KleinbergConfig,
                     rng: np.random.Generator) -> Overlay:
    n = w.shape[0]
    perm = _connectivity_ring(cfg.ring, w, rng)
    if n <= 3:                       # the ring already connects everyone
        return Overlay(w, (perm,), None, policy="kleinberg")
    q = default_num_rings(n) if cfg.q is None else cfg.q
    offsets = np.arange(2, n - 1)    # ring edges already cover offsets 1, n-1
    p = np.minimum(offsets, n - offsets) ** -float(cfg.exponent)
    p /= p.sum()
    edges = [(int(perm[pos]), int(perm[(pos + int(off)) % n]))
             for pos in range(n)
             for off in rng.choice(offsets, size=q, p=p)]
    return Overlay(w, (perm,), np.asarray(edges, np.intp).reshape(-1, 2),
                   policy="kleinberg")


@dataclasses.dataclass(frozen=True)
class PapillonConfig:
    """Papillon-style cyclic butterfly (Abraham, Malkhi & Manku 2005):
    with arity ``k`` and L = ceil(log_k N) levels, the node at ring
    position ``i`` (level ``i mod L``) adds deterministic long links to
    positions ``i + j * k^(L-1-level)`` for j = 1..k — bounded degree
    (2 ring + 2k long links), no randomness beyond the ring itself, and
    ring-distance-greedy routable in O(log N) hops."""
    k: int = 2
    ring: str = "random"


@register("papillon", config=PapillonConfig)
def _build_papillon(w: np.ndarray, cfg: PapillonConfig,
                    rng: np.random.Generator) -> Overlay:
    if cfg.k < 2:
        raise ValueError(f"papillon arity k must be >= 2, got {cfg.k}")
    n = w.shape[0]
    perm = _connectivity_ring(cfg.ring, w, rng)
    levels = max(1, int(np.ceil(np.log(max(n, 2)) / np.log(cfg.k))))
    edges = []
    for pos in range(n):
        stride = cfg.k ** (levels - 1 - (pos % levels))
        for j in range(1, cfg.k + 1):
            tgt = (pos + j * stride) % n
            if tgt != pos:
                edges.append((int(perm[pos]), int(perm[tgt])))
    extra = np.asarray(edges, np.intp).reshape(-1, 2) if edges else None
    return Overlay(w, (perm,), extra, policy="papillon")


# ---------------------------------------------------------------------------
# DGRO adaptive construction (§V) and search baselines (§VII-A.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DGROConfig:
    """rho-guided mixed-ring construction: measure the clustering ratio on a
    random probe overlay (Alg. 3), shortlist random/nearest ring mixes near
    the indicated regime, keep the best diameter (scored in ONE batched
    device call).  ``k`` defaults to ceil(log2 N) rings."""
    k: Optional[int] = None
    n_candidates: int = 4
    eps: float = 0.3
    stats_seed: int = 0


@register("dgro", config=DGROConfig)
def _build_dgro(w: np.ndarray, cfg: DGROConfig,
                rng: np.random.Generator) -> Overlay:
    n = w.shape[0]
    k = default_num_rings(n) if cfg.k is None else cfg.k
    probe = Overlay.from_rings(w, k_rings(w, k, "random", rng), policy="dgro")
    if n >= 4:        # the gossip sampler needs >= k random peers per node
        stats = measure_latency_stats(w, probe.adjacency, seed=cfg.stats_seed)
        rho = clustering_ratio(stats)
    else:
        rho = 0.5
    kind = select_ring_kind(rho, cfg.eps)
    if kind == "nearest":      # too random -> mostly nearest rings
        ms = range(0, min(2, k) + 1)
    elif kind == "random":     # too clustered -> mostly random rings
        ms = range(max(0, k - 2), k + 1)
    else:
        ms = range(0, k + 1, max(1, k // cfg.n_candidates))
    candidates = [k_rings(w, k, f"mixed:{m}", rng) for m in ms]
    scores = batcheval.diameters_of_rings(w, np.stack(
        [np.stack(rings) for rings in candidates]))
    best = candidates[int(np.argmin(scores))]
    return Overlay.from_rings(w, best,
                              policy="dgro").cache_diameter(scores.min())


@dataclasses.dataclass(frozen=True)
class DGRODQNConfig:
    """§IV Algs. 1-2: train the deep-Q ring constructor on graphs of the
    target size and distribution, then keep the best of ``n_starts``
    greedy constructions, all built in one batched rollout
    (``repro_torch.core.rollout``).  ``rollout="host"`` switches to the
    step-by-step debug loop."""
    k: Optional[int] = None
    epochs: int = 60
    n_starts: int = 10
    dist: str = "uniform"
    rollout: str = "device"


@register("dgro-dqn", config=DGRODQNConfig)
def _build_dgro_dqn(w: np.ndarray, cfg: DGRODQNConfig,
                    rng: np.random.Generator) -> Overlay:
    from repro_torch.core import qlearning

    n = w.shape[0]
    k = default_num_rings(n) if cfg.k is None else cfg.k
    seed = int(rng.integers(2**31))
    dcfg = qlearning.DQNConfig(n=n, k_rings=k, epochs=cfg.epochs,
                               eps_decay=max(cfg.epochs // 2, 1),
                               dist=cfg.dist, seed=seed, rollout=cfg.rollout)
    params, _ = qlearning.train_dqn(dcfg, eval_every=max(cfg.epochs, 1),
                                    eval_graphs=1)
    return qlearning.dgro_overlay(params, dcfg, w, n_starts=cfg.n_starts,
                                  seed=seed)


@register("ga", config=GAConfig)
def _build_ga(w: np.ndarray, cfg: GAConfig,
              rng: np.random.Generator) -> Overlay:
    """Genetic-algorithm K-ring search (the GA consumes ``cfg.seed``, not
    ``rng`` — its evolution loop owns its own generator)."""
    return evolve(w, cfg).to_overlay(w)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Algorithm 4 on the batched engine: one ring built by M concurrent
    partitions (all segments in one call), plus ``extra_random``
    whole-fleet random rings.

    ``constructor`` picks the per-partition builder: ``"nearest"`` (batched
    greedy nearest-neighbour) or ``"dqn"`` (the batched rollout with
    partitions as the environment batch; ``dqn_epochs`` sizes its training
    run).  ``stitch`` picks the segment merge: ``"naive"`` (tail-to-head,
    Alg. 4 line 14) or ``"scored"`` (segment rotations/reflections scored
    in one batched diameter call).
    """
    m: int = 4
    extra_random: int = 0
    constructor: str = "nearest"
    stitch: str = "scored"
    dqn_epochs: int = 40


@register("parallel", config=ParallelConfig)
def _build_parallel(w: np.ndarray, cfg: ParallelConfig,
                    rng: np.random.Generator) -> Overlay:
    from repro_torch.core.parallel import SegmentDQNConfig, parallel_overlay

    ov, _ = parallel_overlay(w, cfg.m, seed=int(rng.integers(2**31)),
                             constructor=cfg.constructor, stitch=cfg.stitch,
                             dqn=SegmentDQNConfig(epochs=cfg.dqn_epochs))
    for _ in range(cfg.extra_random):
        ov = ov.add_ring(random_ring(rng, w.shape[0]))
    return ov
