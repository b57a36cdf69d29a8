"""Self-adaptive ring selection (paper §V, Algorithm 3).

Each node samples K latencies to existing neighbours (L_local) and K to
random nodes (L_global, L_min); a gossip round-robin averages the three
statistics network-wide; the clustering ratio

    rho = (L_local_bar - L_min_bar) / (L_global_bar - L_min_bar)

classifies the overlay:  rho -> 0 means the topology is too clustered
(neighbours are as close as the global minimum — long jumps missing), so a
RANDOM ring is added;  rho -> 1 means the topology is latency-oblivious
(neighbours look like random samples), so the NEAREST ("shortest") ring is
added.  (The paper's prose and Alg. 3 disagree on the inequality direction;
we follow the prose + the Chord/Perigee case studies: Chord has rho ~ 1 and
receives the shortest ring, Perigee has rho ~ 0 and receives the random
ring.)

A copy of ``repro.core.selection`` whose candidate scoring runs through the
port's ``batcheval`` (the CUDA min-plus kernels on the card).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Literal, Sequence, Tuple

import numpy as np

from . import batcheval
from .construction import nearest_ring, random_ring
from .diameter import neighbour_lists

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (overlay -> here)
    from repro_torch.overlay import Overlay

__all__ = ["LatencyStats", "measure_latency_stats", "clustering_ratio",
           "select_ring_kind", "score_candidate_rings", "adapt"]


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    l_local: float    # network-averaged mean latency to current neighbours
    l_global: float   # network-averaged mean latency to random peers
    l_min: float      # network-averaged min latency over the random samples
    rounds: int       # gossip rounds used for aggregation


def _gossip_average(values: np.ndarray, adj: np.ndarray,
                    rng: np.random.Generator, rounds: int) -> np.ndarray:
    """Push-sum gossip averaging along overlay edges (Alg. 3 lines 12-19).

    values: (n, d) per-node statistics.  Returns per-node estimates after
    ``rounds`` gossip rounds; exact mean is the fixed point.
    """
    n = values.shape[0]
    est = np.concatenate([values, np.ones((n, 1))], axis=1)  # push-sum weight
    neigh = neighbour_lists(adj)
    for _ in range(rounds):
        out = est * 0.5                      # keep half, send half
        incoming = np.zeros_like(est)
        for u in range(n):
            if len(neigh[u]) == 0:
                incoming[u] += est[u] * 0.5
                continue
            tgt = rng.choice(neigh[u])
            incoming[tgt] += est[u] * 0.5
        est = out + incoming
    return est[:, :-1] / np.clip(est[:, -1:], 1e-12, None)


def measure_latency_stats(
    w: np.ndarray,
    adj: np.ndarray,
    k_samples: int | None = None,
    gossip_rounds: int = 30,
    seed: int | np.random.SeedSequence = 0,
) -> LatencyStats:
    """Algorithm 3: per-node sampling + gossip aggregation.

    Sample sizes are clamped to the available populations: a node has at
    most n-1 global peers (and len(neigh) neighbours), so ``k`` larger than
    that — the default k at n=2, or an explicit ``k_samples`` on a small or
    churned-down network — measures every peer instead of raising.
    """
    rng = np.random.default_rng(seed)
    n = w.shape[0]
    if n < 2:         # a lone node has no peers to sample
        return LatencyStats(0.0, 0.0, 0.0, gossip_rounds)
    k = k_samples or max(2, int(np.ceil(np.log2(n))))
    k_global = min(k, n - 1)
    per_node = np.zeros((n, 3), np.float64)
    neigh_lists = neighbour_lists(adj)
    for u in range(n):
        neigh = neigh_lists[u]
        if len(neigh) == 0:
            neigh = np.array([(u + 1) % n])
        r = rng.choice(neigh, size=min(k, len(neigh)), replace=False)
        g = rng.choice(np.delete(np.arange(n), u), size=k_global,
                      replace=False)
        per_node[u, 0] = w[u, r].mean()       # L_local
        per_node[u, 1] = w[u, g].mean()       # L_global
        per_node[u, 2] = w[u, g].min()        # L_min
    agg = _gossip_average(per_node, adj, rng, gossip_rounds)
    mean = agg.mean(axis=0)                   # all nodes converge to ~ the mean
    return LatencyStats(float(mean[0]), float(mean[1]), float(mean[2]),
                        gossip_rounds)


def clustering_ratio(stats: LatencyStats) -> float:
    denom = stats.l_global - stats.l_min
    if denom <= 1e-12:
        return 0.5
    return float(np.clip((stats.l_local - stats.l_min) / denom, 0.0, 1.5))


RingKind = Literal["random", "nearest", "keep"]


def select_ring_kind(rho: float, eps: float = 0.3) -> RingKind:
    """rho < eps -> too clustered -> add RANDOM ring;
    rho > 1-eps -> too random -> add NEAREST ring;  else keep."""
    if rho < eps:
        return "random"
    if rho > 1.0 - eps:
        return "nearest"
    return "keep"


def score_candidate_rings(w: np.ndarray, adj: np.ndarray,
                          rings: Sequence[np.ndarray]) -> np.ndarray:
    """Diameters of ``adj`` augmented with each candidate ring, scored as one
    batched device call (``repro_torch.core.batcheval``).  Returns (B,)
    floats."""
    overlays = batcheval.overlay_with_rings(adj, w, np.stack(rings)[:, None, :])
    return batcheval.diameters(overlays)


def adapt(
    overlay: "Overlay",
    eps: float = 0.3,
    seed: int = 0,
    n_candidates: int = 4,
) -> Tuple["Overlay", RingKind, float]:
    """One DGRO adaptation step: measure -> classify -> add the chosen ring.

    ``n_candidates`` rings of the selected kind (random permutations, or
    nearest rings from distinct start nodes) are generated and ALL their
    augmented overlays are scored in one batched diameter call; the best
    candidate is added via :meth:`Overlay.add_ring`.  Returns
    (new overlay, ring kind added, rho); ``kind == "keep"`` returns the
    input overlay unchanged.

    The measurement and candidate-proposal streams are independent child
    sequences spawned from ``seed`` (``np.random.SeedSequence.spawn``) —
    seeding both from the same integer would correlate the latency samples
    with the proposed rings while still being deterministic per seed.
    """
    w, adj = overlay.w, overlay.adjacency
    n = w.shape[0]
    meas_seed, cand_seed = np.random.SeedSequence(seed).spawn(2)
    stats = measure_latency_stats(w, adj, seed=meas_seed)
    rho = clustering_ratio(stats)
    kind = select_ring_kind(rho, eps)
    if kind == "keep":
        return overlay, kind, rho
    rng = np.random.default_rng(cand_seed)
    if kind == "random":
        rings = [random_ring(rng, n) for _ in range(n_candidates)]
    else:
        starts = rng.choice(n, size=min(n_candidates, n), replace=False)
        rings = [nearest_ring(w, start=int(s)) for s in starts]
    scores = score_candidate_rings(w, adj, rings)
    best = np.stack(rings)[int(np.argmin(scores))]
    return overlay.add_ring(best), kind, rho
