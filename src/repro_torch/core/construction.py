"""Ring construction (paper §IV-B, Algorithm 1).

A solution is a permutation ``perm`` of the N nodes; the ring is
perm[0] -> perm[1] -> ... -> perm[N-1] -> perm[0].  K-ring topologies are
unions of K such rings.  Constructors:

* ``random_ring``    — the consistent-hash ring of Chord/RAPID (§II, §V).
* ``nearest_ring``   — the paper's "shortest ring": sequentially select the
                       nearest available neighbour (§V last ¶).
* ``greedy_ring``    — Algorithm 1 with an arbitrary score function; the DQN
                       plugs its Q-function in here (score = Q(S_t, u)).
* ``nearest_ring_batched`` — nearest rings of a stack of latency blocks on
                       the device, one step for all blocks at once (the
                       partitioned construction of §VI).

The host constructors are numpy copies of ``repro.core.construction``;
given the same generator they build the same permutations.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

__all__ = [
    "random_ring",
    "nearest_ring",
    "nearest_ring_batched",
    "nearest_rings_batched",
    "greedy_ring",
    "k_rings",
    "default_num_rings",
]

ScoreFn = Callable[[np.ndarray, np.ndarray, int, np.ndarray], np.ndarray]
# signature: (W, visited_mask, current_node, partial_perm) -> scores (N,)


def random_ring(rng: np.random.Generator, n: int) -> np.ndarray:
    """Uniformly random permutation — models the consistent-hash logical ring."""
    return rng.permutation(n)


def greedy_ring(
    w: np.ndarray,
    score_fn: ScoreFn,
    start: int = 0,
) -> np.ndarray:
    """Algorithm 1: sequentially add the argmax-score node (host loop).

    At step t the candidate set is the unvisited nodes; ``score_fn`` scores
    every node and visited ones are masked to -inf.
    """
    n = w.shape[0]
    perm = np.empty(n, dtype=np.int64)
    perm[0] = start
    visited = np.zeros(n, dtype=bool)
    visited[start] = True
    cur = start
    for t in range(1, n):
        scores = np.asarray(score_fn(w, visited, cur, perm[:t]), dtype=np.float64)
        scores[visited] = -np.inf
        cur = int(np.argmax(scores))
        perm[t] = cur
        visited[cur] = True
    return perm


def nearest_ring(w: np.ndarray, start: int = 0) -> np.ndarray:
    """The paper's "shortest ring": greedy nearest-available-neighbour."""

    def score(w, visited, cur, _perm):
        return -w[cur]

    return greedy_ring(w, score, start)


def nearest_ring_batched(blocks: torch.Tensor,
                         starts: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour rings of an (M, P, P) latency-block stack from
    (M,) start nodes, on the blocks' device: P - 1 steps, each one argmin
    over all M blocks.  Returns (M, P) int64 permutations.

    Ties go to the first minimum (``torch.argmin``, as ``jnp.argmin``).
    Blocks of fewer than P real nodes pad with the finite sentinel
    ``diameter.INF``: pads lose to every real node and beat the ``inf`` of
    visited nodes, so ``perm[:size]`` is the block's own ring order.
    """
    m, p = blocks.shape[0], blocks.shape[1]
    cur = torch.as_tensor(starts, device=blocks.device).long().reshape(m)
    perm = torch.empty((m, p), dtype=torch.int64, device=blocks.device)
    perm[:, 0] = cur
    visited = torch.zeros((m, p), dtype=torch.bool, device=blocks.device)
    visited.scatter_(1, cur[:, None], True)
    for t in range(1, p):
        row = blocks.gather(1, cur[:, None, None].expand(m, 1, p))[:, 0]
        cur = row.masked_fill(visited, float("inf")).argmin(1)
        perm[:, t] = cur
        visited.scatter_(1, cur[:, None], True)
    return perm


# the reference's name for the batched form
nearest_rings_batched = nearest_ring_batched


def k_rings(
    w: np.ndarray,
    k: int,
    kind: str = "random",
    rng: np.random.Generator | None = None,
    starts: Sequence[int] | None = None,
) -> List[np.ndarray]:
    """K rings of a given kind ("random" | "nearest" | "mixed:<m>").

    ``mixed:<m>`` builds m random rings and (k - m) nearest rings — the
    RAPID hybrid of the paper's ablation (§VII-C.2, Figs. 12/16).
    """
    rng = rng or np.random.default_rng(0)
    n = w.shape[0]
    if starts is None:
        starts = list(rng.integers(0, n, size=k))
    if kind.startswith("mixed:"):
        m = int(kind.split(":")[1])
        assert 0 <= m <= k, (m, k)
        kinds = ["random"] * m + ["nearest"] * (k - m)
    else:
        kinds = [kind] * k
    rings = []
    for i, kk in enumerate(kinds):
        if kk == "random":
            rings.append(random_ring(rng, n))
        elif kk == "nearest":
            rings.append(nearest_ring(w, start=int(starts[i % len(starts)])))
        else:
            raise ValueError(f"unknown ring kind {kk!r}")
    return rings


def default_num_rings(n: int) -> int:
    """Paper: each node keeps log(N) outgoing connections; one ring buys one
    outgoing edge per node, so K = ceil(log2 N) rings."""
    return max(1, int(np.ceil(np.log2(max(n, 2)))))
