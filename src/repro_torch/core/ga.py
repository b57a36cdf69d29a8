"""Genetic-algorithm baseline (paper §VII-A.2), batched.

The paper benchmarks DGRO against a GA that searches 100,000 K-ring
topologies per graph instance and keeps the best diameter.  Genome = K ring
permutations; operators: tournament selection, order crossover (OX1) per
ring, swap mutation.  ``budget`` counts diameter evaluations, matching the
paper's 1e5 budget semantics (tests/benchmarks use smaller budgets).

Evaluation goes through ``repro_torch.core.batcheval``: each generation's
children are stacked as one (B, N, N) adjacency tensor and scored by the
batched APSP in streamed device calls, so ``evolve`` makes
O(generations) device calls instead of O(budget) per-genome host
Dijkstras.  Survival is (mu + lambda) elitist: the best ``population`` of
parents+children carry over, which dominates the old steady-state loop at
equal budget.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from . import batcheval

__all__ = ["GAConfig", "EvolveResult", "evolve", "ga_search", "random_search"]


@dataclasses.dataclass(frozen=True)
class GAConfig:
    k_rings: int = 2
    population: int = 50
    budget: int = 2000          # total diameter evaluations (paper: 1e5)
    tournament: int = 4
    crossover_rate: float = 0.9
    mutation_rate: float = 0.2
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvolveResult:
    best: List[np.ndarray]      # K ring permutations
    best_diameter: float
    evaluations: int
    generations: int
    history: List[float]        # best-so-far diameter after each generation

    def to_overlay(self, w: np.ndarray):
        """The winning genome as a :class:`repro_torch.overlay.Overlay`
        (the GA's final fitness pre-populates the diameter cache)."""
        from repro_torch.overlay import Overlay

        return Overlay.from_rings(
            w, self.best, policy="ga").cache_diameter(self.best_diameter)


def _ox1(rng: np.random.Generator, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Order crossover: copy a slice of parent a, fill the rest in b's order."""
    n = len(a)
    i, j = sorted(rng.integers(0, n, size=2))
    child = np.full(n, -1, dtype=a.dtype)
    child[i:j + 1] = a[i:j + 1]
    used = set(child[i:j + 1].tolist())
    fill = [x for x in b if x not in used]
    pos = [idx for idx in range(n) if not (i <= idx <= j)]
    child[pos] = fill
    return child


def _mutate(rng: np.random.Generator, perm: np.ndarray) -> np.ndarray:
    out = perm.copy()
    i, j = rng.integers(0, len(perm), size=2)
    out[i], out[j] = out[j], out[i]
    return out


def _tournament(rng: np.random.Generator, fit: np.ndarray, k: int) -> int:
    idx = rng.integers(0, len(fit), size=k)
    return int(idx[np.argmin(fit[idx])])


def evolve(w: np.ndarray, cfg: GAConfig) -> EvolveResult:
    """Generational GA: breed a full cohort on the host, score it as ONE
    batched device call, keep the elite (mu + lambda)."""
    rng = np.random.default_rng(cfg.seed)
    n = w.shape[0]
    pop = np.stack([[rng.permutation(n) for _ in range(cfg.k_rings)]
                    for _ in range(cfg.population)])          # (P, K, N)
    fit = batcheval.diameters_of_rings(w, pop).astype(np.float64)
    evals = cfg.population
    history = [float(fit.min())]

    while evals < cfg.budget:
        n_children = min(cfg.population, cfg.budget - evals)
        children = np.empty((n_children, cfg.k_rings, n), dtype=pop.dtype)
        for c in range(n_children):
            pa = pop[_tournament(rng, fit, cfg.tournament)]
            pb = pop[_tournament(rng, fit, cfg.tournament)]
            for r in range(cfg.k_rings):
                ch = (_ox1(rng, pa[r], pb[r])
                      if rng.random() < cfg.crossover_rate else pa[r].copy())
                if rng.random() < cfg.mutation_rate:
                    ch = _mutate(rng, ch)
                children[c, r] = ch
        child_fit = batcheval.diameters_of_rings(w, children).astype(np.float64)
        evals += n_children
        all_fit = np.concatenate([fit, child_fit])
        survivors = np.argsort(all_fit, kind="stable")[:cfg.population]
        pool = np.concatenate([pop, children])
        pop, fit = pool[survivors], all_fit[survivors]
        history.append(float(fit.min()))

    best_i = int(np.argmin(fit))
    best = [pop[best_i, r].copy() for r in range(cfg.k_rings)]
    return EvolveResult(best, float(fit[best_i]), evals,
                        len(history) - 1, history)


def ga_search(w: np.ndarray, cfg: GAConfig) -> Tuple[List[np.ndarray], float, int]:
    """Returns (best genome, best diameter, evaluations used)."""
    res = evolve(w, cfg)
    return res.best, res.best_diameter, res.evaluations


def random_search(w: np.ndarray, k_rings: int, budget: int,
                  seed: int = 0,
                  host_chunk: int | None = None) -> Tuple[List[np.ndarray], float]:
    """Pure random K-ring search — the paper's "random" normalizer.

    Scored in batched slabs so a 1e5 budget never materializes the full
    (budget, N, N) adjacency tensor; the slab size scales with N to keep
    each host-side stack under ~256 MiB (4096 genomes max).
    """
    rng = np.random.default_rng(seed)
    n = w.shape[0]
    if host_chunk is None:
        host_chunk = min(4096, max(1, (1 << 28) // (4 * n * n)))
    best, best_d = None, float("inf")
    done = 0
    while done < budget:
        m = min(host_chunk, budget - done)
        genomes = np.stack([[rng.permutation(n) for _ in range(k_rings)]
                            for _ in range(m)])               # (m, K, N)
        d = batcheval.diameters_of_rings(w, genomes)
        i = int(np.argmin(d))
        if float(d[i]) < best_d:
            best, best_d = [genomes[i, r].copy() for r in range(k_rings)], float(d[i])
        done += m
    return best, best_d
