"""Parallel ring construction (paper §VI, Algorithm 4), torch port of
``repro.core.parallel``.

N nodes are strided into M partitions (a random base ring cut with one
stride, each partition's start chosen by a consistent hash).  Each
partition orders its own nodes, then the segments are stitched into one
ring.

The partition build is batched on the device: the M strided partitions
(sizes ``ceil(N/M)`` or ``floor(N/M)``; any ``1 <= M``, ``M > N`` just
leaves trailing partitions empty) are padded to P = ``ceil(N/M)`` and all
segments are built in one batched call over the (M, P, P) latency-block
stack.  Constructors:

* ``"nearest"`` -- :func:`construction.nearest_ring_batched` over
  INF-padded blocks (pads are reached only after every real node, so
  ``perm[:size]`` is each block's own ring order);
* ``"dqn"``     -- the batched DQN rollout
  (:func:`repro_torch.core.rollout.rollout_episodes`) with partitions as
  the environment batch and per-env ``sizes`` masking the padding.

Stitching: ``"naive"`` joins segment i's tail to segment i+1's head
(Alg. 4 line 14); ``"scored"`` also tries rotations/reflections of every
segment (each keeps the segment's own ring edges) and scores all candidate
merged rings in one batched ``batcheval`` call, keeping the best.

Engines, cross-validated in tests (all consume the same
:class:`PartitionPlan`, so a fixed seed builds identical segments):

* :func:`parallel_ring` / :func:`parallel_ring_scored` -- the batched
  engine above;
* :func:`parallel_ring_host` -- per-partition numpy loop, the reference
  implementation;
* :func:`parallel_ring_shmap` -- the reference's one-block-per-device
  ``shard_map`` engine, as its single-device fallback.

Device tensors go to ``batcheval.eval_device()``: CUDA unless the caller
asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import batcheval
from .construction import nearest_ring, nearest_ring_batched
from .diameter import INF, adjacency_from_rings

__all__ = ["partition_nodes", "PartitionPlan", "plan_partitions",
           "SegmentDQNConfig", "stitch_segments", "score_partition_blocks",
           "parallel_ring", "parallel_rings", "parallel_ring_scored",
           "parallel_ring_host", "parallel_overlay", "parallel_ring_shmap"]


# ---------------------------------------------------------------------------
# partition planning (shared host randomness for every engine)
# ---------------------------------------------------------------------------

def partition_nodes(n: int, m: int, rng: np.random.Generator) -> List[np.ndarray]:
    """Stride a random base ring into M partitions (paper §VI / Alg. 4)."""
    base = rng.permutation(n)
    return [base[i::m] for i in range(m)]


class PartitionPlan(NamedTuple):
    """Everything random about one Alg. 4 build, drawn up front on the host.

    ``parts``: per-partition node ids (trailing partitions are empty when
    M > N); ``sizes``: (M,) partition sizes; ``starts``: (M,) local
    consistent-hash start indices (0 for empty partitions, which draw no
    randomness).
    """

    parts: List[np.ndarray]
    sizes: np.ndarray
    starts: np.ndarray

    @property
    def p_max(self) -> int:
        """Padded block size P = ceil(N/M) (1 when every partition is empty)."""
        return max(1, int(self.sizes.max()))


def plan_partitions(n: int, m: int, rng: np.random.Generator) -> PartitionPlan:
    if m < 1:
        raise ValueError(f"need at least one partition, got m={m}")
    parts = partition_nodes(n, m, rng)
    sizes = np.array([len(p) for p in parts], dtype=np.int32)
    starts = np.array([int(rng.integers(s)) if s else 0 for s in sizes],
                      dtype=np.int32)
    return PartitionPlan(parts, sizes, starts)


def _plans_index(plans: Sequence[PartitionPlan], p: int) -> np.ndarray:
    """(B*M, P) node-id rows for every partition of every plan, -1 padded
    -- the device gathers the latency blocks itself (:func:`_gather_blocks`),
    so the host never materialises B*M (P, P) copies of w's entries."""
    rows = np.full((sum(len(pl.parts) for pl in plans), p), -1, dtype=np.int64)
    r = 0
    for plan in plans:
        for nodes in plan.parts:
            rows[r, :len(nodes)] = nodes
            r += 1
    return rows


def _gather_blocks(w: torch.Tensor, idx: torch.Tensor,
                   fill: float) -> torch.Tensor:
    """(B*M, P) padded node-id rows -> (B*M, P, P) latency blocks, gathered
    on ``w``'s device; pad rows and columns hold ``fill``."""
    pad = idx < 0
    ii = idx.clamp_min(0)
    blocks = w[ii[:, :, None], ii[:, None, :]]
    return blocks.masked_fill(pad[:, :, None] | pad[:, None, :], fill)


def _extract_segments(plan: PartitionPlan, perms: np.ndarray) -> List[np.ndarray]:
    """Local padded-block perms -> global node-id segments (empties kept)."""
    return [nodes[perms[i, :len(nodes)]] for i, nodes in enumerate(plan.parts)]


def _split_by_plan(plans: Sequence[PartitionPlan],
                   perms: np.ndarray) -> List[List[np.ndarray]]:
    out, r = [], 0
    for plan in plans:
        out.append(_extract_segments(plan, perms[r:r + len(plan.parts)]))
        r += len(plan.parts)
    return out


# ---------------------------------------------------------------------------
# per-partition constructors (one batched call for all partitions of all
# builds)
# ---------------------------------------------------------------------------

def _nearest_perms_fused(w: np.ndarray, plans: Sequence[PartitionPlan]):
    """Gather + nearest-ring build for every partition of every plan, on
    the device.  Returns ``(idx (B*M, P), perms (B*M, P))`` in plan order."""
    dev = batcheval.eval_device()
    p = max(pl.p_max for pl in plans)
    idx = _plans_index(plans, p)
    starts = np.concatenate([pl.starts for pl in plans])
    blocks = _gather_blocks(torch.as_tensor(w, device=dev),
                            torch.as_tensor(idx, device=dev), float(INF))
    perms = nearest_ring_batched(blocks, torch.as_tensor(starts, device=dev))
    return idx, perms.cpu().numpy()


def _segments_nearest_many(w: np.ndarray,
                           plans: Sequence[PartitionPlan]) -> List[List[np.ndarray]]:
    return _split_by_plan(plans, _nearest_perms_fused(w, plans)[1])


def _nearest_merged_naive(w: np.ndarray,
                          plans: Sequence[PartitionPlan]) -> List[np.ndarray]:
    """Fast path for nearest + naive stitch: one batched build, then one
    vectorized gather/mask turns all B*M padded perms into the B merged
    rings.  Identical to extracting the segments and concatenating them in
    partition order."""
    idx, perms = _nearest_perms_fused(w, plans)
    sizes = np.concatenate([pl.sizes for pl in plans])
    gathered = np.take_along_axis(idx, perms, axis=1)     # global node ids
    real = np.arange(idx.shape[1], dtype=np.int32)[None, :] < sizes[:, None]
    return np.split(gathered[real].astype(np.intp), len(plans))


@dataclasses.dataclass(frozen=True)
class SegmentDQNConfig:
    """Training recipe for the ``"dqn"`` per-partition constructor: a small
    deep-Q ring builder trained on graphs of the padded block size, then
    rolled out greedily over all M partition blocks in one batched call.

    ``train_seed`` seeds the training run only -- build seeds randomize the
    partition plans, not the Q-network, so repeated builds at the same
    block size reuse one cached training run.
    """
    epochs: int = 40
    dist: str = "uniform"
    alpha: float = 0.1
    n_envs: int = 4
    train_seed: int = 0


# trained segment-constructor params, keyed by (block size, recipe): an
# M-sweep or repeated builder calls reuse one training run; FIFO eviction
# keeps a handful of (p, recipe) combinations resident
_SEGMENT_PARAMS_CACHE: dict = {}
_SEGMENT_PARAMS_CACHE_MAX = 8


def _segment_qparams(p: int, dqn: SegmentDQNConfig):
    from .qlearning import DQNConfig, train_dqn

    key = (p, dqn)
    if key not in _SEGMENT_PARAMS_CACHE:
        dcfg = DQNConfig(n=p, k_rings=1, epochs=dqn.epochs,
                         eps_decay=max(dqn.epochs // 2, 1), dist=dqn.dist,
                         alpha=dqn.alpha, seed=dqn.train_seed,
                         n_envs=dqn.n_envs)
        params, _ = train_dqn(dcfg, eval_every=max(dqn.epochs, 1),
                              eval_graphs=1)
        while len(_SEGMENT_PARAMS_CACHE) >= _SEGMENT_PARAMS_CACHE_MAX:
            _SEGMENT_PARAMS_CACHE.pop(next(iter(_SEGMENT_PARAMS_CACHE)))
        _SEGMENT_PARAMS_CACHE[key] = (params, dcfg)
    return _SEGMENT_PARAMS_CACHE[key]


def _segments_dqn_many(w: np.ndarray, plans: Sequence[PartitionPlan],
                       dqn: SegmentDQNConfig) -> List[List[np.ndarray]]:
    """DQN-ordered segments: all B*M partitions are the environment batch
    of one greedy rollout.

    Pad latencies are 0 (not INF -- the Q embedding consumes ``w``) and pad
    nodes are excluded by the engine's per-env ``sizes``; the greedy
    (eps=0) episode needs no plan uniforms.
    """
    from . import rollout

    dev = batcheval.eval_device()
    p = max(pl.p_max for pl in plans)
    params, dcfg = _segment_qparams(p, dqn)
    idx = _plans_index(plans, p)
    starts = np.concatenate([pl.starts for pl in plans])
    sizes = np.concatenate([pl.sizes for pl in plans])
    blocks = _gather_blocks(torch.as_tensor(w, device=dev),
                            torch.as_tensor(idx, device=dev), 0.0)
    zeros = np.zeros((p, len(starts)), np.float32)       # T = k_rings * P = P
    actions, _, _ = rollout.rollout_episodes(
        params, blocks, starts[:, None], zeros, zeros, 0.0, dqn.alpha,
        k_rings=1, n_rounds=dcfg.n_rounds, sizes=sizes)
    actions = actions.cpu().numpy()                      # (P, B*M)
    perms = np.empty((len(starts), p), dtype=np.int64)
    for i, s in enumerate(sizes):
        if s:
            perms[i, 0] = starts[i]
            perms[i, 1:s] = actions[:s - 1, i]           # step s-1 closes
    return _split_by_plan(plans, perms)


# ---------------------------------------------------------------------------
# stitch refinement
# ---------------------------------------------------------------------------

def _orient(seg: np.ndarray, rot: int, flip: bool) -> np.ndarray:
    s = np.roll(seg, -rot)
    return s[::-1] if flip else s


def _greedy_chain(w: np.ndarray, segs: List[np.ndarray],
                  flip_first: bool) -> np.ndarray:
    """Chain segments greedily: rotate each so its head is the node nearest
    the previous segment's tail (rotations keep the segment's ring edges --
    they only move which edge the closure breaks)."""
    out = [_orient(segs[0], 0, flip_first)]
    for seg in segs[1:]:
        tail = out[-1][-1]
        out.append(_orient(seg, int(np.argmin(w[tail, seg])), False))
    return np.concatenate(out)


def stitch_segments(w: np.ndarray, segments: Sequence[np.ndarray],
                    stitch: str = "naive", n_candidates: int = 16,
                    seed: int = 0,
                    eval_opts: Optional[dict] = None) -> np.ndarray:
    """Merge per-partition segments into one ring permutation.

    ``"naive"``: concatenate in partition order (Alg. 4 line 14).
    ``"scored"``: build ``n_candidates`` merges in which each segment may be
    rotated/reflected -- the naive merge, two greedy nearest-entry chains,
    and random orientations -- score all of them in one batched diameter
    call and keep the best.  Empty segments are dropped.
    """
    if stitch not in ("naive", "scored"):
        raise ValueError(f"unknown stitch {stitch!r}; options "
                         f"('naive', 'scored')")
    segs = [np.asarray(s) for s in segments if len(s)]
    if not segs:
        raise ValueError("no non-empty segments to stitch")
    naive = np.concatenate(segs)
    if stitch == "naive" or len(segs) == 1:
        return naive
    # a child stream distinct from default_rng(seed): the plan already
    # consumed that exact stream, and correlated draws would tie the
    # candidate orientations to the base permutation
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    cands = [naive, _greedy_chain(w, segs, False), _greedy_chain(w, segs, True)]
    for _ in range(max(0, n_candidates - len(cands))):
        cands.append(np.concatenate([
            _orient(s, int(rng.integers(len(s))), bool(rng.integers(2)))
            for s in segs]))
    rings = np.stack(cands)
    with batcheval.eval_options(**(eval_opts or {})):
        scores = batcheval.diameters_of_rings(w, rings[:, None, :])
    return rings[int(np.argmin(scores))]


def score_partition_blocks(w: np.ndarray,
                           segments: Sequence[np.ndarray],
                           eval_opts: Optional[dict] = None) -> np.ndarray:
    """Per-partition ring diameters, all non-empty blocks in one padded
    batch (padded nodes are isolated singletons the largest-CC rule
    ignores).  One score per requested partition, ``NaN`` for empty ones.
    """
    segments = [np.asarray(s) for s in segments]
    scores = np.full(len(segments), np.nan, dtype=np.float32)
    idx = [i for i, s in enumerate(segments) if len(s)]
    if not idx:
        return scores
    blocks = []
    for i in idx:
        seg = segments[i]
        sub_w = w[np.ix_(seg, seg)]
        blocks.append(adjacency_from_rings(sub_w, [np.arange(len(seg))]))
    with batcheval.eval_options(**(eval_opts or {})):
        scores[idx] = batcheval.diameters(
            batcheval.pad_adjacency_blocks(blocks))
    return scores


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _build_segments_many(w: np.ndarray, plans: Sequence[PartitionPlan],
                         constructor: str,
                         dqn: Optional[SegmentDQNConfig]) -> List[List[np.ndarray]]:
    # blocks of <= 2 nodes have a unique ring order -- the DQN adds nothing
    if constructor == "dqn" and max(pl.p_max for pl in plans) > 2:
        return _segments_dqn_many(w, plans, dqn or SegmentDQNConfig())
    if constructor in ("nearest", "dqn"):
        return _segments_nearest_many(w, plans)
    raise ValueError(f"unknown constructor {constructor!r}; options "
                     f"('nearest', 'dqn')")


def parallel_rings(w: np.ndarray, m: int, seeds: Sequence[int],
                   constructor: str = "nearest", stitch: str = "naive",
                   n_stitch_candidates: int = 16,
                   dqn: Optional[SegmentDQNConfig] = None,
                   eval_opts: Optional[dict] = None) -> List[np.ndarray]:
    """B independent Algorithm-4 builds in one batched segment call (the
    B*M padded blocks are the batch axis).  Returns one merged ring per
    seed; each build draws its own :class:`PartitionPlan` from its seed,
    as the single-build entry points do."""
    if not len(seeds):
        return []
    w = np.asarray(w, dtype=np.float32)
    plans = [plan_partitions(w.shape[0], m, np.random.default_rng(s))
             for s in seeds]
    if constructor == "nearest" and stitch == "naive":
        return _nearest_merged_naive(w, plans)
    many = _build_segments_many(w, plans, constructor, dqn)
    return [stitch_segments(w, segs, stitch=stitch,
                            n_candidates=n_stitch_candidates, seed=int(s),
                            eval_opts=eval_opts)
            for segs, s in zip(many, seeds)]


def parallel_ring_scored(
        w: np.ndarray, m: int, seed: int = 0, score_blocks: bool = False,
        constructor: str = "nearest", stitch: str = "naive",
        n_stitch_candidates: int = 16,
        dqn: Optional[SegmentDQNConfig] = None,
        eval_opts: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray | None]:
    """Algorithm 4 on the batched engine + optional quality signal.

    Returns (merged ring permutation, per-partition block ring diameters
    or None); the block scores carry one entry per requested partition
    (NaN for empty blocks).
    """
    w = np.asarray(w, dtype=np.float32)
    rng = np.random.default_rng(seed)
    plan = plan_partitions(w.shape[0], m, rng)
    segments = _build_segments_many(w, [plan], constructor, dqn)[0]
    ring = stitch_segments(w, segments, stitch=stitch,
                           n_candidates=n_stitch_candidates, seed=seed,
                           eval_opts=eval_opts)
    scores = (score_partition_blocks(w, segments, eval_opts=eval_opts)
              if score_blocks else None)
    return ring, scores


def parallel_ring(w: np.ndarray, m: int, seed: int = 0,
                  constructor: str = "nearest",
                  stitch: str = "naive") -> np.ndarray:
    """Algorithm 4, batched: all M partition segments in one call, then
    stitch.  Returns the merged ring permutation."""
    return parallel_ring_scored(w, m, seed=seed, constructor=constructor,
                                stitch=stitch)[0]


def parallel_ring_host(w: np.ndarray, m: int, seed: int = 0,
                       stitch: str = "naive") -> np.ndarray:
    """Algorithm 4 as the host reference: a Python loop of per-partition
    numpy nearest-neighbour builds over the same :class:`PartitionPlan`, so
    segments (and the merged ring) are identical at a fixed seed."""
    w = np.asarray(w, dtype=np.float32)
    rng = np.random.default_rng(seed)
    plan = plan_partitions(w.shape[0], m, rng)
    segments = []
    for nodes, start in zip(plan.parts, plan.starts):
        if len(nodes) == 0:
            segments.append(nodes)
            continue
        sub_w = w[np.ix_(nodes, nodes)]
        segments.append(nodes[nearest_ring(sub_w, start=int(start))])
    return stitch_segments(w, segments, stitch=stitch, seed=seed)


def parallel_overlay(w: np.ndarray, m: int, seed: int = 0,
                     score_blocks: bool = False,
                     constructor: str = "nearest", stitch: str = "naive",
                     dqn: Optional[SegmentDQNConfig] = None):
    """Algorithm 4 as an :class:`repro_torch.overlay.Overlay`.

    Returns ``(overlay, block_scores)``: the overlay holds the merged ring,
    ``block_scores`` the per-partition ring diameters (``None`` unless
    ``score_blocks``; NaN marks empty partitions).
    """
    from repro_torch.overlay import Overlay

    perm, scores = parallel_ring_scored(
        w, m, seed=seed, score_blocks=score_blocks, constructor=constructor,
        stitch=stitch, dqn=dqn)
    return Overlay.from_rings(w, [perm], policy="parallel"), scores


def parallel_ring_shmap(w: np.ndarray, m: int, seed: int = 0,
                        stitch: str = "naive") -> np.ndarray:
    """The reference's ``shard_map`` engine (one padded partition block per
    device of an M-device mesh axis) as its single-device fallback: on one
    device that is the batched engine, :func:`parallel_ring`.  ``m`` stands
    for the mesh axis size.  Identical to :func:`parallel_ring_host` at a
    fixed seed."""
    return parallel_ring(w, m, seed=seed, stitch=stitch)
