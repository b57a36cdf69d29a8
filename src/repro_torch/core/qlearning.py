"""Deep Q-learning for diameter-guided ring construction (paper §IV,
Algs. 1-2), torch port of ``repro.core.qlearning``.

MDP (paper §IV-C):
  * state  S_t = (W, A_t, v_t): latency matrix, partial-solution adjacency,
    current end node of the ring under construction;
  * action u: next unvisited node -- edge (v_t, u) is added;
  * reward r = D(G_t) - D(G_{t+1}) - alpha * w(v_t, u).

Replay + epsilon-greedy per Algorithm 2; eps = max(1 - epoch/eps_decay,
eps_min) (§VII-B.1).

A thin facade over :mod:`repro_torch.core.rollout`: with
``cfg.rollout="device"`` (the default) an epoch runs as one batched step
loop over ``cfg.n_envs`` graphs; ``cfg.rollout="host"`` keeps the
step-by-step host loop as a debug path.  Both consume the same
:class:`~repro_torch.core.rollout.RolloutPlan`, so an episode given the
same plan makes identical decisions.

The device is ``batcheval.eval_device()``: CUDA unless the caller asks for
the CPU (``batcheval.eval_options(device="cpu")``); with no CUDA device and
no such request these entry points raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import adamw_init

from . import batcheval, rollout
from .diameter import INF, largest_cc_diameter, relax_edge_update
from .embedding import QParams, init_qparams, q_values
from .rollout import RolloutPlan, make_plan
from .topology import make_latency

__all__ = ["DQNConfig", "ReplayBuffer", "train_dqn", "construct_ring_dqn",
           "dgro_overlay", "TrainLog"]


@dataclasses.dataclass
class DQNConfig:
    n: int = 20                     # nodes per training graph
    k_rings: int = 2                # rings per episode
    p: int = 16                     # embedding dim (paper: 16)
    h: int = 64                     # Q-head hidden
    n_rounds: int = 3               # embedding iterations T
    lr: float = 5e-4                # paper §VII-B.1
    gamma: float = 0.99
    alpha: float = 0.1              # latency shaping coefficient
    epochs: int = 300
    eps_decay: float = 2000.0       # paper: eps = max(1 - epoch/2000, 0.05)
    eps_min: float = 0.05
    batch_size: int = 32            # paper: 32
    buffer_capacity: int = 20000
    dist: str = "uniform"
    seed: int = 0
    updates_per_step: int = 1
    rollout: str = "device"         # "device" (batched loop) | "host" (debug)
    n_envs: int = 1                 # parallel environments per device epoch


class ReplayBuffer:
    """Fixed-capacity ring buffer of transitions (Alg. 2 memory M), numpy.

    Transitions store a graph id (``widx``) into a small table of epoch
    latency graphs instead of a full (N, N) copy of ``w`` per step.  Dead
    graphs (no live transition references them) are pruned as the ring
    buffer overwrites; :class:`repro_torch.core.rollout.DeviceBuffer` uses
    the same layout.
    """

    def __init__(self, capacity: int, n: int):
        self.capacity = capacity
        self.n = n
        self.widx = np.zeros((capacity,), np.int64)
        self.adj = np.zeros((capacity, n, n), np.uint8)
        self.v = np.zeros((capacity,), np.int32)
        self.action = np.zeros((capacity,), np.int32)
        self.reward = np.zeros((capacity,), np.float32)
        self.adj_next = np.zeros((capacity, n, n), np.uint8)
        self.v_next = np.zeros((capacity,), np.int32)
        self.visited_next = np.zeros((capacity, n), np.uint8)
        self.done = np.zeros((capacity,), np.uint8)
        self.graphs: Dict[int, np.ndarray] = {}
        self._next_gid = 0
        self._last_gid: Optional[int] = None
        self.size = 0
        self.ptr = 0

    @property
    def n_graphs(self) -> int:
        return len(self.graphs)

    def register_graph(self, w: np.ndarray) -> int:
        """Intern ``w`` in the graph table, reusing the last id when the
        matrix is unchanged (the per-episode common case)."""
        w = np.asarray(w, np.float32)
        if (self._last_gid is not None
                and np.array_equal(self.graphs[self._last_gid], w)):
            return self._last_gid
        gid = self._next_gid
        self._next_gid += 1
        self.graphs[gid] = w.copy()
        self._last_gid = gid
        self._prune()
        return gid

    def _prune(self) -> None:
        """Drop graphs no live transition references.  Ids are monotone and
        the ring buffer overwrites FIFO, so everything below the minimum
        live id is dead (the latest graph is always kept)."""
        min_live = (int(self.widx[:self.size].min()) if self.size
                    else self._next_gid)
        for g in [g for g in self.graphs
                  if g < min_live and g != self._last_gid]:
            del self.graphs[g]

    def push(self, w, adj, v, action, reward, adj_next, v_next, visited_next,
             done):
        """``w`` may be a graph id from :meth:`register_graph` or a raw
        (N, N) matrix (interned on the fly)."""
        gid = int(w) if isinstance(w, (int, np.integer)) \
            else self.register_graph(w)
        i = self.ptr
        self.widx[i] = gid
        self.adj[i] = adj
        self.v[i] = v
        self.action[i] = action
        self.reward[i] = reward
        self.adj_next[i] = adj_next
        self.v_next[i] = v_next
        self.visited_next[i] = visited_next
        self.done[i] = done
        self.ptr = (self.ptr + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def _gather(self, idx: np.ndarray):
        w = np.stack([self.graphs[int(g)] for g in self.widx[idx]])
        return (w, self.adj[idx], self.v[idx], self.action[idx],
                self.reward[idx], self.adj_next[idx], self.v_next[idx],
                self.visited_next[idx], self.done[idx])

    def sample(self, rng: np.random.Generator, batch: int):
        return self._gather(rng.integers(0, self.size, size=batch))

    def sample_at(self, uniforms: np.ndarray):
        """Sample via pre-generated uniforms -- ``floor(u * size)``, the
        formula the batched engine applies to the same plan, so host and
        device training draw identical replay batches."""
        idx = (np.asarray(uniforms, np.float32)
               * np.float32(self.size)).astype(np.int32)
        return self._gather(np.minimum(idx, self.size - 1))


# ---------------------------------------------------------------------------
# host episode loop -- rollout="host" debug path, mirrors the batched engine
# ---------------------------------------------------------------------------

def _run_episode(params: QParams, cfg: DQNConfig, w: np.ndarray, eps: float,
                 plan: RolloutPlan, env: int = 0,
                 buffer: Optional[ReplayBuffer] = None, opt_state=None,
                 train: bool = True, gid: Optional[int] = None):
    """Build k_rings rings step by step on the host (debug mirror).

    Consumes column ``env`` of ``plan`` with the decision formulas of
    :func:`repro_torch.core.rollout.rollout_episodes` (same eps coin, same
    ``floor(u * n_unvisited)`` random pick, same incremental-relax
    reward); Q values, relaxations and TD updates run on
    ``batcheval.eval_device()``.
    """
    dev = batcheval.eval_device()
    params = params.on(dev)
    n = cfg.n
    w_t = torch.as_tensor(np.asarray(w, np.float32), device=dev)
    dist = torch.full((n, n), float(INF), dtype=torch.float32, device=dev)
    dist.fill_diagonal_(0.0)                          # APSP of partial graph
    adj = np.zeros((n, n), np.uint8)                  # 0/1 adjacency for embed
    prev_d = 0.0                                      # D(G_0) := 0 (empty)
    losses: List[float] = []
    rewards: List[float] = []
    perms: List[np.ndarray] = []

    for ring_i in range(cfg.k_rings):
        start = int(plan.starts[env, ring_i])
        visited = np.zeros(n, np.uint8)
        visited[start] = 1
        perm = [start]
        v = start
        for _t in range(n):  # n-1 inner edges + closing edge
            t = ring_i * n + _t
            closing = _t == n - 1
            if closing:
                a = start                              # close the ring
            elif np.float32(plan.eps_u[t, env]) < np.float32(eps):
                unvis = np.flatnonzero(visited == 0)
                ridx = int(np.float32(plan.choice_u[t, env])
                           * np.float32(len(unvis)))
                a = int(unvis[min(ridx, len(unvis) - 1)])
            else:
                with torch.no_grad():
                    q = q_values(params, w_t, torch.as_tensor(
                        adj, device=dev).float(), v, cfg.n_rounds)
                    q = q.masked_fill(torch.as_tensor(
                        visited.astype(bool), device=dev), float("-inf"))
                a = int(q.argmax())
            adj_prev = adj.copy()
            adj[v, a] = 1; adj[a, v] = 1
            w_edge = np.float32(w[v, a])
            dist = relax_edge_update(dist, v, a, float(w_edge))
            new_d = float(largest_cc_diameter(dist))
            reward = float(np.float32(prev_d) - np.float32(new_d)
                           - np.float32(cfg.alpha) * w_edge)
            rewards.append(reward)
            done = closing and ring_i == cfg.k_rings - 1
            if buffer is not None and not closing:
                visited_next = visited.copy(); visited_next[a] = 1
                buffer.push(w if gid is None else gid, adj_prev, v, a, reward,
                            adj, a, visited_next, done)
            prev_d = new_d
            if not closing:
                visited[a] = 1
                perm.append(a)
                v = a
            if train and buffer is not None and buffer.size >= cfg.batch_size:
                for u_i in range(cfg.updates_per_step):
                    batch = buffer.sample_at(plan.sample_u[t, u_i])
                    params, opt_state, loss = rollout.td_update_impl(
                        params, opt_state,
                        *[torch.as_tensor(x, device=dev) for x in batch],
                        cfg.gamma, cfg.lr, cfg.n_rounds)
                    losses.append(float(loss))
        perms.append(np.asarray(perm))
    return (params, opt_state, prev_d, losses, perms,
            np.asarray(rewards, np.float32))


@dataclasses.dataclass
class TrainLog:
    epochs: List[int]
    train_diam: List[float]
    test_diam: List[float]
    loss: List[float]
    seconds: float
    steps_per_sec: float = 0.0


def _eval_diameters_device(params, cfg: DQNConfig, test_ws,
                           rng: np.random.Generator) -> float:
    """Greedy construction on all eval graphs in one batched rollout."""
    plan = make_plan(rng, len(test_ws), cfg.k_rings, cfg.n)
    w_b = torch.as_tensor(np.stack(test_ws).astype(np.float32),
                          device=batcheval.eval_device())
    _, _, d = rollout.rollout_episodes(
        params, w_b, plan.starts, plan.eps_u, plan.choice_u, 0.0, cfg.alpha,
        k_rings=cfg.k_rings, n_rounds=cfg.n_rounds)
    return float(np.mean(d.cpu().numpy()))


def train_dqn(cfg: DQNConfig, eval_every: int = 25,
              eval_graphs: int = 3) -> Tuple[QParams, TrainLog]:
    """Algorithm 2: Q-learning with experience replay.

    ``cfg.rollout="device"`` runs each epoch as one batched step loop over
    ``cfg.n_envs`` graphs (:mod:`repro_torch.core.rollout`); ``"host"``
    keeps the per-step host loop for debugging.  The parameters are drawn
    from ``torch.Generator().manual_seed(cfg.seed)``.
    """
    assert cfg.rollout in ("device", "host"), cfg.rollout
    dev = batcheval.eval_device()
    rng = np.random.default_rng(cfg.seed)
    params = init_qparams(torch.Generator().manual_seed(cfg.seed), cfg.p,
                          cfg.h, device=dev)
    opt_state = adamw_init(params.tensors())
    test_ws = [make_latency(cfg.dist, cfg.n, seed=10_000 + i)
               for i in range(eval_graphs)]
    log = TrainLog([], [], [], [], 0.0)
    n, k, n_envs = cfg.n, cfg.k_rings, cfg.n_envs
    t0 = time.time()

    if cfg.rollout == "device":
        slots = rollout.graph_slots(cfg.buffer_capacity, n_envs, k, n)
        buf = rollout.init_buffer(cfg.buffer_capacity, n, slots, device=dev)
        for epoch in range(cfg.epochs):
            eps = max(1.0 - epoch / cfg.eps_decay, cfg.eps_min)
            ws = np.stack([
                make_latency(cfg.dist, n,
                             seed=cfg.seed * 77_000 + epoch * n_envs + i)
                for i in range(n_envs)])
            plan = make_plan(rng, n_envs, k, n, cfg.updates_per_step,
                             cfg.batch_size)
            gids = (np.arange(n_envs) + epoch * n_envs) % slots
            params, opt_state, buf, d, losses, _a, _r = rollout.train_epoch(
                params, opt_state, buf,
                torch.as_tensor(ws.astype(np.float32), device=dev), gids,
                plan.starts, plan.eps_u, plan.choice_u, plan.sample_u,
                eps, cfg.gamma, cfg.lr, cfg.alpha,
                k_rings=k, n_rounds=cfg.n_rounds, batch_size=cfg.batch_size,
                updates_per_step=cfg.updates_per_step)
            if epoch % eval_every == 0 or epoch == cfg.epochs - 1:
                losses = losses.cpu().numpy()
                losses = losses[np.isfinite(losses)]
                log.epochs.append(epoch)
                log.train_diam.append(float(np.mean(d.cpu().numpy())))
                log.test_diam.append(
                    _eval_diameters_device(params, cfg, test_ws, rng))
                log.loss.append(float(np.mean(losses)) if losses.size
                                else float("nan"))
    else:
        buffer = ReplayBuffer(cfg.buffer_capacity, n)
        for epoch in range(cfg.epochs):
            eps = max(1.0 - epoch / cfg.eps_decay, cfg.eps_min)
            train_ds, losses = [], []
            for i in range(n_envs):
                w = make_latency(cfg.dist, n,
                                 seed=cfg.seed * 77_000 + epoch * n_envs + i)
                plan = make_plan(rng, 1, k, n, cfg.updates_per_step,
                                 cfg.batch_size)
                gid = buffer.register_graph(w)
                params, opt_state, train_d, ls, _, _ = _run_episode(
                    params, cfg, w, eps, plan, 0, buffer, opt_state,
                    train=True, gid=gid)
                train_ds.append(train_d)
                losses.extend(ls)
            if epoch % eval_every == 0 or epoch == cfg.epochs - 1:
                test_d = float(np.mean([
                    construct_ring_dqn(params, cfg, tw, rng)[1]
                    for tw in test_ws]))
                log.epochs.append(epoch)
                log.train_diam.append(float(np.mean(train_ds)))
                log.test_diam.append(test_d)
                log.loss.append(float(np.mean(losses)) if losses
                                else float("nan"))
    log.seconds = time.time() - t0
    log.steps_per_sec = (cfg.epochs * n_envs * k * n) / max(log.seconds, 1e-9)
    return params, log


def construct_ring_dqn(params: QParams, cfg: DQNConfig, w: np.ndarray,
                       rng: np.random.Generator) -> Tuple[List[np.ndarray],
                                                          float]:
    """Greedy (eps=0) K-ring construction with the trained Q (Alg. 1).

    Both rollout modes consume ``rng`` identically (one plan draw), so they
    produce the same rings at the same seed.
    """
    plan = make_plan(rng, 1, cfg.k_rings, cfg.n)
    if cfg.rollout == "host":
        _, _, d, _, perms, _ = _run_episode(params, cfg, w, 0.0, plan, 0,
                                            buffer=None, train=False)
        return perms, d
    w_b = torch.as_tensor(np.asarray(w, np.float32)[None],
                          device=batcheval.eval_device())
    actions, _, d = rollout.rollout_episodes(
        params, w_b, plan.starts, plan.eps_u, plan.choice_u, 0.0, cfg.alpha,
        k_rings=cfg.k_rings, n_rounds=cfg.n_rounds)
    perms = rollout.perms_from_actions(plan.starts, actions.cpu().numpy(),
                                       cfg.k_rings, cfg.n)[0]
    return perms, float(d[0])


def dgro_overlay(params: QParams, cfg: DQNConfig, w: np.ndarray,
                 n_starts: int = 10, seed: int = 0):
    """Paper §VII-B.2: build ``n_starts`` K-ring topologies with the
    trained Q, keep the best, as a :class:`repro_torch.overlay.Overlay`
    (policy ``"dgro-dqn"``; the winning episode's diameter seeds the
    cache).

    With ``cfg.rollout="device"`` all starts run as one batched rollout;
    per-start plans come from ``default_rng(seed + s)`` in both modes, so
    the winning rings match the host path at fixed seeds.
    """
    from repro_torch.overlay import Overlay

    n, k = cfg.n, cfg.k_rings
    if cfg.rollout == "host":
        best_perms, best_d = None, float("inf")
        for s in range(n_starts):
            rng = np.random.default_rng(seed + s)
            perms, d = construct_ring_dqn(params, cfg, w, rng)
            if d < best_d:
                best_perms, best_d = perms, d
        return Overlay.from_rings(
            w, best_perms, policy="dgro-dqn").cache_diameter(best_d)

    plans = [make_plan(np.random.default_rng(seed + s), 1, k, n)
             for s in range(n_starts)]
    starts = np.concatenate([p.starts for p in plans], axis=0)    # (S, K)
    eps_u = np.concatenate([p.eps_u for p in plans], axis=1)      # (T, S)
    choice_u = np.concatenate([p.choice_u for p in plans], axis=1)
    w_b = torch.as_tensor(np.asarray(w, np.float32),
                          device=batcheval.eval_device()).expand(n_starts, n, n)
    actions, _, d = rollout.rollout_episodes(
        params, w_b, starts, eps_u, choice_u, 0.0, cfg.alpha,
        k_rings=k, n_rounds=cfg.n_rounds)
    d = d.cpu().numpy()
    best = int(np.argmin(d))
    perms = rollout.perms_from_actions(starts, actions.cpu().numpy(), k,
                                       n)[best]
    return Overlay.from_rings(
        w, perms, policy="dgro-dqn").cache_diameter(float(d[best]))
