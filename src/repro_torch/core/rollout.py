"""Vectorized DQN episode engine (paper §IV, Algs. 1-2), torch port of
``repro.core.rollout``.

An epoch runs E independent latency graphs in lockstep as batched tensors:

* **eps-greedy over the batch** -- one :func:`~repro_torch.core.embedding.
  q_values_batch` call scores all E states per step; random exploration
  consumes pre-generated uniforms (:class:`RolloutPlan`), so the host debug
  loop (``qlearning._run_episode``) replays the identical decisions.
* **incremental rewards** -- each step repairs the partial solution's APSP
  matrix with the O(N^2) edge relaxation instead of a full APSP.
* **device replay buffer** -- fixed-capacity transition tensors updated in
  place; transitions store an index into a small ring table of epoch
  graphs instead of an (N, N) copy per step.
* **TD updates** -- once the buffer holds a batch, each step takes
  ``updates_per_step`` AdamW steps on replay batches drawn with the plan's
  uniforms.

The reference's ``lax.scan`` over T = K * N steps is a Python loop here.
Everything it decided with ``lax.cond`` on values the host knows anyway
(the step index, the buffer's size and write pointer) is decided on the
host, so a step on the card issues kernels and never waits for them: no
``.item()``, no device-to-host copy, no ``nonzero`` or boolean-mask
indexing inside the loop.

Determinism contract: the engine draws no randomness of its own; every
stochastic decision comes from a :class:`RolloutPlan` made on the host
from a ``numpy.random.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_update

from .batcheval import batched_apsp
from .diameter import INF, largest_cc_diameter, relax_edge_update
from .embedding import QParams, THETAS, q_values_batch

__all__ = [
    "RolloutPlan", "make_plan", "DeviceBuffer", "init_buffer",
    "graph_slots", "rollout_episodes", "train_epoch", "td_update_impl",
    "perms_from_actions",
]


# ---------------------------------------------------------------------------
# pre-generated randomness (shared by the batched engine and the host loop)
# ---------------------------------------------------------------------------

class RolloutPlan(NamedTuple):
    """Every random draw an epoch makes, generated up front on the host.

    ``starts``: (E, K) ring start nodes; ``eps_u``/``choice_u``: (T, E)
    uniforms for the eps-greedy coin and the random-action pick
    (T = K * N steps); ``sample_u``: (T, U, B) uniforms for replay
    sampling (empty when not training).
    """

    starts: np.ndarray
    eps_u: np.ndarray
    choice_u: np.ndarray
    sample_u: np.ndarray


def make_plan(rng: np.random.Generator, n_envs: int, k_rings: int, n: int,
              updates_per_step: int = 0, batch_size: int = 0) -> RolloutPlan:
    t = k_rings * n
    starts = rng.integers(0, n, size=(n_envs, k_rings)).astype(np.int32)
    eps_u = rng.random((t, n_envs), dtype=np.float32)
    choice_u = rng.random((t, n_envs), dtype=np.float32)
    if updates_per_step and batch_size:
        sample_u = rng.random((t, updates_per_step, batch_size),
                              dtype=np.float32)
    else:
        sample_u = np.zeros((t, 0, 0), np.float32)
    return RolloutPlan(starts, eps_u, choice_u, sample_u)


# ---------------------------------------------------------------------------
# device replay buffer (tensors updated in place, size / ptr on the host)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceBuffer:
    """Alg. 2 memory M as fixed-shape tensors on one device.

    ``table`` is a small ring of epoch latency graphs; transitions store
    ``widx`` (an index into it) instead of a per-step (N, N) copy.
    ``size`` and ``ptr`` are host ints: every push is decided on the host.
    """

    table: torch.Tensor         # (G, N, N) f32 epoch-graph ring
    widx: torch.Tensor          # (C,) i32 graph index
    adj: torch.Tensor           # (C, N, N) u8 pre-action adjacency
    v: torch.Tensor             # (C,) i32
    action: torch.Tensor        # (C,) i32
    reward: torch.Tensor        # (C,) f32
    adj_next: torch.Tensor      # (C, N, N) u8
    v_next: torch.Tensor        # (C,) i32
    visited_next: torch.Tensor  # (C, N) u8
    done: torch.Tensor          # (C,) f32
    size: int = 0
    ptr: int = 0


def graph_slots(capacity: int, n_envs: int, k_rings: int, n: int) -> int:
    """Ring-table size that guarantees no live transition's graph is ever
    overwritten: a transition survives at most ceil(C / pushes-per-epoch)
    epochs (FIFO overwrite), so one extra epoch of slots is enough."""
    pushes_per_epoch = max(n_envs * k_rings * (n - 1), 1)
    return n_envs * (int(np.ceil(capacity / pushes_per_epoch)) + 1)


def init_buffer(capacity: int, n: int, slots: int,
                device=None) -> DeviceBuffer:
    dev = resolve_device(device)

    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return DeviceBuffer(
        table=zeros(slots, n, n, dtype=torch.float32),
        widx=zeros(capacity, dtype=torch.int32),
        adj=zeros(capacity, n, n, dtype=torch.uint8),
        v=zeros(capacity, dtype=torch.int32),
        action=zeros(capacity, dtype=torch.int32),
        reward=zeros(capacity, dtype=torch.float32),
        adj_next=zeros(capacity, n, n, dtype=torch.uint8),
        v_next=zeros(capacity, dtype=torch.int32),
        visited_next=zeros(capacity, n, dtype=torch.uint8),
        done=zeros(capacity, dtype=torch.float32))


def _push(buf: DeviceBuffer, gids, adj_prev, v, a, reward, adj_next,
          visited_next, done: bool) -> None:
    """Write E transitions at ``ptr`` (wrapping), in place."""
    cap = buf.v.shape[0]
    rows = [(gids, buf.widx), (adj_prev, buf.adj), (v, buf.v),
            (a, buf.action), (reward, buf.reward), (adj_next, buf.adj_next),
            (a, buf.v_next), (visited_next, buf.visited_next)]
    e = v.shape[0]
    lo = 0
    while lo < e:                       # at most two slices (one wrap)
        n_rows = min(e - lo, cap - buf.ptr)
        dst = slice(buf.ptr, buf.ptr + n_rows)
        for src, store in rows:
            store[dst] = src[lo:lo + n_rows]
        buf.done[dst] = float(done)
        buf.ptr = (buf.ptr + n_rows) % cap
        lo += n_rows
    buf.size = min(buf.size + e, cap)


# ---------------------------------------------------------------------------
# TD update (shared by the host loop in qlearning and the batched engine)
# ---------------------------------------------------------------------------

def td_update_impl(params: QParams, opt_state: AdamWState, w, adj, v, action,
                   reward, adj_next, v_next, visited_next, done, gamma, lr,
                   n_rounds: int = 3):
    """One AdamW step on the squared TD error over a replay batch: one
    batched forward for the targets (no gradient) and one for Q(s, a).
    Returns ``(new_params, new_opt_state, loss)``."""
    with torch.no_grad():
        qn = q_values_batch(params, w, adj_next.float(), v_next, n_rounds)
        qn = qn.masked_fill(visited_next.bool(), float("-inf"))
        best = qn.amax(1)
        best = torch.where(torch.isfinite(best), best, 0.0)
        y = reward + gamma * best * (1.0 - done.float())
    with torch.enable_grad():
        q = q_values_batch(params, w, adj.float(), v, n_rounds)
        q_sa = q.gather(1, action.long()[:, None])[:, 0]
        loss = torch.mean(torch.square(y - q_sa))
        grads = torch.autograd.grad(loss, list(params.tensors().values()))
    cfg = AdamWConfig(lr=lr, b1=0.9, b2=0.999, clip_norm=5.0)
    new, new_state, _ = adamw_update(cfg, dict(zip(THETAS, grads)),
                                     opt_state, params.tensors())
    return QParams(**new), new_state, loss.detach()


# ---------------------------------------------------------------------------
# the batched episode step (shared by rollout-only and training loops)
# ---------------------------------------------------------------------------

def _select_actions(params, w_batch, adj, visited, v, eps_u_t, choice_u_t,
                    eps, n_rounds: int):
    """eps-greedy over all E environments (one batched Q call).

    The random branch picks the ``floor(u * n_unvisited)``-th unvisited
    node in float32 -- the formula the host debug loop applies to the same
    plan uniforms, so decisions match bit for bit."""
    q = q_values_batch(params, w_batch, adj, v, n_rounds)        # (E, N)
    greedy = q.masked_fill(visited, float("-inf")).argmax(1)     # first max
    unvis = ~visited
    n_unvis = unvis.sum(1, dtype=torch.int32)
    ridx = (choice_u_t * n_unvis.float()).to(torch.int32)
    ridx = torch.minimum(ridx, n_unvis - 1)
    order = unvis.to(torch.int32).cumsum(1, dtype=torch.int32) - 1
    rand_a = ((order == ridx[:, None]) & unvis).to(torch.int32).argmax(1)
    return torch.where(eps_u_t < eps, rand_a, greedy)


def _apply_edge(w_batch, dist, adj, v, a, prev_d, alpha):
    """Add edge (v, a) in every env: O(N^2) relax + largest-CC diameter.
    Returns new tensors; the inputs are left as they were."""
    e, n = dist.shape[0], dist.shape[-1]
    va, av = (v * n + a)[:, None], (a * n + v)[:, None]
    w_edge = w_batch.reshape(e, n * n).gather(1, va)[:, 0]
    adj = adj.reshape(e, n * n).scatter(1, va, 1.0).scatter(1, av, 1.0) \
        .reshape(e, n, n)
    dist = relax_edge_update(dist, v, a, w_edge)
    new_d = largest_cc_diameter(dist)
    reward = prev_d - new_d - alpha * w_edge
    return dist, adj, new_d, reward


def _stretch_potential(dist, opt):
    """Mean routing stretch of the partial solution, per env: ``dist/opt``
    averaged over finite off-diagonal pairs of the partial overlay's APSP
    ``dist`` against the full graph's APSP ``opt``."""
    n = dist.shape[-1]
    offdiag = ~torch.eye(n, dtype=torch.bool, device=dist.device)
    finite = (dist < float(INF) / 2) & offdiag
    ratio = torch.where(finite, dist / torch.clamp_min(opt, 1e-6), 0.0)
    cnt = finite.sum((1, 2)).float()
    return ratio.sum((1, 2)) / torch.clamp_min(cnt, 1.0)


def _episode_init(n_envs: int, n: int, device):
    dist0 = torch.full((n_envs, n, n), float(INF), dtype=torch.float32,
                       device=device)
    dist0.diagonal(dim1=1, dim2=2).fill_(0.0)
    zeros = torch.zeros(n_envs, dtype=torch.int64, device=device)
    return (dist0,
            torch.zeros((n_envs, n, n), dtype=torch.float32, device=device),
            torch.zeros((n_envs, n), dtype=torch.bool, device=device),
            zeros, zeros,                                # v, ring start
            torch.zeros(n_envs, dtype=torch.float32, device=device))


def _onehot(idx, n: int):
    """(E,) node ids -> (E, n) bool masks (a scatter: no host sync)."""
    out = torch.zeros((idx.shape[0], n), dtype=torch.bool, device=idx.device)
    return out.scatter_(1, idx[:, None], True)


def _reset_ring(start_t, n: int, pad_mask=None):
    """(visited, v, cur_start) at a ring start: only the start visited
    (and, for padded envs, the pad nodes, never selectable)."""
    visited = _onehot(start_t, n)
    if pad_mask is not None:
        visited = visited | pad_mask
    return visited, start_t, start_t


def _to(x, device, dtype):
    return torch.as_tensor(x, device=device).to(dtype)


# ---------------------------------------------------------------------------
# public engine entry points
# ---------------------------------------------------------------------------

@torch.no_grad()
def rollout_episodes(params: QParams, w_batch: torch.Tensor, starts,
                     eps_u, choice_u, eps, alpha, *, k_rings: int,
                     n_rounds: int = 3, sizes=None,
                     stretch_weight: float = 0.0):
    """Build K rings in each of E environments on ``w_batch``'s device.

    ``w_batch``: (E, N, N) latency stack; ``starts``/``eps_u``/``choice_u``
    from :func:`make_plan` (arrays or tensors).  Returns ``(actions (T, E),
    rewards (T, E), final_diameter (E,))`` tensors with T = K * N steps.

    ``sizes`` (optional, (E,) int) marks env e's graph as occupying only
    nodes ``[0, sizes[e])`` of the padded N-node block: pad nodes are
    masked visited at every ring reset, the closing edge fires per env at
    step ``sizes[e] - 1``, and later steps of that ring are no-ops (state
    frozen, reward 0).  ``sizes=None`` is the full-size behaviour.

    ``stretch_weight`` adds a routing-stretch shaping term: each step also
    pays ``stretch_weight * (potential(dist) - potential(dist'))`` against
    the full graph's APSP (``batcheval.batched_apsp``).  0.0 skips it.
    """
    dev = w_batch.device
    params = params.on(dev)
    n_envs, n = w_batch.shape[0], w_batch.shape[1]
    w_batch = w_batch.float().contiguous()
    if stretch_weight:
        opt = batched_apsp(w_batch)
    starts = _to(starts, dev, torch.int64)
    eps_u = _to(eps_u, dev, torch.float32)
    choice_u = _to(choice_u, dev, torch.float32)
    sizes = (torch.full((n_envs,), n, dtype=torch.int64, device=dev)
             if sizes is None else _to(sizes, dev, torch.int64))
    pad_mask = torch.arange(n, device=dev)[None, :] >= sizes[:, None]
    t_steps = k_rings * n
    actions = torch.empty((t_steps, n_envs), dtype=torch.int64, device=dev)
    rewards = torch.empty((t_steps, n_envs), dtype=torch.float32, device=dev)
    dist, adj, visited, v, cur_start, prev_d = _episode_init(n_envs, n, dev)
    for t in range(t_steps):
        rt = t % n
        if rt == 0:
            visited, v, cur_start = _reset_ring(starts[:, t // n], n,
                                                pad_mask)
        cl = sizes == rt + 1            # (E,) per-env ring-closing step
        active = sizes > rt             # (E,) padded envs idle past size
        a = _select_actions(params, w_batch, adj, visited, v, eps_u[t],
                            choice_u[t], eps, n_rounds)
        a = torch.where(cl, cur_start, a)
        dist2, adj2, new_d, reward = _apply_edge(w_batch, dist, adj, v, a,
                                                 prev_d, alpha)
        if stretch_weight:
            reward = reward + stretch_weight * (
                _stretch_potential(dist, opt) - _stretch_potential(dist2, opt))
        act3 = active[:, None, None]
        dist = torch.where(act3, dist2, dist)
        adj = torch.where(act3, adj2, adj)
        prev_d = torch.where(active, new_d, prev_d)
        rewards[t] = torch.where(active, reward, 0.0)
        visited = visited | (_onehot(a, n) & active[:, None])
        v = torch.where(cl | ~active, v, a)
        actions[t] = a
    return actions, rewards, prev_d


def train_epoch(params: QParams, opt_state: AdamWState, buf: DeviceBuffer,
                w_batch: torch.Tensor, gids, starts, eps_u, choice_u,
                sample_u, eps, gamma, lr, alpha, *, k_rings: int,
                n_rounds: int = 3, batch_size: int = 32,
                updates_per_step: int = 1, stretch_weight: float = 0.0):
    """One training epoch (Alg. 2) on ``w_batch``'s device.

    Episodes over the (E, N, N) graph stack with eps-greedy actions,
    incremental-relax rewards, transition pushes into ``buf`` (graph table
    slots ``gids``) and -- once the buffer holds ``batch_size``
    transitions -- ``updates_per_step`` TD/AdamW updates per step.
    Returns ``(params, opt_state, buf, final_diameter (E,), losses (T,),
    actions (T, E), rewards (T, E))``; ``losses`` is the per-step mean
    over the step's TD updates, NaN on steps before the buffer fills.
    ``buf`` is updated in place and returned.

    ``stretch_weight``: the same optional shaping as
    :func:`rollout_episodes`; the shaped reward is what the buffer stores.
    """
    dev = w_batch.device
    params = params.on(dev)
    n_envs, n = w_batch.shape[0], w_batch.shape[1]
    w_batch = w_batch.float().contiguous()
    if stretch_weight:
        with torch.no_grad():
            opt = batched_apsp(w_batch)
    gids = _to(gids, dev, torch.int64)
    starts = _to(starts, dev, torch.int64)
    eps_u = _to(eps_u, dev, torch.float32)
    choice_u = _to(choice_u, dev, torch.float32)
    sample_u = _to(sample_u, dev, torch.float32)
    buf.table.index_copy_(0, gids, w_batch)
    gids32 = gids.to(torch.int32)
    t_steps = k_rings * n
    actions = torch.empty((t_steps, n_envs), dtype=torch.int64, device=dev)
    rewards = torch.empty((t_steps, n_envs), dtype=torch.float32, device=dev)
    losses = torch.full((t_steps,), float("nan"), dtype=torch.float32,
                        device=dev)
    dist, adj, visited, v, cur_start, prev_d = _episode_init(n_envs, n, dev)
    for t in range(t_steps):
        rt = t % n
        closing = rt == n - 1
        with torch.no_grad():
            if rt == 0:
                visited, v, cur_start = _reset_ring(starts[:, t // n], n)
            if closing:
                a = cur_start
            else:
                a = _select_actions(params, w_batch, adj, visited, v,
                                    eps_u[t], choice_u[t], eps, n_rounds)
            dist2, adj2, prev_d, reward = _apply_edge(w_batch, dist, adj, v,
                                                      a, prev_d, alpha)
            if stretch_weight:
                reward = reward + stretch_weight * (
                    _stretch_potential(dist, opt)
                    - _stretch_potential(dist2, opt))
            visited_next = visited.scatter(1, a[:, None], True)
            if not closing:             # closing edges are not pushed
                _push(buf, gids32, adj.to(torch.uint8), v.to(torch.int32),
                      a.to(torch.int32), reward, adj2.to(torch.uint8),
                      visited_next.to(torch.uint8), False)
                v = a
            dist, adj, visited = dist2, adj2, visited_next
            rewards[t] = reward
            actions[t] = a
        if buf.size >= batch_size:
            total = 0.0
            for ui in range(updates_per_step):
                idx = (sample_u[t, ui] * float(buf.size)).to(torch.int64)
                idx = torch.clamp_max(idx, buf.size - 1)
                params, opt_state, loss = td_update_impl(
                    params, opt_state,
                    buf.table.index_select(0, buf.widx.index_select(0, idx)),
                    buf.adj.index_select(0, idx), buf.v.index_select(0, idx),
                    buf.action.index_select(0, idx),
                    buf.reward.index_select(0, idx),
                    buf.adj_next.index_select(0, idx),
                    buf.v_next.index_select(0, idx),
                    buf.visited_next.index_select(0, idx),
                    buf.done.index_select(0, idx), gamma, lr, n_rounds)
                total = total + loss
            losses[t] = total / updates_per_step
    return params, opt_state, buf, prev_d, losses, actions, rewards


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def perms_from_actions(starts: np.ndarray, actions: np.ndarray,
                       k_rings: int, n: int) -> List[List[np.ndarray]]:
    """Reassemble ring permutations from engine outputs.

    ``starts``: (E, K); ``actions``: (T, E).  Ring r of env e is its start
    node followed by the first N-1 actions of that ring's steps (the N-th
    action is the closing edge back to the start).
    """
    starts = np.asarray(starts)
    actions = np.asarray(actions)
    out: List[List[np.ndarray]] = []
    for e in range(starts.shape[0]):
        perms = []
        for r in range(k_rings):
            perm = np.empty(n, np.int64)
            perm[0] = starts[e, r]
            perm[1:] = actions[r * n:(r + 1) * n - 1, e]
            perms.append(perm)
        out.append(perms)
    return out
