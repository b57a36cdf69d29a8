"""The port's deep-Q constructor against the JAX package, on the CPU: the
embedding and Q-head, AdamW, the TD update, the plan and replay buffer, the
batched rollout and training epoch, the host debug loop, greedy
construction and ``train_dqn``.  Parameters are drawn by ``jax.random`` and
carried across with ``qparams_from_jax`` (torch cannot reproduce those
draws); inputs are seeded numpy arrays.

Tolerances: the Q-network multiplies matrices in another order than XLA,
so its values are held to rtol 1e-5 / atol 1e-6 and trained parameters to
rtol 1e-4; decisions (actions, rings) must be identical; rewards and
diameters are held to the reference's own host-vs-device bounds
(``tests/test_qlearning.py``: 1e-4 and 1e-3).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import embedding as je
from repro.core import qlearning as jq
from repro.core import rollout as jr
from repro.core.topology import make_latency
from repro.train import optimizer as jo
from repro_torch.core import batcheval as tb
from repro_torch.core import embedding as te
from repro_torch.core import qlearning as tq
from repro_torch.core import rollout as tr
from repro_torch.train import optimizer as to

@pytest.fixture(autouse=True)
def _on_cpu():
    with tb.eval_options(device="cpu"):
        yield


def _jparams(seed=0, p=16, h=64):
    return je.init_qparams(jax.random.PRNGKey(seed), p, h)


def _carry(jparams):
    return te.qparams_from_jax({k: np.asarray(v) for k, v in
                                jparams._asdict().items()}, device="cpu")


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _params_close(tparams, jparams, rtol, atol):
    got = te.qparams_to_numpy(tparams)
    for k, v in jparams._asdict().items():
        _close(got[k], v, rtol, atol)


def _states(n, e, seed):
    """(E, N, N) latencies, partial ring adjacencies and current nodes."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((e, n, n), np.float32)
    for i in range(e):
        perm = rng.permutation(n)[:rng.integers(2, n)]
        adj[i, perm[:-1], perm[1:]] = adj[i, perm[1:], perm[:-1]] = 1.0
    return adj, rng.integers(0, n, size=e).astype(np.int32)


@pytest.mark.parametrize("dist", ["uniform", "gaussian", "fabric", "bitnode"])
@pytest.mark.parametrize("n", [9, 16])
@pytest.mark.parametrize("n_rounds", [1, 3])
def test_embed_and_q_values_match_reference(dist, n, n_rounds):
    jp = _jparams(seed=n + n_rounds)
    tp = _carry(jp)
    ws = np.stack([make_latency(dist, n, seed=s) for s in range(3)])
    adj, vs = _states(n, 3, seed=n)
    t = torch.from_numpy
    with torch.no_grad():
        _close(te.embed(tp, t(ws[0]), t(adj[0]), n_rounds),
               je.embed(jp, jnp.asarray(ws[0]), jnp.asarray(adj[0]),
                        n_rounds), 1e-5, 1e-6)
        _close(te.q_values(tp, t(ws[1]), t(adj[1]), int(vs[1]), n_rounds),
               je.q_values(jp, jnp.asarray(ws[1]), jnp.asarray(adj[1]),
                           jnp.int32(vs[1]), n_rounds), 1e-5, 1e-6)
        _close(te.q_values_batch(tp, t(ws), t(adj), t(vs), n_rounds),
               je.q_values_batch(jp, jnp.asarray(ws), jnp.asarray(adj),
                                 jnp.asarray(vs), n_rounds=n_rounds),
               1e-5, 1e-6)


def test_qparams_carry_round_trip_and_init_shapes():
    jp = _jparams(seed=3, p=8, h=16)
    back = te.qparams_to_numpy(_carry(jp))
    assert list(back) == list(te.THETAS)
    for k, v in jp._asdict().items():
        assert np.array_equal(back[k], np.asarray(v))
    init = te.init_qparams(torch.Generator().manual_seed(0), 8, 16,
                           device="cpu")
    again = te.init_qparams(torch.Generator().manual_seed(0), 8, 16,
                            device="cpu")
    for k, v in jp._asdict().items():
        assert tuple(getattr(init, k).shape) == v.shape
        assert torch.equal(getattr(init, k), getattr(again, k))
    assert [n for n, _ in init.named_parameters()] == list(te.THETAS)


@pytest.mark.parametrize("clip_norm", [None, 0.05, 1e6])
def test_adamw_update_matches_reference(clip_norm):
    rng = np.random.default_rng(7)
    shapes = {"a": (5,), "b": (3, 4), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg_j = jo.AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, weight_decay=0.01,
                           clip_norm=clip_norm)
    cfg_t = to.AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, weight_decay=0.01,
                           clip_norm=clip_norm)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    sj, st = jo.adamw_init(pj), to.adamw_init(pt)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        pj, sj, nj = jo.adamw_update(cfg_j, {k: jnp.asarray(v)
                                             for k, v in g.items()}, sj, pj)
        pt, st, nt = to.adamw_update(cfg_t, {k: torch.from_numpy(v)
                                             for k, v in g.items()}, st, pt)
        _close(nt, nj, 1e-6, 1e-6)
        for k in shapes:
            _close(pt[k], pj[k], 1e-6, 1e-6)
            _close(st.mu[k], sj.mu[k], 1e-6, 1e-6)
            _close(st.nu[k], sj.nu[k], 1e-6, 1e-6)
    assert int(st.step) == int(sj.step) == 3
    # lists work as well as dicts, and the schedule is the reference's
    lp, _, _ = to.adamw_update(cfg_t, [torch.ones(2)],
                               to.adamw_init([torch.zeros(2)]),
                               [torch.zeros(2)])
    assert isinstance(lp, list) and lp[0].shape == (2,)
    sched_t = to.warmup_cosine(1e-3, 10, 100)
    sched_j = jo.warmup_cosine(1e-3, 10, 100)
    for s in (0, 5, 10, 50, 100, 200):
        _close(sched_t(torch.tensor(s)), sched_j(jnp.asarray(s)), 1e-6, 1e-9)


def test_td_update_matches_reference():
    n, b = 9, 6
    jp = _jparams(seed=5, p=8, h=16)
    tp = _carry(jp)
    rng = np.random.default_rng(1)
    w = np.stack([make_latency("gaussian", n, seed=s) for s in range(b)])
    adj, v = _states(n, b, seed=2)
    adj_next, v_next = _states(n, b, seed=3)
    batch = (w, adj.astype(np.uint8), v,
             rng.integers(0, n, size=b).astype(np.int32),
             rng.normal(size=b).astype(np.float32), adj_next.astype(np.uint8),
             v_next, (rng.random((b, n)) < 0.5).astype(np.uint8),
             (rng.random(b) < 0.3).astype(np.uint8))
    sj, st = jo.adamw_init(jp), to.adamw_init(tp.tensors())
    for step in range(2):
        jp, sj, lj = jq._td_update(jp, sj, *[jnp.asarray(x) for x in batch],
                                   jnp.float32(0.99), jnp.float32(5e-3), 2)
        tp, st, lt = tr.td_update_impl(tp, st,
                                       *[torch.from_numpy(x) for x in batch],
                                       0.99, 5e-3, 2)
        _close(lt, lj, 1e-5, 1e-6)
        _params_close(tp, jp, 1e-5, 1e-6)
        for k, mj in sj.mu._asdict().items():
            _close(st.mu[k], mj, 1e-5, 1e-6)


def test_make_plan_and_replay_buffer_identical():
    for args in ((3, 2, 7, 2, 4), (1, 8, 5, 0, 0), (4, 1, 6, 1, 3)):
        a = tr.make_plan(np.random.default_rng(5), *args)
        b = jr.make_plan(np.random.default_rng(5), *args)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for cap, n_envs, k, n in ((20000, 1, 2, 14), (500, 4, 2, 8), (7, 3, 2, 5)):
        assert tr.graph_slots(cap, n_envs, k, n) == \
            jr.graph_slots(cap, n_envs, k, n)
    bt, bj = tq.ReplayBuffer(6, 4), jq.ReplayBuffer(6, 4)
    rng = np.random.default_rng(0)
    for i in range(11):
        w = make_latency("uniform", 4, seed=i // 4)
        a = (rng.random((4, 4)) < 0.5).astype(np.uint8)
        args = (w, a, i % 4, (i + 1) % 4, float(i), a.T.copy(), 1,
                (rng.random(4) < 0.5).astype(np.uint8), i % 3 == 0)
        bt.push(*args)
        bj.push(*args)
    assert (bt.size, bt.ptr, bt.n_graphs) == (bj.size, bj.ptr, bj.n_graphs)
    assert sorted(bt.graphs) == sorted(bj.graphs)
    u = np.random.default_rng(2).random(5, dtype=np.float32)
    for x, y in zip(bt.sample_at(u), bj.sample_at(u)):
        assert np.array_equal(x, y)
    for x, y in zip(bt.sample(np.random.default_rng(3), 4),
                    bj.sample(np.random.default_rng(3), 4)):
        assert np.array_equal(x, y)


def _rollout_both(jp, ws, starts, plan, eps, **kw):
    aj, rj, dj = jr.rollout_episodes(
        jp, jnp.asarray(ws, jnp.float32), jnp.asarray(starts),
        jnp.asarray(plan.eps_u), jnp.asarray(plan.choice_u), eps, 0.1,
        **{k: (jnp.asarray(v) if k == "sizes" else v) for k, v in kw.items()})
    at, rt, dt = tr.rollout_episodes(
        _carry(jp), torch.from_numpy(ws.astype(np.float32)), starts,
        plan.eps_u, plan.choice_u, eps, 0.1, **kw)
    return (np.asarray(aj), np.asarray(rj), np.asarray(dj),
            at.numpy(), rt.numpy(), dt.numpy())


@pytest.mark.parametrize("case", ["plain", "sizes", "stretch"])
def test_rollout_episodes_match_reference(case):
    n, k, n_envs = 9, 2, 3
    jp = _jparams(seed=1)
    ws = np.stack([make_latency("uniform", n, seed=5 + i)
                   for i in range(n_envs)])
    plan = jr.make_plan(np.random.default_rng(3), n_envs, k, n)
    starts = plan.starts
    kw = dict(k_rings=k, n_rounds=3)
    if case == "sizes":
        sizes = np.array([9, 6, 4], np.int32)
        ws[1, 6:, :] = ws[1, :, 6:] = 0.0
        ws[2, 4:, :] = ws[2, :, 4:] = 0.0
        starts = (starts % sizes[:, None]).astype(np.int32)
        kw["sizes"] = sizes
    if case == "stretch":
        kw["stretch_weight"] = 0.5
    aj, rj, dj, at, rt, dt = _rollout_both(jp, ws, starts, plan, 0.4, **kw)
    assert np.array_equal(at, aj)
    for pt, pj in zip(tr.perms_from_actions(starts, at, k, n),
                      jr.perms_from_actions(starts, aj, k, n)):
        assert all(np.array_equal(x, y) for x, y in zip(pt, pj))
    np.testing.assert_allclose(rt, rj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(dt, dj, rtol=1e-3, atol=1e-3)


def test_train_epoch_matches_reference():
    """eps = 1.0: every action comes from the plan, so both engines take
    the same actions and fill the buffer identically; the TD updates then
    see the same batches."""
    n, k, n_envs, cap, batch = 8, 2, 2, 20, 4
    jp = _jparams(seed=2, p=8, h=16)
    tp = _carry(jp)
    slots = jr.graph_slots(cap, n_envs, k, n)
    ws = np.stack([make_latency("uniform", n, seed=20 + i)
                   for i in range(n_envs)]).astype(np.float32)
    plan = jr.make_plan(np.random.default_rng(1), n_envs, k, n,
                        updates_per_step=2, batch_size=batch)
    gids = np.array([1, 2], np.int32)
    scalars = (1.0, 0.99, 5e-3, 0.1)
    kw = dict(k_rings=k, n_rounds=2, batch_size=batch, updates_per_step=2)
    pj, sj, bj, dj, lj, aj, rj = jr.train_epoch(
        jp, jo.adamw_init(jp), jr.init_buffer(cap, n, slots),
        jnp.asarray(ws), jnp.asarray(gids), jnp.asarray(plan.starts),
        jnp.asarray(plan.eps_u), jnp.asarray(plan.choice_u),
        jnp.asarray(plan.sample_u), *scalars, **kw)
    pt, st, bt, dt, lt, at, rt = tr.train_epoch(
        tp, to.adamw_init(tp.tensors()),
        tr.init_buffer(cap, n, slots, device="cpu"), torch.from_numpy(ws),
        gids, plan.starts, plan.eps_u, plan.choice_u, plan.sample_u,
        *scalars, **kw)
    assert np.array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)
    _params_close(pt, pj, 1e-4, 1e-5)
    for k_, mj in sj.mu._asdict().items():
        _close(st.mu[k_], mj, 1e-4, 1e-5)
        _close(st.nu[k_], sj.nu._asdict()[k_], 1e-4, 1e-5)
    assert int(st.step) == int(sj.step) > 0
    assert np.array_equal(np.isnan(lt.numpy()), np.isnan(np.asarray(lj)))
    _close(lt.numpy(), lj, 1e-4, 1e-5)
    # the buffer wrapped (2 envs x 2 rings x 7 pushes > 20) identically
    assert (bt.size, bt.ptr) == (int(bj.size), int(bj.ptr)) == (20, 8)
    for name in ("table", "widx", "adj", "v", "action", "adj_next", "v_next",
                 "visited_next", "done"):
        assert np.array_equal(getattr(bt, name).numpy(),
                              np.asarray(getattr(bj, name))), name
    np.testing.assert_allclose(bt.reward.numpy(), np.asarray(bj.reward),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["device", "host"])
def test_construct_ring_and_dgro_overlay_match_reference(mode):
    cfg_j = jq.DQNConfig(n=10, k_rings=2, rollout=mode)
    cfg_t = tq.DQNConfig(n=10, k_rings=2, rollout=mode)
    jp = _jparams(seed=4)
    tp = _carry(jp)
    w = make_latency("gaussian", 10, seed=2)
    perms_j, d_j = jq.construct_ring_dqn(jp, cfg_j, w,
                                         np.random.default_rng(11))
    perms_t, d_t = tq.construct_ring_dqn(tp, cfg_t, w,
                                         np.random.default_rng(11))
    assert all(np.array_equal(a, b) for a, b in zip(perms_t, perms_j))
    assert d_t == pytest.approx(d_j, rel=1e-6)
    ov_j = jq.dgro_overlay(jp, cfg_j, w, n_starts=4, seed=13)
    ov_t = tq.dgro_overlay(tp, cfg_t, w, n_starts=4, seed=13)
    assert ov_t.policy == ov_j.policy == "dgro-dqn"
    assert all(np.array_equal(a, b) for a, b in zip(ov_t.rings, ov_j.rings))
    assert ov_t.diameter() == pytest.approx(ov_j.diameter(), rel=1e-6)
    assert ov_t.to_json() == ov_j.to_json()


@pytest.mark.parametrize("mode", ["device", "host"])
def test_train_dqn_matches_reference_with_carried_init(monkeypatch, mode):
    """``train_dqn`` at n=8, k=1, 2 epochs, with the port's init patched to
    return the reference's parameters: same final parameters."""
    kw = dict(n=8, k_rings=1, p=8, h=16, epochs=2, batch_size=4,
              buffer_capacity=64, seed=3, rollout=mode)
    monkeypatch.setattr(
        tq, "init_qparams",
        lambda gen, p, h, device=None: _carry(je.init_qparams(
            jax.random.PRNGKey(3), p, h)))
    pj, log_j = jq.train_dqn(jq.DQNConfig(**kw), eval_every=1,
                             eval_graphs=1)
    pt, log_t = tq.train_dqn(tq.DQNConfig(**kw), eval_every=1,
                             eval_graphs=1)
    _params_close(pt, pj, 1e-4, 1e-5)
    assert log_t.epochs == log_j.epochs == [0, 1]
    np.testing.assert_allclose(log_t.loss, log_j.loss, rtol=1e-4)
    np.testing.assert_allclose(log_t.test_diam, log_j.test_diam, rtol=1e-5)
    assert log_t.steps_per_sec > 0
