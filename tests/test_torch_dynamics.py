"""The port's churn engine (``repro_torch.dynamics``) against
``repro.dynamics`` on the CPU.

* The cases of ``tests/test_dynamics.py`` hold on the port.
* Bitwise parity, event by event: ``IncrementalDistances`` in both
  packages under one random op stream (maintained distances, ``alive``,
  ``adj`` and ``stats`` after every op; thresholds 1 and 3, and
  ``mode="full"``); the batched and stream updates; every node-level
  trace of ``SCENARIOS`` under all four policies (samples, final
  diameter, stats, adaptations); ``restore`` then ``process`` / ``flush``.
* ``Trace.to_json`` byte-identical for every scenario.
* The routing probe (``route_probe > 0``) replays the reference's
  stretch samples exactly.
* ``cluster_split_merge`` raises the reference's ``ValueError`` (the flat
  engine has no clusters), and every entry point the device error without
  CUDA.

The port's APSP rebuilds run the plain Floyd-Warshall here, the CPU method
of both packages, so distances are compared for exact equality.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import dynamics as jdyn
from repro.dynamics import incremental as jincr
from repro_torch.core import batcheval
from repro_torch.core.diameter import (INF, adjacency_from_edges,
                                       adjacency_from_rings, diameter_scipy,
                                       is_edge, ring_edges)
from repro_torch.core.topology import make_latency
from repro_torch.dynamics import (ChurnEngine, DGROPolicy, Event,
                                  IncrementalDistances, POLICIES, SCENARIOS,
                                  Trace)
from repro_torch.dynamics import incremental as incr
from repro_torch.dynamics.scenarios import EVENT_KINDS
from repro_torch.membership.elastic import plan_rescale_from_engine

NODE_SCENARIOS = [s for s in SCENARIOS if s != "cluster_split_merge"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with batcheval.eval_options(device="cpu"):
        yield


def _scipy_dists(adj: np.ndarray) -> np.ndarray:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    a = np.asarray(adj, np.float64)
    return dijkstra(csr_matrix(np.where(is_edge(a), a, 0.0)), directed=False)


def _fresh_state(n_live: int, capacity: int, seed: int, dist="uniform"):
    w = make_latency(dist, capacity, seed=seed)
    rng = np.random.default_rng(seed)
    alive = np.zeros(capacity, bool)
    alive[:n_live] = True
    adj = adjacency_from_edges(w, ring_edges(rng.permutation(n_live)))
    return w, adj, alive


def _random_ops(inc, rng, n_ops: int):
    """Yield a random churn op applied to ``inc``, one at a time."""
    for _ in range(n_ops):
        r = rng.random()
        live = inc.live_ids()
        if r < 0.55 or inc.n_live < 6:
            u, v = rng.choice(live, size=2, replace=False)
            inc.add_edge(int(u), int(v))
        elif r < 0.8 and (~inc.alive).any():
            u = int(np.flatnonzero(~inc.alive)[0])
            nbrs = rng.choice(live, size=min(3, len(live)), replace=False)
            inc.join(u, [int(x) for x in nbrs])
        else:
            inc.leave(int(rng.choice(live)))
        yield


def _assert_live_parity(inc, tag=""):
    live = inc.live_ids()
    want = _scipy_dists(inc.adj[np.ix_(live, live)])
    got = np.asarray(inc.live_distances(), np.float64)
    reach = np.isfinite(want)
    assert (got < float(INF) / 2).tolist() == reach.tolist(), tag
    assert np.allclose(got[reach], want[reach], rtol=1e-4, atol=1e-3), tag


def _samples(res):
    """A run's samples as plain tuples, NaN as a string (the packages'
    ``TrajectorySample`` classes compare only to their own)."""
    return [tuple("nan" if x != x else x for x in dataclasses.astuple(s))
            for s in res.samples]


# ---------------------------------------------------------------------------
# the cases of tests/test_dynamics.py, on the port
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(st.integers(10, 22), st.integers(0, 10_000))
def test_incremental_exact_after_every_event(n, seed):
    w, adj, alive = _fresh_state(n, n + 4, seed)
    inc = IncrementalDistances(w, adj, alive, rebuild_threshold=1)
    rng = np.random.default_rng(seed + 1)
    _assert_live_parity(inc, "init")
    for i, _ in enumerate(_random_ops(inc, rng, 30)):
        _assert_live_parity(inc, f"op{i}")
    assert inc.stats["rebuilds"] >= 1


def test_stale_distances_are_lower_bounds_until_refresh():
    w, adj, alive = _fresh_state(16, 16, seed=3)
    inc = IncrementalDistances(w, adj, alive, rebuild_threshold=100)
    rng = np.random.default_rng(4)
    for u in rng.choice(16, size=4, replace=False):
        inc.leave(int(u))
    assert inc.pending_deletions == 4 and inc.stats["rebuilds"] == 0
    live = inc.live_ids()
    want = _scipy_dists(inc.adj[np.ix_(live, live)])
    got = np.asarray(inc.live_distances(), np.float64)
    reach = np.isfinite(want)
    assert (got[reach] <= want[reach] + 1e-3).all()
    inc.refresh()
    assert inc.pending_deletions == 0
    _assert_live_parity(inc, "post-refresh")


def test_set_latency_increase_against_current_edge_weight():
    w, adj, alive = _fresh_state(10, 10, seed=1)
    inc = IncrementalDistances(w, adj, alive, rebuild_threshold=1)
    u, v = int(inc.live_ids()[0]), int(inc.live_ids()[5])
    inc.add_edge(u, v, weight=0.5)
    _assert_live_parity(inc, "after cheap edge")
    mid = 0.5 + float(w[u, v] - 0.5) / 2
    inc.set_latency(u, v, mid)
    inc.refresh()
    _assert_live_parity(inc, "after increase + refresh")
    inc.set_latency(u, v, 0.25)
    _assert_live_parity(inc, "after decrease")


def test_full_mode_and_incremental_agree():
    w, adj, alive = _fresh_state(14, 18, seed=9)
    a = IncrementalDistances(w, adj, alive, mode="incremental",
                             rebuild_threshold=3)
    b = IncrementalDistances(w, adj, alive, mode="full")
    rng_a, rng_b = (np.random.default_rng(11) for _ in range(2))
    list(_random_ops(a, rng_a, 25))
    list(_random_ops(b, rng_b, 25))
    a.refresh()
    assert np.array_equal(a.alive, b.alive)
    assert np.allclose(a.live_distances(), b.live_distances(),
                       rtol=1e-4, atol=1e-3)


def test_trace_json_roundtrip_and_determinism():
    for name, make in SCENARIOS.items():
        t1, t2 = make(n0=20, seed=5), make(n0=20, seed=5)
        assert t1.events == t2.events, name
        rt = Trace.from_json(t1.to_json())
        assert rt.events == t1.events and rt.n0 == t1.n0
        assert (rt.capacity, rt.dist, rt.seed) == (
            t1.capacity, t1.dist, t1.seed)
        assert all(e.kind in EVENT_KINDS for e in t1.events), name


def test_event_kind_validated():
    with pytest.raises(ValueError):
        Event(time=0.0, kind="reboot")
    with pytest.raises(ValueError):
        Event(time=0.0, kind="join", node=-1)
    with pytest.raises(ValueError):
        Event(time=0.0, kind="join", node=1, peer=2)
    with pytest.raises(ValueError):
        Trace(n0=2, capacity=2, dist="uniform", seed=0,
              events=[Event(time=1.0, kind="join", node=2)])


def test_engine_survives_full_drain_then_rejoin():
    events = [Event(time=1.0, kind="leave", node=0),
              Event(time=2.0, kind="leave", node=1),
              Event(time=3.0, kind="join", node=2),
              Event(time=4.0, kind="join", node=3)]
    trace = Trace(n0=2, capacity=4, dist="uniform", seed=0,
                  events=events, name="drain")
    for pname, P in POLICIES.items():
        eng = ChurnEngine(trace, P(), seed=0)
        eng.run()
        assert eng.inc.n_live == 2, pname


def test_engine_run_is_single_use():
    trace = SCENARIOS["flash_crowd"](n0=12, seed=0)
    eng = ChurnEngine(trace, POLICIES["rapid"](), seed=0)
    eng.run()
    with pytest.raises(RuntimeError):
        eng.run()


def test_engine_deterministic_replay():
    trace = SCENARIOS["poisson_churn"](n0=18, seed=2)
    runs = [ChurnEngine(trace, DGROPolicy(), seed=7,
                        detect_failures=True).run() for _ in range(2)]
    assert runs[0].samples == runs[1].samples
    assert runs[0].final_diameter == runs[1].final_diameter


@pytest.mark.parametrize("policy", list(POLICIES))
def test_engine_scenarios_stay_connected(policy):
    for name in ("flash_crowd", "regional_failure", "straggler_storm"):
        trace = SCENARIOS[name](n0=18, seed=1)
        res = ChurnEngine(trace, POLICIES[policy](), seed=3,
                          detect_failures=True).run()
        assert np.isfinite(res.final_diameter), (name, policy)
        assert res.final_diameter < float(INF) / 2, (name, policy)
        assert all(s.diameter < float(INF) / 2 for s in res.samples), name


def test_engine_distances_exact_after_trace():
    trace = SCENARIOS["poisson_churn"](n0=16, seed=6)
    eng = ChurnEngine(trace, POLICIES["rapid"](), seed=1)
    res = eng.run()
    live = eng.live_ids()
    want = diameter_scipy(eng.inc.adj[np.ix_(live, live)])
    assert res.final_diameter == pytest.approx(want, rel=1e-4)


def test_regional_failure_kills_site_and_dgro_recovers():
    trace = SCENARIOS["regional_failure"](n0=34, seed=4)
    victims = {e.node for e in trace.events}
    eng = ChurnEngine(trace, DGROPolicy(adapt_every=1), seed=2,
                      detect_failures=True)
    res = eng.run()
    assert not eng.alive[list(victims)].any()
    assert eng.inc.n_live == 34 - len(victims)
    assert np.isfinite(res.final_diameter)


def test_plan_rescale_from_engine_excludes_dead_and_stragglers():
    events = [Event(time=1_000.0, kind="fail", node=5),
              Event(time=3_000.0, kind="straggler", node=11, factor=25.0)]
    trace = Trace(n0=24, capacity=24, dist="fabric", seed=3,
                  events=events, name="rescale")
    eng = ChurnEngine(trace, DGROPolicy(), seed=0, detect_failures=True)
    eng.run()
    plan = plan_rescale_from_engine(eng, model_hosts=2, old_world=24)
    assert 5 not in plan.hosts and 11 not in plan.hosts
    pods, data, model = plan.mesh_shape
    assert pods * data * model == len(plan.hosts) and model == 2


def test_dgro_self_repair_survives_shrinking_below_sample_size():
    events = [Event(time=1_000.0 * (i + 1), kind="leave", node=i)
              for i in range(8)]
    trace = Trace(n0=12, capacity=12, dist="uniform", seed=5,
                  events=events, name="shrink")
    eng = ChurnEngine(trace, DGROPolicy(adapt_every=1), seed=1)
    res = eng.run()
    assert eng.inc.n_live == 4
    assert np.isfinite(res.final_diameter)


def test_adjacency_from_rings_rejects_non_permutations():
    w = make_latency("uniform", 8, seed=0)
    with pytest.raises(ValueError):
        adjacency_from_rings(w, [np.array([0, 1, 2])])
    with pytest.raises(ValueError):
        adjacency_from_rings(w, [np.array([0, 1, 2, 3, 4, 5, 6, 6])])
    with pytest.raises(ValueError):
        adjacency_from_edges(w, [(0, 9)])
    with pytest.raises(ValueError):
        adjacency_from_edges(w, [(-1, 2)])
    adjacency_from_rings(w, [np.arange(8)])
    adjacency_from_edges(w, [(0, 7)])


# ---------------------------------------------------------------------------
# bitwise parity with the reference, event by event
# ---------------------------------------------------------------------------

def _mixed_ops(inc, rng, n_ops: int):
    """A random op stream over every mutation ``IncrementalDistances``
    has; the same ``rng`` state drives both packages' copies."""
    for _ in range(n_ops):
        r = rng.random()
        live = inc.live_ids()
        if r < 0.4 or inc.n_live < 6:
            u, v = rng.choice(live, size=2, replace=False)
            weight = None if rng.random() < 0.7 else float(rng.uniform(1, 50))
            inc.add_edge(int(u), int(v), weight)
        elif r < 0.55 and (~inc.alive).any():
            u = int(np.flatnonzero(~inc.alive)[0])
            nbrs = rng.choice(live, size=min(3, len(live)), replace=False)
            inc.join(u, [int(x) for x in nbrs])
        elif r < 0.7:
            inc.leave(int(rng.choice(live)))
        elif r < 0.8:
            u, v = rng.choice(live, size=2, replace=False)
            inc.remove_edge(int(u), int(v))
        elif r < 0.95:
            u = int(rng.choice(live))
            nb = np.flatnonzero(is_edge(inc.adj[u]))
            v = int(nb[0]) if nb.size else int(rng.choice(live))
            inc.set_latency(u, v, float(inc.adj[u, v] * rng.uniform(0.5,
                                                                   1.5)))
        else:
            inc.apply_latency_matrix(inc.w * np.float32(rng.uniform(0.8,
                                                                   1.2)))
        yield


@pytest.mark.parametrize("mode,threshold", [("incremental", 1),
                                            ("incremental", 3),
                                            ("full", 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_incremental_distances_bitwise_every_op(mode, threshold, seed):
    w, adj, alive = _fresh_state(14, 20, seed, dist="bitnode")
    got = IncrementalDistances(w, adj, alive, rebuild_threshold=threshold,
                               mode=mode)
    want = jincr.IncrementalDistances(w, adj, alive,
                                      rebuild_threshold=threshold, mode=mode)
    ops = zip(_mixed_ops(got, np.random.default_rng(seed + 5), 40),
              _mixed_ops(want, np.random.default_rng(seed + 5), 40))
    for i, _ in enumerate(ops):
        assert np.array_equal(got.distances, want.distances), i
        assert np.array_equal(got.alive, want.alive), i
        assert np.array_equal(got.adj, want.adj), i
        assert np.array_equal(got.w, want.w), i
        assert got.stats == want.stats, i
        assert got.pending_deletions == want.pending_deletions, i
        assert got.diameter() == want.diameter(), i
    assert got.diameter(exact=True) == want.diameter(exact=True)
    assert np.array_equal(got.live_distances(), want.live_distances())


def _replica_stack(b, n, seed):
    w = make_latency("gaussian", n, seed=seed)
    rng = np.random.default_rng(seed)
    dists = []
    for _ in range(b):
        d = _scipy_dists(adjacency_from_rings(w, [rng.permutation(n)]))
        dists.append(np.where(np.isfinite(d), d, float(INF)))
    return w, np.stack(dists).astype(np.float32), rng


def test_batched_and_stream_updates_bitwise_reference():
    b, n, t_steps = 5, 12, 4
    w, dists, rng = _replica_stack(b, n, 2)
    us = rng.integers(0, n, size=(t_steps, b))
    vs = (us + rng.integers(1, n, size=(t_steps, b))) % n
    ws = w[us, vs].astype(np.float32)
    td = torch.from_numpy(dists)
    got = incr.relax_edges_batched(td, us[0], vs[0], ws[0])
    want = jincr.relax_edges_batched(jnp.asarray(dists), jnp.asarray(us[0]),
                                     jnp.asarray(vs[0]), jnp.asarray(ws[0]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    stream = incr.relax_edge_stream_batched(td, us, vs, ws)
    jstream = jincr.relax_edge_stream_batched(
        jnp.asarray(dists), jnp.asarray(us), jnp.asarray(vs),
        jnp.asarray(ws))
    assert np.array_equal(stream.numpy(), np.asarray(jstream))
    steps = td
    for t in range(t_steps):
        steps = incr.relax_edges_batched(steps, torch.from_numpy(us[t]),
                                         torch.from_numpy(vs[t]),
                                         torch.from_numpy(ws[t]))
    assert torch.equal(stream, steps)
    for i in range(b):
        one = incr.relax_edge(td[i], int(us[0, i]), int(vs[0, i]),
                              float(ws[0, i]))
        assert torch.equal(one, got[i])
    # tombstone then re-join the same slot, single and batched
    u = rng.integers(0, n, size=b)
    tomb = incr.tombstones_batched(td, u)
    jtomb = jincr.tombstones_batched(jnp.asarray(dists), jnp.asarray(u))
    assert np.array_equal(tomb.numpy(), np.asarray(jtomb))
    rows = np.full((b, n), float(INF), np.float32)
    for i in range(b):
        nbrs = rng.choice(np.delete(np.arange(n), u[i]), size=2,
                          replace=False)
        rows[i, nbrs] = w[u[i], nbrs]
        assert torch.equal(incr.tombstone(td[i], int(u[i])), tomb[i])
    join = incr.join_nodes_batched(tomb, rows, u)
    jjoin = jincr.join_nodes_batched(jtomb, jnp.asarray(rows), jnp.asarray(u))
    assert np.array_equal(join.numpy(), np.asarray(jjoin))
    for i in range(b):
        one = incr.join_node(tomb[i], torch.from_numpy(rows[i]), int(u[i]))
        assert torch.equal(one, join[i])
        assert np.array_equal(one.numpy(), np.asarray(jincr.join_node(
            jtomb[i], jnp.asarray(rows[i]), int(u[i]))))
    assert torch.equal(td, torch.from_numpy(dists))     # out of place


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("scenario", NODE_SCENARIOS)
def test_scenario_replay_bitwise_reference(scenario, policy):
    """Every node-level trace at n0=18 (``tests/test_dynamics.py``'s size)
    under every policy: the samples (time, kind, n_live, diameter, NaN
    stretch), the final diameter, the stats (adaptations included) and the
    end state equal the reference's."""
    trace = SCENARIOS[scenario](n0=18, seed=1)
    jtrace = jdyn.SCENARIOS[scenario](n0=18, seed=1)
    assert trace.to_json() == jtrace.to_json()
    for kw in ({"detect_failures": True, "seed": 3},
               {"rebuild_threshold": 2, "seed": 5}):
        eng = ChurnEngine(trace, POLICIES[policy](), **kw)
        jeng = jdyn.ChurnEngine(jtrace, jdyn.POLICIES[policy](), **kw)
        res, jres = eng.run(), jeng.run()
        assert _samples(res) == _samples(jres)
        assert res.final_diameter == jres.final_diameter
        assert res.stats == jres.stats
        assert np.array_equal(eng.inc.distances, jeng.inc.distances)
        assert np.array_equal(eng.inc.adj, jeng.inc.adj)
        assert eng.events_processed == jeng.events_processed
        assert eng.initial_overlay.to_json() == jeng.initial_overlay.to_json()
        if policy in ("dgro", "chord", "rapid", "perigee"):
            assert eng.policy.rings == jeng.policy.rings


def test_sample_exact_replay_bitwise_reference():
    trace = SCENARIOS["churn_with_drift"](n0=18, seed=4)
    jtrace = jdyn.SCENARIOS["churn_with_drift"](n0=18, seed=4)
    eng = ChurnEngine(trace, DGROPolicy(adapt_every=2), seed=1)
    jeng = jdyn.ChurnEngine(jtrace, jdyn.DGROPolicy(adapt_every=2), seed=1)
    res, jres = eng.run(sample_exact=True), jeng.run(sample_exact=True)
    assert _samples(res) == _samples(jres)
    assert res.stats == jres.stats and res.stats["adaptations"] > 0
    assert res.mean_diameter == jres.mean_diameter
    assert res.peak_diameter == jres.peak_diameter
    no_samples = ChurnEngine(trace, DGROPolicy(), seed=1).run(record=False)
    assert no_samples.samples == [] and np.isnan(no_samples.mean_diameter)


def test_cluster_events_raise_the_reference_error():
    trace = SCENARIOS["cluster_split_merge"](n0=18, seed=0)
    jtrace = jdyn.SCENARIOS["cluster_split_merge"](n0=18, seed=0)
    assert trace.to_json() == jtrace.to_json()
    with pytest.raises(ValueError) as got:
        ChurnEngine(trace, POLICIES["rapid"](), seed=0).run()
    with pytest.raises(ValueError) as want:
        jdyn.ChurnEngine(jtrace, jdyn.POLICIES["rapid"](), seed=0).run()
    assert str(got.value) == str(want.value)


def _process_all(eng, events):
    out = [eng.process(e) for e in events]
    return out, eng.pending_confirmations, eng.flush()


def test_process_flush_and_restore_bitwise_reference():
    """The live-ingest path with SWIM confirmations pending, then a restore
    from the snapshotted state and more events, in both packages."""
    trace = SCENARIOS["regional_failure"](n0=34, seed=2)
    jtrace = jdyn.SCENARIOS["regional_failure"](n0=34, seed=2)
    events = sorted(trace.events, key=lambda e: e.time)
    half = len(events) // 2
    kw = dict(detect_failures=True, seed=6, rebuild_threshold=3)
    eng = ChurnEngine(trace, DGROPolicy(adapt_every=2), **kw)
    jeng = jdyn.ChurnEngine(jtrace, jdyn.DGROPolicy(adapt_every=2), **kw)
    jevents = sorted(jtrace.events, key=lambda e: e.time)
    got = [eng.process(e) for e in events[:half]]
    want = [jeng.process(e) for e in jevents[:half]]
    assert got == want and eng.pending_confirmations == \
        jeng.pending_confirmations > 0
    assert eng.flush(until=events[half].time) == \
        jeng.flush(until=jevents[half].time)
    assert np.array_equal(eng.inc.distances, jeng.inc.distances)
    with pytest.raises(ValueError):
        eng.process(Event(time=0.0, kind="fail", node=1))

    def snapshot(e):
        return dict(w=e.w, adj=e.inc.adj, alive=e.alive,
                    latency_factor=e.latency_factor,
                    drift_scale=e.drift_scale, clock=e.clock,
                    events_processed=e.events_processed,
                    rebuild_threshold=3, detect_failures=True, seed=9)

    r = ChurnEngine.restore(trace, copy.deepcopy(eng.policy), **snapshot(eng))
    jr = jdyn.ChurnEngine.restore(jtrace, copy.deepcopy(jeng.policy),
                                  **snapshot(jeng))
    assert np.array_equal(r.inc.distances, jr.inc.distances)
    a = _process_all(r, events[half:])
    b = _process_all(jr, jevents[half:])
    assert a == b
    assert np.array_equal(r.inc.distances, jr.inc.distances)
    assert r.inc.stats == jr.inc.stats
    assert r.policy.adaptations == jr.policy.adaptations
    assert r.inc.diameter(exact=True) == jr.inc.diameter(exact=True)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trace_json_byte_identical(name):
    for n0, seed in ((18, 0), (40, 3), (97, 11)):
        got = SCENARIOS[name](n0=n0, seed=seed)
        want = jdyn.SCENARIOS[name](n0=n0, seed=seed)
        assert got.to_json() == want.to_json()
        assert Trace.from_json(want.to_json()).to_json() == want.to_json()
        if name != "cluster_split_merge":
            assert np.array_equal(got.latency(), want.latency())


@pytest.mark.parametrize("route_policy", ["latency", "ring"])
def test_route_probe_replay_equals_reference(route_policy):
    """``route_probe > 0``: every probed sample's stretch, and the run's
    mean, equal the reference's (the probe's live-block APSP and its
    routed pairs are bitwise the reference's)."""
    trace = SCENARIOS["flash_crowd"](n0=12, seed=0)
    jtrace = jdyn.SCENARIOS["flash_crowd"](n0=12, seed=0)
    res = ChurnEngine(trace, POLICIES["rapid"](), seed=0, route_probe=2,
                      route_policy=route_policy).run()
    jres = jdyn.ChurnEngine(jtrace, jdyn.POLICIES["rapid"](), seed=0,
                            route_probe=2, route_policy=route_policy).run()
    got = np.array([s.stretch for s in res.samples])
    assert np.isfinite(got).sum() >= 4
    assert np.array_equal(got, [s.stretch for s in jres.samples],
                          equal_nan=True)
    assert res.mean_stretch == jres.mean_stretch
    eng = ChurnEngine(trace, POLICIES["rapid"](), seed=0)
    jeng = jdyn.ChurnEngine(jtrace, jdyn.POLICIES["rapid"](), seed=0)
    assert eng.probe_stretch(policy=route_policy) == \
        jeng.probe_stretch(policy=route_policy)
    off = ChurnEngine(trace, POLICIES["rapid"](), seed=0).run()
    assert np.isnan(off.mean_stretch)


def test_churn_entry_points_raise_without_cuda(monkeypatch):
    """No CUDA device and no request for the CPU: the port's device error,
    never a fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w, adj, alive = _fresh_state(8, 10, 0)
    trace = SCENARIOS["flash_crowd"](n0=8, seed=0)
    monkeypatch.setattr(batcheval._ctx, "stack", [])   # leave the fixture's
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IncrementalDistances(w, adj, alive)
    for P in POLICIES.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ChurnEngine(trace, P(), seed=0)
