"""The port's hierarchical overlays (``repro_torch.hier``) against
``repro.hier`` on the CPU.

* The cases of ``tests/test_hier.py`` hold on the port (all but the
  slow-marked N=10^5 smoke, which ``chip_smoke.py`` phase (h) runs on the
  card).
* Clustering, heads, every cluster's rings and the head overlay are equal
  to the reference's at N in {200, 1000}, dense and synthetic-geo; the
  schema-2 ``to_json`` is byte-identical and round-trips through
  ``from_topology_json``; ``diameter_bound`` ("exact", "ecc") and
  ``distance_bound_pairs`` are equal; ``subset`` matches.
* ``route_pairs_hier`` / ``route_single_hier`` equal the reference's.
* ``HierChurnEngine`` against the reference event by event, through
  splits and merges: every cluster's maintained distances and the head
  graph's bitwise, stats, heads and routes equal; ``restore`` too.

Tolerance: exact everywhere (JSON byte-identical).
"""
import json

import numpy as np
import pytest
import torch

from repro import hier as jhier
from repro import overlay as jov
from repro.dynamics import scenarios as jscen
from repro_torch import overlay
from repro_torch.core import batcheval
from repro_torch.core.topology import make_latency
from repro_torch.dynamics.scenarios import (SCENARIOS, Event, Trace,
                                            cluster_split_merge,
                                            regional_failure)
from repro_torch.hier import (DenseLatency, HierChurnEngine, HierConfig,
                              HierarchicalOverlay, SubsetLatency,
                              assign_latency_clusters, build_hier,
                              default_cluster_size, latency_from_spec,
                              route_pairs_hier, route_single_hier,
                              synthetic_geo)
from repro_torch.overlay import Overlay, Topology, from_topology_json

N = 96


@pytest.fixture(autouse=True)
def _on_cpu():
    with batcheval.eval_options(device="cpu"):
        yield


def _hier(n=N, seed=0, dist="bitnode", **cfg):
    w = make_latency(dist, n, seed=seed + 2)
    return w, build_hier(DenseLatency(w),
                         HierConfig(**cfg) if cfg else None, seed=seed)


def _pair(n, seed, dist, kind, **cfg):
    """The same hierarchy built by both packages."""
    if kind == "dense":
        w = make_latency(dist, n, seed=seed + 2)
        lat, jlat = DenseLatency(w), jhier.DenseLatency(w)
    else:
        lat, jlat = synthetic_geo(n, seed=seed), jhier.synthetic_geo(n,
                                                                     seed=seed)
    port = build_hier(lat, HierConfig(**cfg) if cfg else None, seed=seed)
    ref = jhier.build_hier(jlat, jhier.HierConfig(**cfg) if cfg else None,
                           seed=seed)
    return port, ref


def _same_hier(port, ref):
    assert np.array_equal(port.assignment, ref.assignment)
    assert np.array_equal(port.heads, ref.heads)
    assert port.n_clusters == ref.n_clusters
    for a, b in zip(port.clusters, ref.clusters):
        assert len(a.rings) == len(b.rings)
        for ra, rb in zip(a.rings, b.rings):
            assert np.array_equal(ra, rb)
        assert np.array_equal(a.w, b.w)
    for ra, rb in zip(port.head_overlay.rings, ref.head_overlay.rings):
        assert np.array_equal(ra, rb)
    assert np.array_equal(port.head_overlay.adjacency,
                          ref.head_overlay.adjacency)
    assert np.array_equal(port.edge_list(), ref.edge_list())
    assert port.to_json() == ref.to_json()


# ---------------------------------------------------------------------------
# the cases of tests/test_hier.py, on the port
# ---------------------------------------------------------------------------

def test_both_implementations_satisfy_topology_protocol():
    w, hov = _hier()
    flat = overlay.build("dgro", w, seed=1)
    assert isinstance(flat, Topology)
    assert isinstance(hov, Topology)
    assert overlay.get_builder("dgro").kind == "flat"
    assert overlay.get_builder("dgro-hier").kind == "hier"
    assert "dgro-hier" in overlay.builders()


def test_registry_builds_hier_from_dense_matrix():
    w = make_latency("uniform", N, seed=4)
    hov = overlay.build("dgro-hier", w, seed=1)
    assert isinstance(hov, HierarchicalOverlay)
    assert hov.n == N and hov.n_clusters >= 2
    e = hov.edge_list()
    assert e.ndim == 2 and e.shape[1] == 2
    assert np.all(e[:, 0] < e[:, 1])                   # unique, u < v
    assert np.array_equal(e, np.unique(np.sort(e, axis=1), axis=0))
    assert hov.to_json() == jov.build("dgro-hier", w, seed=1).to_json()


def test_hier_bounds_match_materialized_exact_apsp():
    _, hov = _hier()
    mat = hov.materialize()
    apsp = np.asarray(mat.distances(), np.float64)
    rng = np.random.default_rng(7)
    us = rng.integers(0, N, size=128)
    vs = rng.integers(0, N, size=128)
    served, stamp = hov.distance_bound_pairs(us, vs)
    assert stamp == "exact"
    np.testing.assert_allclose(served, apsp[us, vs], rtol=1e-4, atol=1e-3)
    d, ds = hov.diameter_bound("exact")
    assert ds == "exact"
    assert d == pytest.approx(float(mat.diameter()), rel=1e-4)
    ub, us_ = hov.diameter_bound("ecc")
    assert us_ == "upper"
    assert ub >= d - 1e-3                              # never an underestimate
    with pytest.raises(ValueError):
        hov.diameter_bound("nope")


def test_hier_diameter_within_1_5x_flat_dgro():
    n = 256
    w = make_latency("bitnode", n, seed=2)
    flat_d = float(overlay.build("dgro", w, seed=0).diameter())
    hov = build_hier(DenseLatency(w), HierConfig(k_local=12), seed=0)
    hd, stamp = hov.diameter_bound("exact")
    assert stamp == "exact"
    assert hd <= 1.5 * flat_d


def test_subset_survives_head_death():
    _, hov = _hier()
    alive = np.ones(N, bool)
    alive[int(hov.heads[0])] = False                   # kill a gateway
    alive[:5] = False
    sub = hov.subset(alive)
    assert sub.n == int(alive.sum())
    assert isinstance(sub, HierarchicalOverlay)
    mat = sub.materialize()
    d, ds = sub.diameter_bound("exact")
    assert ds == "exact"
    assert d == pytest.approx(float(mat.diameter()), rel=1e-4)


def test_hier_serde_schema2_round_trip():
    _, hov = _hier()
    s = hov.to_json()
    assert json.loads(s)["schema"] == 2
    rt = HierarchicalOverlay.from_json(s)
    assert rt.equals(hov)
    assert rt.to_json() == s                           # byte-identical
    with pytest.raises(ValueError):
        Overlay.from_json(s)
    via = from_topology_json(s)
    assert isinstance(via, HierarchicalOverlay) and via.equals(hov)


def test_flat_serde_stays_schema1_byte_identical():
    w = make_latency("uniform", 48, seed=3)
    ov = overlay.build("dgro", w, seed=1)
    s = ov.to_json()
    assert json.loads(s).get("schema", 1) == 1
    rt = Overlay.from_json(s)
    assert rt.to_json() == s
    assert float(rt.diameter()) == float(ov.diameter())
    via = from_topology_json(s)
    assert isinstance(via, Overlay)
    assert via.to_json() == s


def test_trace_json_round_trips_cluster_events():
    trace = cluster_split_merge(n0=48, seed=5)
    rt = Trace.from_json(trace.to_json())
    assert rt.to_json() == trace.to_json()
    kinds = [e.kind for e in rt.events]
    assert "cluster_split" in kinds and "cluster_merge" in kinds
    merge = next(e for e in rt.events if e.kind == "cluster_merge")
    assert merge.peer >= 0 and merge.peer != merge.node
    node_ev = Event(time=1.0, kind="join", node=3)
    assert "peer" not in node_ev.to_dict()


def test_engine_cluster_split_and_merge():
    trace = cluster_split_merge(n0=N, seed=3)
    eng = HierChurnEngine(trace, seed=0)
    res = eng.run()
    assert res.policy == "dgro-hier"
    assert eng.reorg_stats["splits"] >= 1
    assert eng.reorg_stats["merges"] >= 1
    assert np.isfinite(res.final_diameter) and res.final_diameter > 0
    assert eng.events_processed == len(trace.events)
    with pytest.raises(RuntimeError):
        eng.run()                                      # one-shot replay
    want = jhier.HierChurnEngine(jscen.cluster_split_merge(n0=N, seed=3),
                                 seed=0).run()
    assert res.final_diameter == want.final_diameter
    assert res.stats == want.stats
    assert [(s.time, s.event, s.n_live, s.diameter) for s in res.samples] \
        == [(s.time, s.event, s.n_live, s.diameter) for s in want.samples]


def test_engine_regional_failure_diameter_is_valid_lower_bound():
    trace = regional_failure(n0=51, seed=2)
    eng = HierChurnEngine(trace, seed=0)
    for e in sorted(trace.events, key=lambda e: e.time):
        eng.process(e)
    d_maint = eng.diameter()
    d_exact = eng.diameter(exact=True)
    assert d_maint <= d_exact + 1e-3
    assert np.isfinite(d_exact) and d_exact > 0
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    edges, wts = eng.weighted_edges()
    cap = eng.capacity
    m = np.zeros((cap, cap))
    m[edges[:, 0], edges[:, 1]] = wts
    m[edges[:, 1], edges[:, 0]] = wts
    live = eng.live_ids()
    full = dijkstra(csr_matrix(m), directed=False, indices=live)[:, live]
    assert d_exact == pytest.approx(float(full[np.isfinite(full)].max()),
                                    rel=1e-4)


def test_engine_per_node_bounds_and_routing_after_churn():
    trace = cluster_split_merge(n0=N, seed=1)
    eng = HierChurnEngine(trace, seed=0)
    for e in sorted(trace.events, key=lambda e: e.time):
        eng.process(e)
    eng.refresh()
    live = eng.live_ids()
    src, dst = int(live[0]), int(live[-1])
    d, stamp = eng.distance_bound(src, dst)
    assert stamp == "exact" and np.isfinite(d)
    path, lat, levels, outcome = eng.route(src, dst)
    assert outcome == "delivered"
    assert path[0] == src and path[-1] == dst
    assert lat == pytest.approx(d, rel=1e-4)
    assert levels["local"] + levels["head"] == len(path) - 1


def test_engine_rejects_stale_events():
    trace = cluster_split_merge(n0=48, seed=4)
    eng = HierChurnEngine(trace, seed=0)
    eng.process(Event(time=10.0, kind="join", node=48))
    with pytest.raises(ValueError):
        eng.process(Event(time=5.0, kind="leave", node=0))


def test_service_hier_fresh_ingest_route_snapshot_restore(tmp_path):
    from repro_torch.service.state import ServiceState

    world = Trace(n0=64, capacity=80, dist="bitnode", seed=3, events=[],
                  name="svc-hier")
    st = ServiceState.fresh(world, policy="dgro-hier",
                            snapshot_dir=str(tmp_path))
    stats = st.stats()
    assert stats["policy"] == "dgro-hier"
    assert stats["clusters"] >= 2
    res = st.ingest([
        Event(time=1.0, kind="join", node=64),
        Event(time=2.0, kind="leave", node=1),
        Event(time=3.0, kind="cluster_split", node=0),
        Event(time=4.0, kind="cluster_merge", node=1, peer=2),
    ])
    assert res["applied"] == 4, res
    live = np.asarray(st.adjacency()["nodes"])
    r = st.route(int(live[0]), int(live[-1]))
    assert r["reachable"] and r["hops"] >= 1
    assert r["hops_by_level"]["local"] + r["hops_by_level"]["head"] == \
        r["hops"]
    assert r["stretch"] >= 1 - 1e-5

    path = st.write_snapshot()
    assert path is not None
    raw = json.loads(open(f"{path}/state.json").read())
    assert raw["schema"] == 2
    assert raw["kind"] == "service_snapshot_hier"

    d0 = st.diameter(exact=True)["diameter"]
    rt = ServiceState.restore(str(tmp_path))
    assert rt.stats()["clusters"] == st.stats()["clusters"]
    assert rt.stats()["n_live"] == st.stats()["n_live"]
    assert rt.diameter(exact=True)["diameter"] == pytest.approx(d0, rel=1e-5)
    a0 = st.adjacency()
    a1 = rt.adjacency()
    assert a0["nodes"] == a1["nodes"]
    assert sorted(map(tuple, a0["edges"])) == sorted(map(tuple, a1["edges"]))


def test_hier_gauges_track_engine_state():
    from repro_torch.obs import HIER_CLUSTERS

    HIER_CLUSTERS.set_function(None)
    trace = cluster_split_merge(n0=48, seed=6)
    eng = HierChurnEngine(trace, seed=0)
    assert HIER_CLUSTERS.value == eng.n_clusters > 0


# ---------------------------------------------------------------------------
# bitwise parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "synthetic"])
@pytest.mark.parametrize("n", [200, 1000])
def test_build_hier_equals_reference(n, kind):
    """Clustering, heads, every cluster's ring permutations and the head
    overlay: the same, and the schema-2 JSON byte for byte."""
    port, ref = _pair(n, 1, "bitnode", kind)
    _same_hier(port, ref)
    via = from_topology_json(ref.to_json())
    assert isinstance(via, HierarchicalOverlay) and via.equals(port)
    assert via.to_json() == ref.to_json()
    back = jhier.HierarchicalOverlay.from_json(port.to_json())
    assert back.to_json() == ref.to_json()


@pytest.mark.parametrize("kind", ["dense", "synthetic"])
def test_clustering_equals_reference(kind):
    n = 1000
    lat = DenseLatency(make_latency("fabric", n, seed=4)) \
        if kind == "dense" else synthetic_geo(n, seed=4)
    jlat = jhier.DenseLatency(lat.w) if kind == "dense" \
        else jhier.synthetic_geo(n, seed=4)
    for target in (default_cluster_size(n), 16, 50):
        got = assign_latency_clusters(lat, target, np.random.default_rng(3))
        want = jhier.assign_latency_clusters(jlat, target,
                                             np.random.default_rng(3))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert default_cluster_size(n) == jhier.default_cluster_size(n)


@pytest.mark.parametrize("n", [200, 1000])
def test_latency_models_equal_reference(n):
    geo, jgeo = synthetic_geo(n, sites=16, seed=2), \
        jhier.synthetic_geo(n, sites=16, seed=2)
    rows, cols = np.arange(0, n, 7), np.arange(3, n, 5)
    assert np.array_equal(geo.block(rows, cols), jgeo.block(rows, cols))
    assert np.array_equal(geo.pairs(rows, rows[::-1]),
                          jgeo.pairs(rows, rows[::-1]))
    sub = SubsetLatency(geo, rows)
    assert np.array_equal(sub.dense(),
                          jhier.SubsetLatency(jgeo, rows).dense())
    assert json.dumps(sub.to_spec()) == json.dumps(
        jhier.SubsetLatency(jgeo, rows).to_spec())
    back = latency_from_spec(sub.to_spec())
    assert np.array_equal(back.dense(), sub.dense())


@pytest.mark.parametrize("kind", ["dense", "synthetic"])
def test_bounds_equal_reference(kind):
    port, ref = _pair(200, 3, "fabric", kind)
    for method in ("exact", "ecc"):
        assert port.diameter_bound(method) == ref.diameter_bound(method)
    rng = np.random.default_rng(1)
    us, vs = rng.integers(0, 200, 300), rng.integers(0, 200, 300)
    got, stamp = port.distance_bound_pairs(us, vs)
    want, jstamp = ref.distance_bound_pairs(us, vs)
    assert stamp == jstamp == "exact" and np.array_equal(got, want)
    for u, v in zip(us[:20], vs[:20]):
        assert port.distance_bound(u, v) == ref.distance_bound(u, v)
    if kind == "dense":
        assert np.array_equal(port.materialize().distances(),
                              np.asarray(ref.materialize().distances()))


def test_subset_equals_reference():
    port, ref = _pair(200, 0, "bitnode", "dense")
    alive = np.ones(200, bool)
    alive[port.heads[:3]] = False
    alive[port.members[1]] = False                     # drain a cluster
    alive[::11] = False
    got, want = port.subset(alive), ref.subset(alive)
    _same_hier(got, want)
    assert got.diameter_bound("exact") == want.diameter_bound("exact")


@pytest.mark.parametrize("policy", ["latency", "ring"])
def test_hier_routing_equals_reference(policy):
    port, ref = _pair(200, 2, "bitnode", "dense")
    rng = np.random.default_rng(5)
    pairs = np.stack([rng.integers(0, 200, 256), rng.integers(0, 200, 256)],
                     axis=1)
    for budget in (None, 2):
        got = route_pairs_hier(port, pairs, policy=policy, hop_budget=budget)
        want = jhier.route_pairs_hier(ref, pairs, policy=policy,
                                      hop_budget=budget)
        for f in ("hops", "hops_local", "hops_head", "latency", "success",
                  "failed", "optimum", "stretch"):
            g, w = getattr(got, f), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, f
            assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), f
    for s, d in pairs[:24]:
        assert route_single_hier(port, s, d, policy=policy) == \
            jhier.route_single_hier(ref, s, d, policy=policy)


def _same_engine(eng, ref, tag):
    assert sorted(eng.states) == sorted(ref.states), tag
    for c, s in eng.states.items():
        r = ref.states[c]
        assert np.array_equal(s.slots, r.slots) and s.head == r.head, tag
        assert np.array_equal(s.inc._dist.numpy(),
                              np.asarray(r.inc.distances)), (tag, c)
        assert np.array_equal(s.inc.adj, np.asarray(r.inc.adj)), (tag, c)
        assert np.array_equal(s.inc.alive, np.asarray(r.inc.alive)), tag
    assert np.array_equal(eng.head_inc._dist.numpy(),
                          np.asarray(ref.head_inc.distances)), tag
    assert np.array_equal(eng.head_inc.adj, np.asarray(ref.head_inc.adj))
    assert eng.stats() == ref.stats(), tag
    assert eng.diameter() == ref.diameter(), tag
    assert eng.pending_deletions == ref.pending_deletions, tag


def _events(trace, extra=()):
    return sorted(list(trace.events) + list(extra), key=lambda e: e.time)


@pytest.mark.parametrize("scenario", ["cluster_split_merge", "poisson_churn",
                                      "regional_failure", "diurnal_drift",
                                      "straggler_storm"])
def test_engine_event_by_event_equals_reference(scenario):
    kw = dict(n0=96, seed=3)
    trace = SCENARIOS[scenario](**kw)
    jtrace = jscen.SCENARIOS[scenario](**kw)
    assert trace.to_json() == jtrace.to_json()
    t_end = max((e.time for e in trace.events), default=0.0)
    # node-level traces get one split and one merge after their events
    reorg = [] if scenario == "cluster_split_merge" else [
        Event(time=t_end + 1.0, kind="cluster_split", node=0),
        Event(time=t_end + 2.0, kind="cluster_merge", node=1, peer=2)]
    eng = HierChurnEngine(trace, seed=0, rebuild_threshold=3)
    ref = jhier.HierChurnEngine(jtrace, seed=0, rebuild_threshold=3)
    _same_engine(eng, ref, "boot")
    for i, e in enumerate(_events(trace, reorg)):
        eng.process(e)
        ref.process(jscen.Event.from_dict(e.to_dict()))
        _same_engine(eng, ref, f"event {i} {e.kind}")
    assert eng.reorg_stats == ref.reorg_stats
    assert eng.reorg_stats["splits"] + eng.reorg_stats["merges"] >= 1
    live = eng.live_ids()
    assert np.array_equal(live, ref.live_ids())
    for s, d in zip(live[:6], live[::-1][:6]):
        assert eng.distance_bound(s, d) == ref.distance_bound(s, d)
        assert eng.route(s, d) == ref.route(s, d)
    assert np.array_equal(eng.edge_list(), ref.edge_list())
    e1, w1 = eng.weighted_edges()
    e2, w2 = ref.weighted_edges()
    assert np.array_equal(e1, e2) and np.array_equal(w1, w2)
    assert eng.diameter(exact=True) == ref.diameter(exact=True)


def test_engine_restore_equals_reference():
    trace = cluster_split_merge(n0=96, seed=2)
    jtrace = jscen.cluster_split_merge(n0=96, seed=2)
    eng = HierChurnEngine(trace, seed=0)
    for e in _events(trace):
        eng.process(e)
    snap = dict(slot_cluster=eng._slot_cluster, alive=eng.alive,
                edges=eng.edge_list(),
                heads={c: s.head for c, s in eng.states.items()},
                latency_factor=eng.latency_factor,
                drift_scale=eng.drift_scale, clock=eng.clock,
                events_processed=eng.events_processed)
    got = HierChurnEngine.restore(trace, **snap)
    want = jhier.HierChurnEngine.restore(jtrace, **snap)
    _same_engine(got, want, "restored")
    t = got.clock
    for i, u in enumerate(got.live_ids()[:4]):
        e = Event(time=t + 1.0 + i, kind="leave", node=int(u))
        got.process(e)
        want.process(jscen.Event.from_dict(e.to_dict()))
        _same_engine(got, want, f"after restore, leave {i}")


def test_hier_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(batcheval._ctx, "stack", [])   # leave the fixture's
    w = make_latency("uniform", 48, seed=0)
    for call in (lambda: build_hier(DenseLatency(w)),
                 lambda: overlay.build("dgro-hier", w),
                 lambda: HierChurnEngine(cluster_split_merge(n0=48, seed=0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
