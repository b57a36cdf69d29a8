"""The port's greedy router (``repro_torch.routing``) against
``repro.routing`` on the CPU.

* The cases of ``tests/test_routing.py`` hold on the port.
* ``route_pairs`` is bitwise the reference's (JAX on the CPU) and the
  port's own numpy ``route_pairs_host`` on hops, latency, success, failed,
  optimum and stretch: both policies, all three workloads, N in {16, 64,
  256}, on dgro, chord and random overlays; a stale lower-bound ``D`` from
  an engine with pending deletions; small hop budgets (exhausted pairs),
  dead ends, ``src == dst`` and equal-weight ties.
* ``ChurnEngine.probe_stretch`` and ``route_probe > 0`` replays equal the
  reference's sample for sample.
* ``record_route`` / ``record_route_batch`` render the metrics text
  byte-identically.

Tolerance: exact everywhere.  The port's distances come from the plain
Floyd-Warshall here, the CPU method of both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import overlay as jov
from repro import routing as jr
from repro.dynamics import ChurnEngine as JChurnEngine
from repro.dynamics import POLICIES as JPOLICIES
from repro.dynamics import scenarios as jscen
from repro.obs import metrics as jmetrics
from repro.routing import metrics as jrmetrics
from repro_torch import overlay, routing
from repro_torch.core import batcheval
from repro_torch.core.diameter import INF, adjacency_from_edges, ring_edges
from repro_torch.core.topology import (DISTRIBUTIONS, N_FABRIC_SITES,
                                       make_latency)
from repro_torch.dynamics import POLICIES as DYN_POLICIES
from repro_torch.dynamics import ChurnEngine
from repro_torch.dynamics.scenarios import poisson_churn
from repro_torch.obs import REGISTRY, parse_prometheus
from repro_torch.obs import metrics as tmetrics
from repro_torch.routing import metrics as trmetrics

N = 16
FIELDS = ("hops", "latency", "success", "failed", "optimum")

# overrides that keep every builder cheap enough for a 4-distribution sweep
FAST_CFG = {
    "ga": dict(k_rings=2, population=8, budget=32),
    "parallel": dict(m=2, extra_random=0),
    "dgro-dqn": dict(k=2, epochs=0, n_starts=2),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with batcheval.eval_options(device="cpu"):
        yield


def _build(name, w, seed=0):
    return overlay.build(name, w, seed=seed, **FAST_CFG.get(name, {}))


def _chord_fabric(n, seed=0, dist="bitnode"):
    ov = overlay.build("chord", make_latency(dist, n, seed=seed), seed=seed)
    return (np.asarray(ov.adjacency, np.float32),
            np.asarray(ov.distances(), np.float32), np.asarray(ov.rings[0]))


def _same(got, want, what=""):
    """Every field of two RouteResults bitwise equal (NaN stretch too)."""
    assert np.array_equal(got.pairs, np.asarray(want.pairs)), what
    for f in FIELDS + ("stretch",):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, (what, f, g.dtype, w.dtype)
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), (what, f)


def _three_ways(adj, dist, pairs, what, **kw):
    """The port's router against the reference's and the port's host
    loop, all on the same numpy inputs."""
    got = routing.route_pairs(adj, dist, pairs, **kw)
    _same(got, jr.route_pairs(adj, dist, pairs, **kw), f"{what} vs jax")
    _same(got, routing.route_pairs_host(adj, dist, pairs, **kw),
          f"{what} vs host")
    return got


# ---------------------------------------------------------------------------
# the cases of tests/test_routing.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_every_builder_routes_every_pair(dist):
    w = make_latency(dist, N, seed=3)
    pairs = routing.sample_pairs(N, 64, "uniform", seed=5)
    for name in sorted(overlay.builders()):
        if overlay.get_builder(name).kind != "flat":
            continue        # hier builders route via repro_torch.hier.routing
        ov = _build(name, w, seed=1)
        assert ov.is_connected(), (name, dist)
        for policy in routing.POLICIES:
            res = routing.route_overlay(ov, pairs, policy=policy)
            assert res.success.all(), (name, dist, policy)
            assert not res.failed.any(), (name, dist, policy)
            assert np.all(res.stretch >= 1 - 1e-4), (name, dist, policy)
            if policy == "latency":
                assert np.all(res.stretch <= 1 + 1e-3), (name, dist)


def test_batched_router_matches_host_reference():
    adj, dist, ring = _chord_fabric(24)
    pairs = routing.sample_pairs(24, 128, "uniform", seed=1)
    for policy in routing.POLICIES:
        _three_ways(adj, dist, pairs, policy, policy=policy, ring=ring)


def test_masked_termination_respects_hop_budget():
    n = 16
    perm = np.arange(n)
    adj = adjacency_from_edges(make_latency("uniform", n, seed=0),
                               ring_edges(perm))
    pairs = np.array([[0, 8]])
    full = routing.route_pairs(adj, None, pairs, policy="ring", ring=perm,
                               hop_budget=8)
    assert full.success.all() and full.hops[0] == 8
    cut = routing.route_pairs(adj, None, pairs, policy="ring", ring=perm,
                              hop_budget=7)
    assert not cut.success[0] and not cut.failed[0]
    assert cut.hops[0] == 7 and cut.outcome(0) == "exhausted"
    keys = routing.ring_distance_keys(perm, pairs[:, 1])
    path, _, hops, outcome = routing.route_single_host(
        adj, keys[0], 0, 8, policy="ring", hop_budget=7)
    assert outcome == "exhausted" and hops == 7 and len(path) == 8
    for budget in (7, 8):
        _three_ways(adj, None, pairs, f"budget {budget}", policy="ring",
                    ring=perm, hop_budget=budget)


def test_disconnected_cross_pairs_dead_end():
    n = 12
    w = make_latency("uniform", n, seed=2)
    edges = list(ring_edges(np.arange(6))) + list(ring_edges(np.arange(6, n)))
    adj = np.asarray(adjacency_from_edges(w, edges), np.float32)
    dist = overlay.Overlay.from_adjacency(w, adj).distances()
    assert dist[0, 9] >= float(INF) / 2          # really partitioned
    pairs = np.array([[0, 9], [1, 4]])
    res = _three_ways(adj, dist, pairs, "partitioned", policy="latency")
    assert not res.success[0] and res.failed[0]
    assert res.outcome(0) == "dead_end" and res.hops[0] == 0
    assert np.isnan(res.stretch[0])
    assert res.success[1]
    s = routing.summarize(res, builder="two-rings", workload="uniform",
                          policy="latency", n=n, hop_budget=n)
    assert s.success_rate == 1.0                 # 1 delivered / 1 reachable
    js = jr.summarize(jr.route_pairs(adj, dist, pairs, policy="latency"),
                      builder="two-rings", workload="uniform",
                      policy="latency", n=n, hop_budget=n)
    assert s.to_json() == js.to_json()


def test_sample_pairs_deterministic_distinct_in_range():
    for kind in routing.WORKLOADS:
        a = routing.sample_pairs(40, 200, kind, seed=7)
        assert np.array_equal(a, routing.sample_pairs(40, 200, kind, seed=7))
        assert not np.array_equal(a, routing.sample_pairs(40, 200, kind,
                                                          seed=8))
        assert a.shape == (200, 2)
        assert (a[:, 0] != a[:, 1]).all(), kind
        assert a.min() >= 0 and a.max() < 40
    with pytest.raises(ValueError, match="unknown workload"):
        routing.sample_pairs(40, 10, "nope")
    with pytest.raises(ValueError, match=">= 2 nodes"):
        routing.sample_pairs(1, 10)


@pytest.mark.parametrize("kind", ["uniform", "hotspot", "regional"])
@pytest.mark.parametrize("n", [16, 64, 256])
def test_sample_pairs_equal_reference(kind, n):
    assert routing.WORKLOADS == jr.WORKLOADS
    for seed in (0, 3):
        got = routing.sample_pairs(n, 300, kind, seed=seed)
        want = jr.sample_pairs(n, 300, kind, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_hotspot_concentrates_and_regional_localizes():
    hot = routing.sample_pairs(64, 600, "hotspot", seed=0)
    _, counts = np.unique(hot[:, 1], return_counts=True)
    assert np.sort(counts)[-4:].sum() / 600 >= 0.6   # frac=0.8 on 4 hotspots
    same_site = lambda p: float(  # noqa: E731
        ((p[:, 0] % N_FABRIC_SITES) == (p[:, 1] % N_FABRIC_SITES)).mean())
    reg = same_site(routing.sample_pairs(64, 600, "regional", seed=0))
    uni = same_site(routing.sample_pairs(64, 600, "uniform", seed=0))
    assert reg >= 0.6 and reg > uni + 0.2            # locality=0.8 vs 1/sites


def test_routing_summary_serde_roundtrip():
    adj, dist, ring = _chord_fabric(12)
    pairs = routing.sample_pairs(12, 32, "hotspot", seed=1)
    res = routing.route_pairs(adj, dist, pairs, policy="latency", ring=ring)
    s = routing.summarize(res, builder="chord", workload="hotspot",
                          policy="latency", n=12, hop_budget=12)
    assert s.success_rate == 1.0 and s.stretch_mean >= 1 - 1e-4
    assert routing.RoutingSummary.from_json(s.to_json()) == s
    with pytest.raises(ValueError, match="routing_summary"):
        routing.RoutingSummary.from_json(
            s.to_json().replace("routing_summary", "other_kind"))
    js = jr.summarize(jr.route_pairs(adj, dist, pairs, policy="latency",
                                     ring=ring),
                      builder="chord", workload="hotspot", policy="latency",
                      n=12, hop_budget=12)
    assert s.to_json() == js.to_json()


def test_route_instruments_land_in_the_scrape():
    def scrape():
        return parse_prometheus(REGISTRY.render_prometheus())

    adj, dist, ring = _chord_fabric(12)
    res = routing.route_pairs(adj, dist,
                              routing.sample_pairs(12, 16, "uniform", seed=2),
                              policy="ring", ring=ring)
    assert res.success.all()
    before = scrape()
    routing.record_route_batch("ring", res)
    routing.record_route("latency", "unreachable")
    after = scrape()
    delivered = (("outcome", "delivered"), ("policy", "ring"))
    unreachable = (("outcome", "unreachable"), ("policy", "latency"))
    reqs0 = before.get("repro_route_requests_total", {})
    reqs1 = after["repro_route_requests_total"]
    assert reqs1[delivered] - reqs0.get(delivered, 0) == res.n_pairs
    assert reqs1[unreachable] - reqs0.get(unreachable, 0) == 1
    hops0 = before.get("repro_route_hops_count", {}).get((), 0)
    assert after["repro_route_hops_count"][()] - hops0 == res.n_pairs


def test_churn_probe_stretch_stays_finite_under_poisson():
    trace = poisson_churn(n0=16, dist="uniform", seed=0, horizon=10_000.0,
                          join_rate=1e-3, leave_rate=1e-3, min_live=8)
    eng = ChurnEngine(trace, DYN_POLICIES["dgro"](), seed=1,
                      detect_failures=True, route_probe=2, route_pairs=16)
    res = eng.run()
    probed = [s.stretch for s in res.samples if np.isfinite(s.stretch)]
    assert probed, "probe recorded no finite stretch samples"
    assert all(v >= 1 - 1e-4 for v in probed)
    assert np.isfinite(res.mean_stretch) and res.mean_stretch >= 1 - 1e-4
    res_off = ChurnEngine(trace, DYN_POLICIES["dgro"](), seed=1,
                          detect_failures=True).run()
    assert all(not np.isfinite(s.stretch) for s in res_off.samples)
    assert not np.isfinite(res_off.mean_stretch)


def test_unknown_builder_message_is_sorted_and_comma_joined():
    with pytest.raises(ValueError) as exc:
        overlay.build("does-not-exist", make_latency("uniform", 8, seed=0))
    assert ", ".join(sorted(overlay.builders())) in str(exc.value)


def test_service_route_response_carries_routing_fields():
    from repro_torch.dynamics import Trace
    from repro_torch.service.state import ServiceState

    world = Trace(n0=12, capacity=24, dist="bitnode", seed=3, events=[],
                  name="routing-test-world")
    state = ServiceState.fresh(world, policy="dgro", seed=0)
    r = state.route(0, 7)
    assert r["reachable"] and r["bound"] == "exact"
    assert r["path"] is not None and r["hops"] == len(r["path"]) - 1
    assert r["stretch"] == pytest.approx(1.0, rel=1e-3)   # exact matrix
    assert r["hop_bounds"] == ["exact"] * r["hops"]


# ---------------------------------------------------------------------------
# bitwise parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("builder", ["dgro", "chord", "random"])
@pytest.mark.parametrize("n", [16, 64, 256])
def test_route_pairs_bitwise_reference_and_host(n, builder):
    """Both policies, all three workloads: the port's router, the JAX
    package's scan and the host loop agree on every field."""
    w = make_latency("bitnode", n, seed=n)
    ov = jov.build(builder, w, seed=1)
    adj = np.asarray(ov.adjacency, np.float32)
    dist = np.asarray(ov.distances(), np.float32)
    ring = np.asarray(ov.rings[0])
    assert np.array_equal(overlay.Overlay.from_json(ov.to_json())
                          .distances(), dist)
    for kind in routing.WORKLOADS:
        pairs = routing.sample_pairs(n, 4 * n, kind, seed=n + 1)
        for policy in routing.POLICIES:
            res = _three_ways(adj, dist, pairs, (builder, kind, policy),
                              policy=policy, ring=ring)
            assert res.success.all(), (builder, kind, policy)


def test_route_overlay_bitwise_reference():
    w = make_latency("fabric", 64, seed=5)
    jo = jov.build("kleinberg", w, seed=2)
    to = overlay.Overlay.from_json(jo.to_json())
    pairs = routing.sample_pairs(64, 256, "hotspot", seed=4)
    for policy in routing.POLICIES:
        _same(routing.route_overlay(to, pairs, policy=policy),
              jr.route_overlay(jo, pairs, policy=policy), policy)


def test_stale_lower_bound_distances_bitwise():
    """A ``D`` read from an engine with pending deletions: a lower bound
    the latency descent can wander on, dead-end or exhaust its budget
    against.  The port routes it exactly as the reference does."""
    trace = poisson_churn(n0=48, dist="bitnode", seed=2, horizon=20_000.0,
                          join_rate=0.3e-3, leave_rate=1.5e-3, min_live=24)
    eng = ChurnEngine(trace, DYN_POLICIES["rapid"](), seed=0,
                      rebuild_threshold=64)
    for e in sorted(trace.events, key=lambda e: e.time):
        eng.process(e)
    assert eng.inc.pending_deletions > 0
    live = eng.live_ids()
    adj = eng.inc.adj[np.ix_(live, live)]
    stale = eng.inc.distances[np.ix_(live, live)]
    exact = overlay.Overlay.from_adjacency(eng.w[np.ix_(live, live)], adj,
                                           fold_weights=True).distances()
    assert (stale <= exact).all() and (stale < exact).any()
    m = len(live)
    pairs = routing.sample_pairs(m, 512, "uniform", seed=9)
    for budget in (None, 3):
        _three_ways(adj, stale, pairs, f"stale, budget {budget}",
                    policy="latency", hop_budget=budget)


@pytest.mark.parametrize("policy", ["ring", "latency"])
def test_small_budgets_dead_ends_and_self_pairs_bitwise(policy):
    n = 64
    adj, dist, ring = _chord_fabric(n, seed=4, dist="fabric")
    pairs = np.concatenate([routing.sample_pairs(n, 200, "uniform", seed=1),
                            np.array([[5, 5], [0, 0], [63, 63]])])
    for budget in (0, 1, 2, 3, 5, 9):
        res = _three_ways(adj, dist, pairs, f"budget {budget}",
                          policy=policy, ring=ring, hop_budget=budget)
        assert res.success[-3:].all() and (res.hops[-3:] == 0).all()
        assert (res.stretch[-3:] == 1.0).all()
        assert (res.hops <= budget).all()
        if budget in (1, 2):
            assert (~res.success & ~res.failed).any()     # exhausted pairs
    # dead ends: a partitioned overlay (latency) and a ring that does not
    # match the overlay's (ring greedy finds no strictly closer neighbour)
    w = make_latency("uniform", n, seed=1)
    half = n // 2
    part = adjacency_from_edges(w, np.concatenate(
        [ring_edges(np.arange(half)), ring_edges(np.arange(half, n))]))
    pdist = overlay.Overlay.from_adjacency(w, part).distances()
    shuffled = np.random.default_rng(0).permutation(n)
    pairs = routing.sample_pairs(n, 256, "uniform", seed=2)
    res = _three_ways(part, pdist, pairs, "dead ends", policy=policy,
                      ring=shuffled)
    assert res.failed.any()


@pytest.mark.parametrize("policy", ["ring", "latency"])
def test_equal_weight_ties_break_to_the_first_minimum(policy):
    """Every link weighs the same: many neighbours tie on the score, and
    the router must take the lowest-numbered one, as the reference's
    argmin does."""
    n = 64
    w = np.full((n, n), 7.0, np.float32)
    np.fill_diagonal(w, 0.0)
    jo = jov.build("chord", w, seed=0)
    adj = np.asarray(jo.adjacency, np.float32)
    dist = np.asarray(jo.distances(), np.float32)
    ring = np.asarray(jo.rings[0])
    pairs = routing.sample_pairs(n, 1024, "uniform", seed=3)
    scores = adj[pairs[:, 0]] + dist[:, pairs[:, 1]].T
    best = np.where((adj[pairs[:, 0]] > 0) & (adj[pairs[:, 0]] < INF / 2),
                    scores, np.inf)
    assert ((best == best.min(axis=1, keepdims=True)).sum(axis=1) > 1).any()
    _three_ways(adj, dist, pairs, "ties", policy=policy, ring=ring)


def test_route_pairs_reads_a_distance_tensor_in_place():
    adj, dist, ring = _chord_fabric(32)
    pairs = routing.sample_pairs(32, 128, "regional", seed=0)
    for policy in routing.POLICIES:
        _same(routing.route_pairs(adj, torch.from_numpy(dist), pairs,
                                  policy=policy, ring=ring),
              routing.route_pairs_host(adj, dist, pairs, policy=policy,
                                       ring=ring), policy)


def test_route_pairs_rejects_what_the_reference_rejects():
    adj, dist, ring = _chord_fabric(12)
    pairs = np.array([[0, 3]])
    for kw, msg in ((dict(policy="latency"), "distance matrix"),
                    (dict(policy="ring"), "base ring"),
                    (dict(policy="nope", ring=ring), "unknown routing")):
        for fn in (routing.route_pairs, jr.route_pairs):
            d = None if kw["policy"] != "nope" else dist
            with pytest.raises(ValueError, match=msg):
                fn(adj, d, pairs, **kw)


def test_route_pairs_raises_without_cuda(monkeypatch):
    adj, dist, _ = _chord_fabric(12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(batcheval._ctx, "stack", [])   # leave the fixture's
    with pytest.raises(RuntimeError, match="device='cpu'"):
        routing.route_pairs(adj, dist, np.array([[0, 3]]))


# ---------------------------------------------------------------------------
# the churn engine's probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route_policy", ["latency", "ring"])
@pytest.mark.parametrize("policy", ["dgro", "rapid", "chord"])
def test_probe_stretch_equals_reference(policy, route_policy):
    kw = dict(n0=16, dist="uniform", seed=0, horizon=10_000.0,
              join_rate=1e-3, leave_rate=1e-3, min_live=8)
    got = ChurnEngine(poisson_churn(**kw), DYN_POLICIES[policy](), seed=1,
                      detect_failures=True, route_probe=2, route_pairs=16,
                      route_policy=route_policy).run()
    want = JChurnEngine(jscen.poisson_churn(**kw), JPOLICIES[policy](),
                        seed=1, detect_failures=True, route_probe=2,
                        route_pairs=16, route_policy=route_policy).run()
    a = np.array([dataclasses.astuple(s)[2:] for s in got.samples])
    b = np.array([dataclasses.astuple(s)[2:] for s in want.samples])
    assert np.isfinite(a[:, 2]).sum() >= 4
    assert np.array_equal(a, b, equal_nan=True)
    assert [(s.time, s.event) for s in got.samples] == \
        [(s.time, s.event) for s in want.samples]
    assert got.mean_stretch == want.mean_stretch or (
        np.isnan(got.mean_stretch) and np.isnan(want.mean_stretch))


def test_probe_stretch_direct_call_equals_reference():
    got = ChurnEngine(poisson_churn(n0=20, seed=1), DYN_POLICIES["rapid"](),
                      seed=0)
    want = JChurnEngine(jscen.poisson_churn(n0=20, seed=1),
                        JPOLICIES["rapid"](), seed=0)
    for n_pairs, policy in ((32, "latency"), (32, "ring"), (1, "latency"),
                            (0, "latency")):
        a = got.probe_stretch(n_pairs, policy)
        b = want.probe_stretch(n_pairs, policy)
        assert a == b or (np.isnan(a) and np.isnan(b)), (n_pairs, policy)


# ---------------------------------------------------------------------------
# the routing instruments, byte for byte
# ---------------------------------------------------------------------------

def test_record_route_metrics_text_byte_identical(monkeypatch):
    """The same recordings into fresh registries of both packages render
    the same Prometheus text and JSON."""
    fresh = {}
    for pkg, mmod, rmod in (("port", tmetrics, trmetrics),
                            ("ref", jmetrics, jrmetrics)):
        reg = mmod.MetricsRegistry()
        monkeypatch.setattr(rmod, "ROUTE_HOPS", reg.histogram(
            "repro_route_hops", "hop count per delivered greedy route",
            buckets=rmod.HOP_BUCKETS))
        monkeypatch.setattr(rmod, "ROUTE_REQUESTS", reg.counter(
            "repro_route_requests_total",
            "greedy route requests, by next-hop policy and outcome",
            labels=("policy", "outcome")))
        fresh[pkg] = reg
    assert trmetrics.HOP_BUCKETS == jrmetrics.HOP_BUCKETS
    adj, dist, ring = _chord_fabric(48, seed=2)
    pairs = routing.sample_pairs(48, 200, "hotspot", seed=6)
    for policy, budget in (("ring", 3), ("latency", None)):
        res = routing.route_pairs(adj, dist, pairs, policy=policy,
                                  ring=ring, hop_budget=budget)
        jres = jr.route_pairs(adj, dist, pairs, policy=policy, ring=ring,
                              hop_budget=budget)
        routing.record_route_batch(policy, res)
        jr.record_route_batch(policy, jres)
    for args in (("latency", "unreachable"), ("ring", "delivered", 5),
                 ("latency", "dead_end", None)):
        routing.record_route(*args)
        jr.record_route(*args)
    text = fresh["port"].render_prometheus()
    assert "repro_route_hops_bucket" in text
    assert text == fresh["ref"].render_prometheus()
    assert fresh["port"].render_json() == fresh["ref"].render_json()
