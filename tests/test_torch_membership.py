"""The port's membership plane (``repro_torch.membership``) against
``repro.membership`` on the CPU: SWIM detection, push dissemination, the
confirmation time the churn engine schedules, straggler detection and
rescale plans give equal results for the same seeds -- and the cases of
``tests/test_membership.py`` hold on the port."""
import dataclasses

import numpy as np
import pytest

from repro.dynamics import ChurnEngine as JEngine
from repro.dynamics import DGROPolicy as JDGRO
from repro.dynamics import Event as JEvent
from repro.dynamics import Trace as JTrace
from repro.membership import elastic as jel
from repro.membership import gossip as jgo
from repro_torch.core import batcheval
from repro_torch.core.construction import nearest_ring, random_ring
from repro_torch.core.diameter import adjacency_from_rings, diameter_scipy
from repro_torch.core.topology import make_latency
from repro_torch.dynamics import ChurnEngine, DGROPolicy, Event, Trace
from repro_torch.membership import elastic, gossip
from repro_torch.membership.elastic import (HostState, detect_stragglers,
                                            plan_rescale)
from repro_torch.membership.gossip import (SwimConfig, disseminate,
                                           simulate_failure_detection)


@pytest.fixture(autouse=True)
def _on_cpu():
    with batcheval.eval_options(device="cpu"):
        yield


def _overlays(n=60, seed=1):
    w = make_latency("bitnode", n, seed=seed)
    rng = np.random.default_rng(0)
    low = adjacency_from_rings(w, [nearest_ring(w, 0), random_ring(rng, n)])
    high = adjacency_from_rings(w, [random_ring(rng, n)])
    return w, low, high


# ---------------------------------------------------------------------------
# the cases of tests/test_membership.py, on the port
# ---------------------------------------------------------------------------

def test_dissemination_latency_tracks_diameter():
    w, low, high = _overlays()
    d_low, d_high = diameter_scipy(low), diameter_scipy(high)
    assert d_low < d_high
    t_low = np.mean([disseminate(low, w, s, seed=s)[0] for s in range(8)])
    t_high = np.mean([disseminate(high, w, s, seed=s)[0] for s in range(8)])
    assert t_low < t_high * 1.05, (t_low, t_high)


def test_dissemination_reaches_everyone():
    w, low, _ = _overlays(n=40)
    t, recv = disseminate(low, w, 0, coverage=1.0)
    assert np.isfinite(recv).all()
    assert t == pytest.approx(np.max(recv))


def test_failure_detection_ordering():
    w, low, _ = _overlays(n=40)
    det = simulate_failure_detection(low, w, failed=5, cfg=SwimConfig())
    assert 0 < det.t_first_suspect < det.t_confirmed < det.t_all_know


def test_straggler_detection():
    hosts = [HostState(i, ewma_ms=1.0) for i in range(10)]
    hosts[4].ewma_ms = 100.0
    assert detect_stragglers(hosts, factor=3.0) == [4]


def test_plan_rescale_excludes_dead_and_stragglers():
    w = make_latency("fabric", 16, seed=2)
    hosts = [HostState(i) for i in range(16)]
    hosts[3].alive = False
    hosts[7].ewma_ms = 1000.0
    plan = plan_rescale(w, hosts, model_hosts=2, old_world=16)
    assert 3 not in plan.hosts and 7 not in plan.hosts
    pods, data, model = plan.mesh_shape
    assert pods * data * model == len(plan.hosts)
    assert model == 2
    assert plan.expected_step_time_factor >= 1.0
    assert set(plan.shard_remap) == set(range(16))


# ---------------------------------------------------------------------------
# equal to the reference for the same seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(24, 0), (60, 1), (97, 5)])
@pytest.mark.parametrize("coverage", [0.5, 0.99, 1.0])
def test_disseminate_equals_reference(n, seed, coverage):
    w, low, high = _overlays(n=n, seed=seed)
    for adj in (low, high):
        for source in (0, n // 3, n - 1):
            for fanout in (0, 2, 5):
                got = disseminate(adj, w, source, fanout=fanout, seed=seed,
                                  coverage=coverage, proc_delay=0.5)
                want = jgo.disseminate(adj, w, source, fanout=fanout,
                                       seed=seed, coverage=coverage,
                                       proc_delay=0.5)
                assert got[0] == want[0]
                assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_failure_detection_and_confirmation_equal_reference(seed):
    w, low, high = _overlays(n=50, seed=seed)
    cfg = SwimConfig(probe_period=80.0, probe_timeout=20.0,
                     suspect_timeout=150.0)
    jcfg = jgo.SwimConfig(**dataclasses.asdict(cfg))
    for adj in (low, high):
        for failed in (0, 7, 49):
            got = simulate_failure_detection(adj, w, failed, cfg, seed=seed)
            want = jgo.simulate_failure_detection(adj, w, failed, jcfg,
                                                  seed=seed)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for t_fail in (0.0, 1234.5):
                assert gossip.confirmed_leave_time(
                    adj, failed, t_fail, cfg, seed) == \
                    jgo.confirmed_leave_time(adj, failed, t_fail, jcfg, seed)
    # an isolated node falls back to its successor as the sole prober
    iso = low.copy()
    iso[4, :] = iso[:, 4] = 1e9
    iso[4, 4] = 0.0
    assert gossip.confirmed_leave_time(iso, 4, seed=seed) == \
        jgo.confirmed_leave_time(iso, 4, seed=seed)


def test_neighbours_and_stragglers_equal_reference():
    _, low, _ = _overlays(n=30)
    for u in range(30):
        assert np.array_equal(gossip.neighbours(low, u),
                              jgo.neighbours(low, u))
    rng = np.random.default_rng(4)
    ewma = rng.gamma(2.0, 2.0, size=40)
    alive = rng.random(40) > 0.2
    for factor in (1.5, 3.0, 6.0):
        hosts = [HostState(i, bool(a), float(e))
                 for i, (a, e) in enumerate(zip(alive, ewma))]
        jhosts = [jel.HostState(i, bool(a), float(e))
                  for i, (a, e) in enumerate(zip(alive, ewma))]
        assert detect_stragglers(hosts, factor) == \
            jel.detect_stragglers(jhosts, factor)
    h, jh = HostState(0), jel.HostState(0)
    for s in (3.0, 0.5, 12.0):
        elastic.update_ewma(h, s)
        jel.update_ewma(jh, s)
    assert h.ewma_ms == jh.ewma_ms


@pytest.mark.parametrize("dist,n,model_hosts,seed", [
    ("fabric", 16, 2, 0), ("bitnode", 37, 1, 1), ("uniform", 24, 3, 2),
    ("gaussian", 30, 4, 3)])
def test_plan_rescale_equals_reference(dist, n, model_hosts, seed):
    w = make_latency(dist, n, seed=seed)
    rng = np.random.default_rng(seed)
    dead = rng.choice(n, size=3, replace=False)
    slow = int(rng.integers(n))
    hosts = [HostState(i) for i in range(n)]
    jhosts = [jel.HostState(i) for i in range(n)]
    for hs in (hosts, jhosts):
        for d in dead:
            hs[int(d)].alive = False
        hs[slow].ewma_ms = 50.0
    for old in (None, n):
        got = plan_rescale(w, hosts, model_hosts=model_hosts, old_world=old,
                           seed=seed)
        want = jel.plan_rescale(w, jhosts, model_hosts=model_hosts,
                                old_world=old, seed=seed)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_plan_rescale_from_engine_equals_reference():
    def trace(ev, tr):
        return tr(n0=24, capacity=24, dist="fabric", seed=3, name="rescale",
                  events=[ev(time=1_000.0, kind="fail", node=5),
                          ev(time=3_000.0, kind="straggler", node=11,
                             factor=25.0)])

    eng = ChurnEngine(trace(Event, Trace), DGROPolicy(), seed=0,
                      detect_failures=True)
    eng.run()
    jeng = JEngine(trace(JEvent, JTrace), JDGRO(), seed=0,
                   detect_failures=True)
    jeng.run()
    for kw in ({}, {"model_hosts": 2, "old_world": 24},
               {"straggler_factor": 10.0, "seed": 4}):
        got = elastic.plan_rescale_from_engine(eng, **kw)
        want = jel.plan_rescale_from_engine(jeng, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert 5 not in got.hosts and 11 not in got.hosts
    assert [dataclasses.astuple(h) for h in eng.host_states()] == \
        [dataclasses.astuple(h) for h in jeng.host_states()]
