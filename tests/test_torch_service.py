"""The port's control plane (``repro_torch.service``) against
``repro.service`` on the CPU.

* The cases of ``tests/test_service.py`` hold on the port, with the state
  made on the CPU and an in-process server at port 0 (the real daemon, a
  subprocess, runs with ``--device cpu``).
* Snapshot payloads are equal to the reference's, byte for byte as JSON
  (all but the wall-clock stamp), for the same events, flat and hier;
  ``route`` answers are equal.
* The HTTP handler threads and the re-optimizer's thread run on the CPU
  when the state was made with the CPU: ``eval_options`` is thread-local,
  and the state carries its device to every call it serves.
* Every server stop and thread join has its own timeout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from conftest import subproc_env
from repro import serde as jserde
from repro.dynamics import scenarios as jscen
from repro.service import state as jstate
from repro_torch import overlay, serde
from repro_torch.core import batcheval
from repro_torch.core.diameter import INF
from repro_torch.core.topology import make_latency
from repro_torch.dynamics.engine import ChurnEngine, DGROPolicy
from repro_torch.dynamics.scenarios import (Event, Trace, churn_with_drift,
                                            merge_traces, poisson_churn)
from repro_torch.service import (Reoptimizer, ServiceClient, ServiceError,
                                 ServiceServer, ServiceState,
                                 latest_snapshot, list_snapshots,
                                 write_snapshot)

N0 = 24
JOIN_S = 60.0          # every join / stop in this file waits at most this


@pytest.fixture(autouse=True)
def _on_cpu():
    with batcheval.eval_options(device="cpu"):
        yield


def _world(n0=N0, capacity=None, dist="bitnode", seed=3) -> Trace:
    return Trace(n0=n0, capacity=capacity or 2 * n0, dist=dist, seed=seed,
                 events=[], name="test-world")


def _trace(n0=N0, seed=3, events=30) -> Trace:
    tr = poisson_churn(n0=n0, dist="bitnode", seed=seed, horizon=30_000.0,
                       join_rate=events / 2 / 30_000.0,
                       leave_rate=events / 2 / 30_000.0)
    return Trace(n0=tr.n0, capacity=tr.capacity, dist=tr.dist, seed=tr.seed,
                 events=sorted(tr.events, key=lambda e: e.time)[:events],
                 name=tr.name)


def _stop(server) -> None:
    """Stop an in-process server and check its thread really ended."""
    server.stop(final_snapshot=False)
    if server._thread is not None:
        server._thread.join(JOIN_S)
        assert not server._thread.is_alive(), "server thread did not stop"


# ---------------------------------------------------------------------------
# the cases of tests/test_service.py, on the port
# ---------------------------------------------------------------------------

def test_serde_stamps_and_roundtrips():
    s = serde.dumps({"x": 1})
    d = json.loads(s)
    assert d["schema"] == serde.SCHEMA_VERSION
    assert serde.loads(s, what="t")["x"] == 1
    assert serde.loads('{"x": 2}', what="t")["x"] == 2
    future = json.dumps({"schema": serde.MAX_SCHEMA + 1})
    with pytest.raises(serde.SchemaError, match="only understands"):
        serde.loads(future, what="t")
    with pytest.raises(serde.SchemaError):
        serde.loads('{"schema": "banana"}', what="t")
    with pytest.raises(serde.SchemaError, match="JSON object"):
        serde.loads("[1, 2]", what="t")


def test_overlay_and_trace_json_carry_schema():
    w = make_latency("uniform", 12, seed=0)
    ov = overlay.build("chord", w, rng=np.random.default_rng(0))
    assert json.loads(ov.to_json())["schema"] == serde.SCHEMA_VERSION
    rt = overlay.Overlay.from_json(ov.to_json())
    assert np.array_equal(rt.adjacency, ov.adjacency)
    tr = _trace(events=6)
    assert json.loads(tr.to_json())["schema"] == serde.SCHEMA_VERSION
    assert Trace.from_json(tr.to_json()).events == tr.events
    future = dict(json.loads(tr.to_json()), schema=serde.MAX_SCHEMA + 1)
    with pytest.raises(serde.SchemaError):
        Trace.from_json(json.dumps(future))


def test_merged_churn_drift_scenario():
    tr = churn_with_drift(n0=16, seed=1, drift_steps=4)
    kinds = {e.kind for e in tr.events}
    assert "latency_drift" in kinds and {"join", "leave"} & kinds
    times = [e.time for e in tr.events]
    assert times == sorted(times)
    with pytest.raises(ValueError, match="latency world"):
        merge_traces(poisson_churn(n0=16, seed=1),
                     poisson_churn(n0=16, seed=2))


def test_engine_process_matches_run_replay():
    tr = _trace(events=24)
    replayed = ChurnEngine(tr, DGROPolicy(), seed=5)
    replayed.run(record=False)
    live_world = Trace(n0=tr.n0, capacity=tr.capacity, dist=tr.dist,
                       seed=tr.seed, events=[], name=tr.name)
    live = ChurnEngine(live_world, DGROPolicy(), seed=5)
    for e in sorted(tr.events, key=lambda t: t.time):
        live.process(e)
    live.flush()
    assert np.array_equal(live.alive, replayed.alive)
    assert np.array_equal(live.inc.adj, replayed.inc.adj)
    assert live.events_processed == replayed.events_processed
    assert live.inc.diameter(exact=True) == replayed.inc.diameter(exact=True)


def test_engine_process_rejects_time_travel():
    eng = ChurnEngine(_world(), DGROPolicy(), seed=0)
    eng.process(Event(time=100.0, kind="leave", node=0))
    with pytest.raises(ValueError, match="clock"):
        eng.process(Event(time=50.0, kind="leave", node=1))


def test_state_ingest_and_query_surface():
    state = ServiceState.fresh(_world(), policy="dgro", seed=0)
    assert state.device == torch.device("cpu")
    tr = _trace(events=16)
    res = state.ingest(sorted(tr.events, key=lambda e: e.time))
    assert res["accepted"] == 16 and res["applied"] >= 16
    st = state.stats()
    assert st["events_ingested"] == 16
    assert st["distances_are"] in ("exact", "lower-bound")
    adj = state.adjacency()
    assert adj["n_live"] == st["n_live"] == len(adj["nodes"])
    src, dst = adj["nodes"][0], adj["nodes"][-1]
    r = state.route(src, dst)
    assert r["reachable"] and r["distance"] > 0
    if r["path"] is not None:
        assert r["path"][0] == src and r["path"][-1] == dst
    with pytest.raises(ValueError, match="not a live node"):
        dead = next(u for u in range(state.engine.inc.capacity)
                    if u not in set(adj["nodes"]))
        state.route(src, dead)


def test_served_distances_are_lower_bounds_while_stale():
    state = ServiceState.fresh(_world(n0=20), policy="dgro",
                               rebuild_threshold=64, seed=0)
    inc = state.engine.inc
    live0 = list(inc.live_ids())
    t = 0.0
    for u in live0[::3]:
        t += 10.0
        state.ingest([Event(time=t, kind="leave", node=int(u))])
    assert inc.pending_deletions > 0
    assert state.stats()["distances_are"] == "lower-bound"
    assert state.diameter()["exact"] is False
    live = inc.live_ids()
    served = inc.distances[np.ix_(live, live)].copy()
    served_routes = {(int(a), int(b)): state.route(int(a), int(b))
                     for a in live[:4] for b in live[-4:] if a != b}
    inc.refresh()
    exact = inc.distances[np.ix_(live, live)]
    assert (served <= exact + 1e-4).all(), "stale distance overestimated"
    for (a, b), r in served_routes.items():
        assert r["bound"] == "lower"
        truth = float(inc.distances[a, b])
        if r["distance"] is not None and truth < float(INF) / 2:
            assert r["distance"] <= truth + 1e-4
    assert state.stats()["distances_are"] == "exact"


def test_snapshot_protocol_ignores_uncommitted(tmp_path):
    d = str(tmp_path)
    write_snapshot(d, 1, {"kind": "t", "x": 1})
    write_snapshot(d, 2, {"kind": "t", "x": 2})
    (tmp_path / "snap-000005").mkdir()
    (tmp_path / "snap-000005" / "state.json").write_text("{}")
    assert list_snapshots(d) == [1, 2]
    seq, payload = latest_snapshot(d)
    assert seq == 2 and payload["x"] == 2


def test_snapshot_restore_roundtrip(tmp_path):
    state = ServiceState.fresh(_world(), policy="dgro",
                               snapshot_dir=str(tmp_path), seed=0)
    tr = _trace(events=12)
    state.ingest(sorted(tr.events, key=lambda e: e.time))
    state.write_snapshot(reason="test")
    _, payload = latest_snapshot(str(tmp_path))
    assert payload["schema"] == serde.SCHEMA_VERSION
    restored = ServiceState.restore(str(tmp_path))
    assert restored.events_ingested == state.events_ingested
    assert restored.diameter(exact=True)["diameter"] == payload["diameter"]
    assert restored.stats()["n_live"] == state.stats()["n_live"]
    restored.ingest([Event(time=state.engine.clock + 1.0, kind="leave",
                           node=int(restored.engine.inc.live_ids()[0]))])


class _Boom(RuntimeError):
    pass


def test_crash_between_swap_and_snapshot_restores_preswap(tmp_path):
    state = ServiceState.fresh(_world(n0=20, dist="gaussian"),
                               policy="rapid", snapshot_dir=str(tmp_path),
                               seed=0)
    state.write_snapshot(reason="baseline")
    pre_seq, pre = latest_snapshot(str(tmp_path))
    pre_version = state.version

    def boom():
        raise _Boom()

    reopt = Reoptimizer(state, every=2**31, eps=0.49, seed=0,
                        crash_hook=boom)
    crashed = False
    for _ in range(5):
        try:
            reopt.step(force=True)
        except _Boom:
            crashed = True
            break
    assert crashed, "re-optimizer never swapped; cannot exercise the window"
    assert state.version == pre_version + 1
    seq, payload = latest_snapshot(str(tmp_path))
    assert seq == pre_seq, "snapshot leaked out of the crash window"
    assert payload["version"] == pre_version
    restored = ServiceState.restore(str(tmp_path))
    assert restored.version == pre_version
    assert restored.diameter(exact=True)["diameter"] == pre["diameter"]


def test_reopt_commit_swaps_atomically_and_improves():
    state = ServiceState.fresh(_world(n0=20, dist="gaussian"),
                               policy="rapid", seed=0)
    d0 = state.diameter(exact=True)["diameter"]
    reopt = Reoptimizer(state, every=2**31, eps=0.49, seed=0)
    swapped = None
    for _ in range(5):
        swapped = reopt.step(force=True)
        if swapped:
            break
    assert swapped and swapped["edges_added"] > 0
    assert state.version >= 1
    assert state.diameter(exact=True)["diameter"] <= d0 + 1e-5


def test_http_server_endpoints_and_versioning():
    state = ServiceState.fresh(_world(), policy="dgro", seed=0)
    server = ServiceServer(state, reopt_enabled=False).start()
    try:
        c = ServiceClient(server.url)
        h = c.wait_ready(timeout=30)
        assert h["api_versions"] == ["v1"]
        tr = _trace(events=10)
        res = c.post_events(sorted(tr.events, key=lambda e: e.time))
        assert res["accepted"] == 10
        assert c.stats()["events_ingested"] == 10
        nodes = c.adjacency()["nodes"]
        assert c.route(nodes[0], nodes[-1])["reachable"]
        with pytest.raises(ServiceError) as ei:
            c._request("GET", "/v9/stats")
        assert ei.value.status == 404 and "v1" in str(ei.value)
        with pytest.raises(ServiceError) as ei:
            c.route(-1, 10**6)
        assert ei.value.status == 400
        with pytest.raises(ServiceError) as ei:
            c.post_events([Event(time=0.0, kind="leave", node=nodes[0])])
        assert ei.value.status == 409
        assert c.stats()["events_ingested"] == 10
        ov = c.overlay()
        assert len(ov["live"]) == len(nodes)
        assert c.diameter(exact=True)["exact"]
    finally:
        _stop(server)


def test_http_queries_survive_inflight_reopt():
    state = ServiceState.fresh(_world(n0=20, dist="gaussian"),
                               policy="rapid", seed=0)
    server = ServiceServer(state, reopt_enabled=False).start()
    try:
        c = ServiceClient(server.url)
        c.wait_ready(timeout=30)
        reopt = Reoptimizer(state, every=2**31, eps=0.49, seed=0)
        worker = threading.Thread(target=reopt.step, kwargs={"force": True})
        worker.start()
        answered = 0
        while worker.is_alive():
            assert c.stats()["n_live"] == 20
            answered += 1
        worker.join(JOIN_S)
        assert not worker.is_alive()
        assert answered > 0, "reopt finished before any query landed"
        assert c.health()["status"] == "ok"
    finally:
        _stop(server)


def test_daemon_crash_env_and_restart_consistency(tmp_path):
    snapdir = str(tmp_path)
    base_cmd = [sys.executable, "-m", "repro_torch.service", "--n0", "20",
                "--dist", "gaussian", "--policy", "rapid", "--port", "0",
                "--snapshot-dir", snapdir, "--reopt-eps", "0.49",
                "--reopt-every", "1000000", "--snapshot-every", "1000000",
                "--device", "cpu"]

    def boot(extra_env):
        proc = subprocess.Popen(base_cmd, stdout=subprocess.PIPE, text=True,
                                env=subproc_env(**extra_env), cwd=".")
        line = proc.stdout.readline().strip()
        assert line.startswith("SERVING "), line
        port = dict(kv.split("=") for kv in line.split()[1:])["port"]
        client = ServiceClient(f"http://127.0.0.1:{port}")
        client.wait_ready(timeout=60)
        return proc, client

    proc, client = boot({"REPRO_SERVICE_CRASH_AFTER_SWAP": "1"})
    try:
        client.snapshot()
        pre_seq, pre = latest_snapshot(snapdir)
        for _ in range(8):                    # "keep" cycles swap nothing
            client.reoptimize()
            try:
                rc = proc.wait(timeout=20)
                break
            except subprocess.TimeoutExpired:
                continue
        else:
            rc = None
        assert rc == 17, f"daemon exited {rc}, expected the injected crash"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=JOIN_S)
            pytest.fail("daemon did not crash on the injected window")
    seq, payload = latest_snapshot(snapdir)
    assert seq == pre_seq and payload["version"] == pre["version"]

    proc, client = boot({})
    try:
        d = client.diameter(exact=True)
        assert d["diameter"] == pre["diameter"]
        assert client.stats()["version"] == pre["version"]
        client.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=JOIN_S)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _payload_json(payload, dumps) -> str:
    return dumps({k: v for k, v in payload.items() if k != "wall_time"})


@pytest.mark.parametrize("policy", ["dgro", "rapid", "chord", "perigee",
                                    "dgro-hier"])
def test_snapshot_payload_json_equals_reference(policy):
    """The same world and events through both packages' ServiceState:
    the snapshot payloads serialize to the same bytes, and the routes
    served in between are the same answers."""
    n0 = 40 if policy == "dgro-hier" else N0
    world, jworld = _world(n0=n0), jscen.Trace(
        n0=n0, capacity=2 * n0, dist="bitnode", seed=3, events=[],
        name="test-world")
    state = ServiceState.fresh(world, policy=policy, seed=0,
                               rebuild_threshold=3)
    ref = jstate.ServiceState.fresh(jworld, policy=policy, seed=0,
                                    rebuild_threshold=3)
    events = sorted(_trace(n0=n0, events=24).events, key=lambda e: e.time)
    if policy == "dgro-hier":
        t = events[-1].time
        events += [Event(time=t + 1.0, kind="cluster_split", node=0),
                   Event(time=t + 2.0, kind="cluster_merge", node=1, peer=2)]
    for i in range(0, len(events), 6):
        chunk = events[i:i + 6]
        got = state.ingest(chunk)
        want = ref.ingest([jscen.Event.from_dict(e.to_dict())
                           for e in chunk])
        assert got == want
        live = state.adjacency()["nodes"]
        assert live == ref.adjacency()["nodes"]
        for a, b in ((live[0], live[-1]), (live[1], live[len(live) // 2])):
            assert state.route(a, b) == ref.route(a, b)
        assert state.diameter() == ref.diameter()
    assert state.adjacency() == ref.adjacency()
    assert _payload_json(state.snapshot_payload(), serde.dumps) == \
        _payload_json(ref.snapshot_payload(), jserde.dumps)


def test_reopt_cycle_and_snapshot_equal_reference(tmp_path):
    state = ServiceState.fresh(_world(n0=20, dist="gaussian"),
                               policy="rapid", seed=0,
                               snapshot_dir=str(tmp_path / "port"))
    ref = jstate.ServiceState.fresh(
        jscen.Trace(n0=20, capacity=40, dist="gaussian", seed=3, events=[],
                    name="test-world"),
        policy="rapid", seed=0, snapshot_dir=str(tmp_path / "ref"))
    from repro.service import Reoptimizer as JReoptimizer
    got = Reoptimizer(state, every=2**31, eps=0.49, seed=0)
    want = JReoptimizer(ref, every=2**31, eps=0.49, seed=0)
    for _ in range(3):
        assert got.step(force=True) == want.step(force=True)
    assert state.version == ref.version
    _, a = latest_snapshot(str(tmp_path / "port"))
    from repro.service import latest_snapshot as jlatest
    _, b = jlatest(str(tmp_path / "ref"))
    assert _payload_json(a, serde.dumps) == _payload_json(b, jserde.dumps)


# ---------------------------------------------------------------------------
# the state's device reaches every thread that serves it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["dgro", "dgro-hier"])
def test_handler_and_reoptimizer_threads_run_on_the_state_device(
        monkeypatch, policy):
    """The state is made on the CPU (the fixture's ``eval_options``, a
    thread-local).  Every device resolution from the HTTP handler threads
    and from the re-optimizer's thread must give the CPU; without the
    state's own device they would resolve CUDA and raise here."""
    seen = []
    real = batcheval.eval_device

    def spy(device=None):
        d = real(device)
        seen.append((threading.current_thread().name, d.type))
        return d

    monkeypatch.setattr(batcheval, "eval_device", spy)
    n0 = 40 if policy == "dgro-hier" else N0
    state = ServiceState.fresh(_world(n0=n0, dist="gaussian"), policy=policy,
                               seed=0, rebuild_threshold=2)
    server = ServiceServer(state, reopt_every=2**31, reopt_eps=0.49,
                           snapshot_every=2**31).start()
    main = threading.current_thread().name
    try:
        c = ServiceClient(server.url)
        c.wait_ready(timeout=30)
        events = sorted(_trace(n0=n0, events=12).events,
                        key=lambda e: e.time)
        for i in range(0, len(events), 3):
            c.post_events(events[i:i + 3])          # leaves force rebuilds
        assert c.diameter(exact=True)["exact"]
        for _ in range(3):
            c.reoptimize()
        deadline = time.monotonic() + JOIN_S
        while (state.reopts_completed + state.reopts_kept < 3
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert state.reopts_completed + state.reopts_kept >= 3
        assert server.reopt.last_error is None, server.reopt.last_error
    finally:
        _stop(server)
        assert not server.reopt._thread.is_alive()
    others = {name for name, _ in seen if name != main}
    assert "repro-reoptimizer" in others
    assert any(name != "repro-reoptimizer" for name in others)
    assert {dev for _, dev in seen} == {"cpu"}, seen


def test_reoptimizer_eval_opts_keep_the_state_device(monkeypatch):
    """A caller's scoring knobs cannot move a cycle off the state's
    device: ``eval_opts={"device": "cuda"}`` over a CPU state still scores
    on the CPU (here, with no CUDA, the cycle would raise otherwise)."""
    seen = []
    real = batcheval.eval_device

    def spy(device=None):
        d = real(device)
        seen.append(d.type)
        return d

    monkeypatch.setattr(batcheval, "eval_device", spy)
    state = ServiceState.fresh(_world(n0=20, dist="gaussian"),
                               policy="rapid", seed=0)
    seen.clear()
    reopt = Reoptimizer(state, every=2**31, eps=0.49, seed=0,
                        eval_opts={"device": "cuda"})
    reopt.step(force=True)
    assert state.reopts_completed + state.reopts_kept == 1
    assert seen and set(seen) == {"cpu"}, seen


def test_state_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(batcheval._ctx, "stack", [])   # leave the fixture's
    for policy in ("dgro", "dgro-hier"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServiceState.fresh(_world(), policy=policy)
        state = ServiceState.fresh(_world(), policy=policy, device="cpu")
        assert state.device == torch.device("cpu")
        state.ingest([Event(time=1.0, kind="leave", node=0)])
        assert state.diameter(exact=True)["exact"]
