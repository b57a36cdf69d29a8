"""Smoke of the port's control-plane daemon: boot, stream churn, shut down.

The port's version of ``tools/service_smoke.py``.  Starts
``python -m repro_torch.service`` as a real subprocess on ``--device``,
streams a poisson-churn trace through
:class:`repro_torch.service.ServiceClient`, asserts every query endpoint
answers sensibly, forces a re-optimization and waits for it to finish
(no cycle may end in ``outcome="error"``, and at least one must keep or
swap), takes a snapshot, scrapes ``GET /v1/metrics`` and checks the
counters match what was streamed (a fresh process, so absolute values are
exact), times ``ROUTE_QUERIES`` ``GET /v1/route`` round trips between live
nodes, and checks the daemon exits cleanly on ``POST /v1/shutdown``.

    PYTHONPATH=src python tools/torch_service_smoke.py --device cpu \\
        --n0 32 --events 50                      # a dry run on the CPU
    python tools/torch_service_smoke.py --n0 1024 --events 200
    python tools/torch_service_smoke.py --policy dgro-hier --n0 10000 \\
        --events 200

With ``--policy dgro-hier`` the daemon serves a hierarchical overlay: the
same endpoint contract is asserted, plus the hier gauges
(``repro_hier_clusters``, ``repro_hier_headring_diameter``) and the
per-level ``repro_hier_route_hops`` histogram must appear in the scrape.
The last line of standard output is one JSON object with the run's
numbers (boot, ingest and route-query times on the host's clock).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

from repro_torch.dynamics.scenarios import poisson_churn  # noqa: E402
from repro_torch.service import ServiceClient  # noqa: E402

ROUTE_QUERIES = 64      # timed GET /v1/route round trips


def reopt_cycles(scraped: dict) -> dict:
    """``repro_reopt_cycles_total`` of a scrape, by outcome."""
    return {k[0][1]: v for k, v in scraped.get(
        "repro_reopt_cycles_total", {}).items()}


def check_reopt(cycles: dict) -> None:
    """The daemon's reoptimizer catches a failed cycle and keeps serving,
    so a failure shows only in the counters: none may have failed."""
    assert "error" not in cycles, f"a reopt cycle failed: {cycles}"
    assert cycles.get("kept", 0) + cycles.get("swapped", 0) >= 1, cycles


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=50)
    ap.add_argument("--n0", type=int, default=32)
    ap.add_argument("--dist", default="bitnode")
    ap.add_argument("--policy", default="dgro", choices=("dgro", "dgro-hier"),
                    help="overlay policy the daemon serves")
    ap.add_argument("--device", default="cuda",
                    help="the daemon's device (cuda or cpu)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    hier = args.policy == "dgro-hier"

    # a trace with the requested number of events: the rates scale with the
    # count, with a 1.25x margin so the Poisson draw does not fall short
    rate = 1.25 * args.events / 2 / 30_000.0
    trace = poisson_churn(n0=args.n0, dist=args.dist, seed=1,
                          horizon=30_000.0, join_rate=rate, leave_rate=rate)
    events = sorted(trace.events, key=lambda e: e.time)[:args.events]
    assert len(events) == args.events, (
        f"trace only produced {len(events)} events")

    snapdir = tempfile.mkdtemp(prefix="dgro-torch-service-smoke-")
    t_boot = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service",
         "--n0", str(args.n0), "--capacity", str(trace.capacity),
         "--dist", args.dist, "--policy", args.policy,
         "--device", args.device, "--port", "0", "--snapshot-dir", snapdir,
         "--reopt-every", "16", "--snapshot-every", "25"],
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.path.abspath(SRC)})
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("SERVING "), f"unexpected boot line: {line!r}"
        port = dict(kv.split("=") for kv in line.split()[1:])["port"]
        c = ServiceClient(f"http://127.0.0.1:{port}", timeout=args.timeout)

        health = c.wait_ready(timeout=args.timeout)
        boot_s = time.perf_counter() - t_boot
        assert health["status"] == "ok" and "v1" in health["api_versions"]

        d0 = c.diameter()
        assert d0["diameter"] > 0 and d0["n_live"] == args.n0

        t0 = time.perf_counter()
        for i in range(0, len(events), 10):
            res = c.post_events(events[i:i + 10])
            assert res["applied"] >= res["accepted"] > 0, res
        ingest_s = time.perf_counter() - t0

        st = c.stats()
        assert st["events_ingested"] == len(events), st
        assert st["n_live"] >= 4
        assert st["distances_are"] in ("exact", "lower-bound")
        if hier:
            assert st["clusters"] > 0, st
            assert st["reorg"]["head_rebuilds"] >= 0, st

        nodes = c.adjacency()["nodes"]
        assert len(nodes) == st["n_live"]
        r = c.route(nodes[0], nodes[-1])
        assert r["reachable"] and r["distance"] > 0
        assert r["path"] is None or (r["path"][0] == nodes[0]
                                     and r["path"][-1] == nodes[-1])
        if r["path"] is not None:
            assert r["hops"] == len(r["path"]) - 1, r
            # served distance is exact or a lower bound -> stretch >= 1
            assert r["stretch"] >= 1 - 1e-5, r
            assert r["hop_bounds"] == [r["bound"]] * r["hops"], r
            if hier:
                levels = r["hops_by_level"]
                assert levels["local"] + levels["head"] == r["hops"], r
        else:
            assert r["hops"] is None and r["stretch"] is None, r

        # the forced cycle runs after the one in flight, if any; wait for it
        before = sum(reopt_cycles(c.metrics()).values())
        trig = c.reoptimize()
        want = before + 1 + bool(trig["in_flight"])
        deadline = time.monotonic() + args.timeout
        while sum(reopt_cycles(c.metrics()).values()) < want:
            assert time.monotonic() < deadline, "forced reopt never finished"
            time.sleep(0.05)
        check_reopt(reopt_cycles(c.metrics()))
        snap = c.snapshot()
        assert snap["seq"] >= 1, snap
        d1 = c.diameter(exact=True)
        assert d1["exact"] and d1["diameter"] > 0

        # the observability scrape: a fresh daemon process, so counters are
        # absolute — ingested events must match what this script streamed
        scraped = c.metrics()
        assert (scraped["repro_service_events_ingested_total"][()]
                == len(events)), scraped["repro_service_events_ingested_total"]
        reqs = scraped.get("repro_http_requests_total", {})
        assert sum(reqs.values()) > 0, "no HTTP requests counted"
        post_key = (("endpoint", "events"), ("method", "POST"),
                    ("status", "200"))
        assert reqs[post_key] == (len(events) + 9) // 10, reqs
        assert scraped["repro_service_n_live"][()] == st["n_live"]
        # the shared routing instruments: exactly one /v1/route was served
        # (the hier engine additionally counts its internal walk under
        # policy="hier-latency", so hier scrapes carry two series)
        route_reqs = scraped["repro_route_requests_total"]
        assert sum(route_reqs.values()) == (2 if hier else 1), route_reqs
        if r["path"] is not None:
            key = (("outcome", "delivered"), ("policy", "latency"))
            assert route_reqs[key] == 1, route_reqs
            assert scraped["repro_route_hops_count"][()] == 1, scraped
        if hier:
            assert scraped["repro_hier_clusters"][()] == st["clusters"] > 0, \
                scraped.get("repro_hier_clusters")
            assert scraped["repro_hier_headring_diameter"][()] >= 0, scraped
            hier_hops = scraped["repro_hier_route_hops_count"]
            assert hier_hops.get((("level", "local"),), 0) >= 1, hier_hops
        # the forced re-optimization scored candidates through batcheval
        apsp_counts = scraped["repro_apsp_seconds_count"]
        assert sum(apsp_counts.values()) >= 1, apsp_counts
        assert scraped["repro_apsp_workingset_bytes"][()] > 0, scraped

        # route-query latency: HTTP round trips between seeded live pairs
        rng = np.random.default_rng(0)
        nodes = c.adjacency()["nodes"]
        route_ms = []
        delivered = 0
        for _ in range(ROUTE_QUERIES):
            a, b = rng.choice(len(nodes), size=2, replace=False)
            t0 = time.perf_counter()
            q = c.route(nodes[a], nodes[b])
            route_ms.append((time.perf_counter() - t0) * 1e3)
            assert q["reachable"], q
            delivered += q["path"] is not None
        cycles = reopt_cycles(c.metrics())
        check_reopt(cycles)

        c.shutdown()
        rc = proc.wait(timeout=120)
        assert rc == 0, f"daemon exited {rc}"
        out = proc.stdout.read()
        assert "STOPPED" in out, out
        print(f"OK  torch service smoke ({args.policy}, {args.device}): "
              f"{len(events)} events streamed, n_live={st['n_live']}, "
              f"diameter={d1['diameter']:.1f}, clean shutdown", flush=True)
        print(json.dumps({
            "policy": args.policy, "device": args.device, "n0": args.n0,
            "capacity": trace.capacity, "events": len(events),
            "n_live": st["n_live"], "clusters": st.get("clusters"),
            "boot_s": boot_s, "ingest_s": ingest_s,
            "events_per_s": len(events) / ingest_s,
            "route_queries": len(route_ms), "route_delivered": delivered,
            "route_ms_p50": float(np.percentile(route_ms, 50)),
            "route_ms_max": float(np.max(route_ms)),
            "diameter_exact": d1["diameter"],
            "reopt_cycles": cycles}), flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


if __name__ == "__main__":
    main()
