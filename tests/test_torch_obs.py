"""The port's observability layer (``repro_torch.obs``) against
``repro.obs``: the registry's semantics, quantile math, concurrency, spans,
the first-call split, the lock-wait histogram, exposition and structured
logging -- the cases of ``tests/test_obs.py`` run on the port -- and, with
both packages side by side, byte-identical ``render_prometheus()`` /
``render_json()`` for the same observations and the same series from one
instrumented ``diameters`` and one ``rollout_episodes`` call.  The
service cases of ``tests/test_obs.py`` wait for the port's service."""
from __future__ import annotations

import logging
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.obs as jobs
from repro.core import batcheval as jb
from repro.core import embedding as je
from repro.core import rollout as jr
from repro.core.topology import make_latency
from repro_torch import obs as tobs
from repro_torch import serde
from repro_torch.core import batcheval as tb
from repro_torch.core import embedding as te
from repro_torch.core import rollout as tr
from repro_torch.obs import (REGISTRY, Histogram, MetricsRegistry,
                             TimedRLock, current_span, jit_span,
                             parse_prometheus, span)
from repro_torch.obs.logsetup import KVFormatter, configure, get_logger, kv


# ---------------------------------------------------------------------------
# registration semantics
# ---------------------------------------------------------------------------

def test_same_spec_registration_returns_existing_instrument():
    reg = MetricsRegistry()
    a = reg.counter("x_total", "things", labels=("k",))
    b = reg.counter("x_total", "things", labels=("k",))
    assert a is b
    h1 = reg.histogram("h_seconds", "hh", buckets=(1.0, 2.0))
    h2 = reg.histogram("h_seconds", "hh", buckets=(1.0, 2.0))
    assert h1 is h2


def test_conflicting_registration_raises_at_registration_time():
    reg = MetricsRegistry()
    reg.counter("x_total", "things", labels=("k",))
    with pytest.raises(ValueError):
        reg.gauge("x_total", "things")           # different kind
    with pytest.raises(ValueError):
        reg.counter("x_total", "other help", labels=("k",))
    with pytest.raises(ValueError):
        reg.counter("x_total", "things")         # different labels
    reg.histogram("h_seconds", "hh", buckets=(1.0, 2.0))
    with pytest.raises(ValueError):
        reg.histogram("h_seconds", "hh", buckets=(1.0, 2.0, 3.0))


def test_bad_histogram_buckets_rejected():
    with pytest.raises(ValueError):
        Histogram("h", buckets=())
    with pytest.raises(ValueError):
        Histogram("h", buckets=(2.0, 1.0))
    with pytest.raises(ValueError):
        Histogram("h", buckets=(1.0, 1.0))


# ---------------------------------------------------------------------------
# quantile math vs numpy
# ---------------------------------------------------------------------------

def _bucket_tolerance(buckets, samples, value):
    """The histogram's resolution at ``value``: the containing bucket's
    width (clamp slack past the last bound)."""
    bounds = list(buckets)
    if value > bounds[-1]:
        return float(np.max(samples)) - bounds[-1] + 1e-9
    hi = next(b for b in bounds if value <= b)
    lo = max([float(np.min(samples))] + [b for b in bounds if b < hi])
    return max(hi - lo, 0.0) + 1e-9


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.floats(0.0, 1.0))
def test_histogram_quantile_within_bucket_of_numpy(seed, q):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    samples = rng.gamma(2.0, 0.05, size=n)
    h = Histogram("q_seconds")
    jh = jobs.Histogram("q_seconds")
    for s in samples:
        h.observe(float(s))
        jh.observe(float(s))
    est = h.quantile(q)
    true = float(np.quantile(samples, q, method="inverted_cdf"))
    assert float(np.min(samples)) <= est <= float(np.max(samples))
    assert abs(est - true) <= _bucket_tolerance(h.buckets, samples, true)
    assert est == jh.quantile(q)


def test_histogram_summary_and_empty_quantile():
    h = Histogram("s_seconds")
    assert np.isnan(h.quantile(0.5))
    for v in (0.003, 0.004, 0.2):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 3 and s["sum"] == pytest.approx(0.207)
    with pytest.raises(ValueError):
        h.quantile(1.5)


# ---------------------------------------------------------------------------
# thread-safety: concurrent increments sum exactly
# ---------------------------------------------------------------------------

def test_concurrent_counter_increments_sum_exactly():
    reg = MetricsRegistry()
    ctr = reg.counter("hits_total", "hits")
    lab = reg.counter("lhits_total", "labelled hits", labels=("who",))
    hist = reg.histogram("obs_seconds", "observations")
    n_threads, per_thread = 8, 2_000

    def work(i):
        child = lab.labels(who=f"t{i % 2}")
        for _ in range(per_thread):
            ctr.inc()
            child.inc()
            hist.observe(0.01)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = n_threads * per_thread
    assert ctr.value == total
    assert (lab.labels(who="t0").value + lab.labels(who="t1").value) == total
    assert hist.count == total


# ---------------------------------------------------------------------------
# spans + first-call-aware timing
# ---------------------------------------------------------------------------

def test_span_nesting_and_counts():
    reg = MetricsRegistry()
    assert current_span() is None
    with span("outer", registry=reg):
        assert current_span() == "outer"
        with span("inner", registry=reg):
            assert current_span() == "inner"
        assert current_span() == "outer"
    assert current_span() is None
    h = reg.get("repro_span_seconds")
    assert h.labels(span="outer").count == 1
    assert h.labels(span="inner").count == 1


def test_jit_span_splits_compile_from_execute():
    reg = MetricsRegistry()
    for _ in range(3):
        with jit_span("fn.a", key=(4, 4), registry=reg):
            pass
    with jit_span("fn.a", key=(8, 8), registry=reg):  # new key
        pass
    comp = reg.get("repro_jit_compile_seconds").labels(fn="fn.a")
    execd = reg.get("repro_jit_execute_seconds").labels(fn="fn.a")
    assert comp.count == 2          # one first call per distinct key
    assert execd.count == 2


def test_disabled_registry_records_nothing():
    reg = MetricsRegistry()
    ctr = reg.counter("c_total", "c")
    hist = reg.histogram("h_seconds", "h")
    reg.set_enabled(False)
    ctr.inc()
    hist.observe(1.0)
    with span("quiet", registry=reg):
        pass
    reg.set_enabled(True)
    assert ctr.value == 0 and hist.count == 0
    assert reg.get("repro_span_seconds") is None or \
        reg.get("repro_span_seconds").labels(span="quiet").count == 0


def test_timed_rlock_reentrant_and_records_waits():
    reg = MetricsRegistry()
    lock = TimedRLock(registry=reg, name="w_seconds", help="w")
    with lock:
        with lock:                  # re-entrant acquire must not deadlock
            pass
    hist = reg.get("w_seconds")
    assert hist.count == 1          # only the top-level acquire is observed

    entered = threading.Event()
    release = threading.Event()

    def holder():
        with lock:
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    t.start()
    assert entered.wait(5.0)
    t2_done = threading.Event()

    def waiter():
        with lock:
            t2_done.set()

    t2 = threading.Thread(target=waiter)
    t2.start()
    time.sleep(0.05)
    release.set()
    t.join()
    assert t2_done.wait(5.0)
    t2.join()
    assert hist.count == 3
    assert hist.quantile(1.0) >= 0.01   # the contended acquire waited


# ---------------------------------------------------------------------------
# exposition: render -> parse roundtrip, JSON export
# ---------------------------------------------------------------------------

def test_prometheus_render_parse_roundtrip():
    reg = MetricsRegistry()
    reg.counter("ev_total", "events", labels=("kind",)).labels(
        kind="join").inc(3)
    reg.gauge("temp", "temperature").set(4.5)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    text = reg.render_prometheus()
    parsed = parse_prometheus(text)
    assert parsed["ev_total"][(("kind", "join"),)] == 3.0
    assert parsed["temp"][()] == 4.5
    assert parsed["lat_seconds_bucket"][(("le", "0.1"),)] == 1.0
    assert parsed["lat_seconds_bucket"][(("le", "1"),)] == 2.0     # cumulative
    assert parsed["lat_seconds_bucket"][(("le", "+Inf"),)] == 2.0
    assert parsed["lat_seconds_count"][()] == 2.0
    assert parsed == jobs.parse_prometheus(text)


def test_gauge_callback_read_at_scrape_time():
    reg = MetricsRegistry()
    box = {"v": 1.0}
    reg.gauge("live", "live value").set_function(lambda: box["v"])
    assert parse_prometheus(reg.render_prometheus())["live"][()] == 1.0
    box["v"] = 7.0
    assert parse_prometheus(reg.render_prometheus())["live"][()] == 7.0


def test_render_json_is_schema_stamped():
    reg = MetricsRegistry()
    reg.counter("c_total", "c").inc()
    doc = serde.loads(reg.render_json(), what="metrics json")
    assert doc["schema"] == serde.SCHEMA_VERSION
    m = doc["metrics"]["c_total"]
    assert m["kind"] == "counter"
    assert m["series"][0]["value"] == 1.0


# ---------------------------------------------------------------------------
# the same observations render byte-identically in both packages
# ---------------------------------------------------------------------------

def _observe(reg, rng) -> None:
    """One seeded observation sequence: labelled and plain counters,
    gauges, default- and custom-bucket histograms, escaped label values."""
    ctr = reg.counter("ev_total", "events, by kind", labels=("kind",))
    plain = reg.counter("hits_total", "hits")
    g = reg.gauge("level", "a level")
    lg = reg.gauge("per_node", "per node", labels=("node", "site"))
    h = reg.histogram("lat_seconds", "latency")
    hc = reg.histogram("hops", "hops", labels=("level",),
                       buckets=(1, 2, 3, 4, 6, 8, 12, 16))
    kinds = ("join", "leave", 'we"ird\\kind\n')
    for _ in range(int(rng.integers(1, 60))):
        op = int(rng.integers(6))
        if op == 0:
            ctr.labels(kind=kinds[int(rng.integers(3))]).inc(
                float(rng.integers(1, 4)))
        elif op == 1:
            plain.inc(float(rng.uniform(0, 2)))
        elif op == 2:
            g.set(float(rng.normal(0, 100)))
        elif op == 3:
            lg.labels(node=str(int(rng.integers(5))),
                      site=str(int(rng.integers(2)))).inc(
                float(rng.uniform(-1, 1)))
        elif op == 4:
            h.observe(float(rng.gamma(2.0, 0.05)))
        else:
            hc.labels(level=str(int(rng.integers(3)))).observe(
                float(rng.integers(0, 20)))


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10_000), st.integers(0, 1))
def test_same_observations_render_byte_identical(seed, disable):
    got, want = MetricsRegistry(), jobs.MetricsRegistry()
    for reg in (got, want):
        _observe(reg, np.random.default_rng(seed))
        if disable:                  # records after this are dropped
            reg.set_enabled(False)
            _observe(reg, np.random.default_rng(seed + 1))
    assert got.render_prometheus() == want.render_prometheus()
    assert got.render_json() == want.render_json()
    with jit_span("fn.x", key=seed, registry=got):
        pass
    with jobs.jit_span("fn.x", key=seed, registry=want):
        pass
    assert sorted(parse_prometheus(got.render_prometheus())) == \
        sorted(jobs.parse_prometheus(want.render_prometheus()))


def test_default_registry_preregisters_the_reference_series():
    for name in ("repro_hier_clusters", "repro_hier_headring_diameter",
                 "repro_hier_route_hops", "repro_span_seconds",
                 "repro_spans_total", "repro_jit_compile_seconds",
                 "repro_jit_execute_seconds"):
        assert REGISTRY.get(name).spec == jobs.REGISTRY.get(name).spec, name


def test_instrumented_calls_register_the_same_series():
    """One ``diameters`` and one ``rollout_episodes`` call in each package
    create the same instruments (kind, help, labels, buckets) and the same
    labelled series (first calls after ``reset_jit_state``)."""
    rng = np.random.default_rng(0)
    n = 12
    w = make_latency("uniform", n, seed=1)
    adjs = jb.adjacency_batch_from_rings(
        w, np.stack([[rng.permutation(n)] for _ in range(3)]))
    jobs.reset_jit_state()
    tobs.reset_jit_state()
    jb.diameters(adjs)
    tb.diameters(adjs, device="cpu")
    jp = je.init_qparams(jax.random.PRNGKey(0), 8, 16)
    tp = te.qparams_from_jax({k: np.asarray(v) for k, v in
                              jp._asdict().items()}, device="cpu")
    ws = np.stack([make_latency("uniform", 6, seed=s) for s in (2, 3)])
    plan = jr.make_plan(np.random.default_rng(3), 2, 1, 6)
    jr.rollout_episodes(jp, jnp.asarray(ws), jnp.asarray(plan.starts),
                        jnp.asarray(plan.eps_u), jnp.asarray(plan.choice_u),
                        0.5, 0.1, k_rings=1)
    tr.rollout_episodes(tp, torch.from_numpy(ws), plan.starts, plan.eps_u,
                        plan.choice_u, 0.5, 0.1, k_rings=1)
    for name in ("repro_apsp_seconds", "repro_apsp_workingset_bytes",
                 "repro_apsp_quant_rel_err",
                 "repro_apsp_exact_fallbacks_total",
                 "repro_jit_compile_seconds", "repro_jit_execute_seconds"):
        assert REGISTRY.get(name).spec == jobs.REGISTRY.get(name).spec, name
    for reg in (REGISTRY, jobs.REGISTRY):
        apsp = dict(reg.get("repro_apsp_seconds")._series())
        assert ("fw", "compile") in apsp
        comp = dict(reg.get("repro_jit_compile_seconds")._series())
        assert ("batcheval.diameters",) in comp
        assert ("rollout.rollout_episodes",) in comp
    t_text = parse_prometheus(REGISTRY.render_prometheus())
    j_text = jobs.parse_prometheus(jobs.REGISTRY.render_prometheus())
    for series in ("repro_apsp_seconds_bucket",
                   "repro_jit_compile_seconds_bucket"):
        mine = {k for k in t_text[series]
                if ("method", "fw") in k or ("fn", "rollout.rollout_episodes")
                in k or ("fn", "batcheval.diameters") in k}
        assert mine and mine <= set(j_text[series]), series


# ---------------------------------------------------------------------------
# structured logging
# ---------------------------------------------------------------------------

def test_kv_formatting_quotes_and_types():
    line = kv("reopt.cycle", outcome="swapped", n=3, ratio=0.25,
              ok=True, msg='has space and "quote"')
    assert line.startswith("event=reopt.cycle ")
    assert "outcome=swapped" in line and "n=3" in line
    assert "ratio=0.25" in line and "ok=true" in line
    assert 'msg="has space and \\"quote\\""' in line
    assert line == jobs.kv("reopt.cycle", outcome="swapped", n=3,
                           ratio=0.25, ok=True, msg='has space and "quote"')


def test_log_level_env_and_formatter(monkeypatch):
    monkeypatch.setenv("REPRO_LOG_LEVEL", "debug")
    configure(force=True)
    log = get_logger("test")
    assert log.name == "repro_torch.test"
    assert get_logger("repro_torch.x").name == "repro_torch.x"
    assert logging.getLogger("repro_torch").level == logging.DEBUG
    rec = logging.LogRecord("repro_torch.test", logging.INFO, __file__, 1,
                            kv("unit.test", n=1), None, None)
    out = KVFormatter().format(rec)
    assert "level=info" in out and "logger=repro_torch.test" in out
    assert "event=unit.test n=1" in out
    monkeypatch.delenv("REPRO_LOG_LEVEL")
    configure(force=True)           # restore the library default
    assert logging.getLogger("repro_torch").level == logging.WARNING
