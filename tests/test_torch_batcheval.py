"""The port's diameter engine against ``repro.core.batcheval``: every method
bit-equal to the reference method of the same name, streamed output
bit-equal to one-shot, reduced precision with the same reports and exact
fallback, and the knob resolution (``eval_options`` / env) the reference
has -- all on the CPU, where the engine runs the kernels' twins."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import batcheval as jb
from repro.core import diameter as jd
from repro.core.topology import make_latency
from repro_torch.core import batcheval as tb
from repro_torch.core import diameter as td

CPU = "cpu"


def _genomes(rng, b, n, k=2):
    return np.stack([[rng.permutation(n) for _ in range(k)]
                     for _ in range(b)])


def _batch(dist="gaussian", n=40, b=6, seed=0, k=2):
    rng = np.random.default_rng(seed)
    w = make_latency(dist, n, seed=seed + 1)
    return w, _genomes(rng, b, n, k), jb.adjacency_batch_from_rings(
        w, _genomes(rng, b, n, k))


# --- graph assembly (numpy copies) -------------------------------------------

def test_graph_assembly_matches_reference():
    rng = np.random.default_rng(1)
    w = make_latency("fabric", 25, seed=3)
    g = _genomes(rng, 5, 25, 3)
    assert np.array_equal(tb.adjacency_batch_from_rings(w, g),
                          jb.adjacency_batch_from_rings(w, g))
    base = jd.adjacency_from_rings(w, [rng.permutation(25)])
    rings = np.stack([rng.permutation(25) for _ in range(4)])[:, None, :]
    assert np.array_equal(tb.overlay_with_rings(base, w, rings),
                          jb.overlay_with_rings(base, w, rings))
    blocks = [base[:m, :m] for m in (5, 11, 25)]
    assert np.array_equal(tb.pad_adjacency_blocks(blocks),
                          jb.pad_adjacency_blocks(blocks))
    edges = rng.integers(0, 25, size=(60, 2))
    assert np.array_equal(td.adjacency_from_edges(w, edges),
                          jd.adjacency_from_edges(w, edges))
    assert np.array_equal(tb.quantize_latency(base)[0],
                          jb.quantize_latency(base)[0])


# --- the three methods ----------------------------------------------------

@pytest.mark.parametrize("method,symmetric", [("fw", True), ("fw", False),
                                              ("squaring", True),
                                              ("tiled", True),
                                              ("tiled", False)])
def test_method_bit_equal_reference(method, symmetric):
    _, _, adjs = _batch(n=40, b=5, seed=2)
    tile = 16 if method == "tiled" else None
    want = jb.diameters(adjs, method=method, symmetric=symmetric, tile=tile)
    got = tb.diameters(adjs, method=method, symmetric=symmetric, tile=tile,
                       device=CPU)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    want_d = jb.apsp_matrices(adjs, method=method, symmetric=symmetric,
                              tile=tile)
    got_d = tb.apsp_matrices(adjs, method=method, symmetric=symmetric,
                             tile=tile, device=CPU)
    assert np.array_equal(got_d, want_d)


def test_auto_method_on_cpu_and_use_kernel():
    _, _, adjs = _batch(n=24, b=4, seed=3)
    with tb.eval_options(device=CPU):
        got = tb.diameters(adjs)
        assert tb.last_eval_report()["method"] == "fw"
        got_k = tb.diameters(adjs, use_kernel=True)
        assert tb.last_eval_report()["method"] == "squaring"
    assert np.array_equal(got, jb.diameters(adjs))
    assert np.array_equal(got_k, jb.diameters(adjs, use_kernel=True))
    assert tb._auto_method(False, 511, torch.device("cuda")) == "squaring"
    assert tb._auto_method(False, 512, torch.device("cuda")) == "tiled"


def test_streamed_bit_equal_one_shot_and_reference():
    w, genomes, adjs = _batch("uniform", n=18, b=23, seed=4)
    direct = tb.diameters(adjs, device=CPU)
    chunked = tb.diameters(adjs, chunk=4, device=CPU)  # 6 chunks, padded
    assert tb.last_eval_report()["device_calls"] == 6
    assert np.array_equal(direct, chunked)
    assert np.array_equal(chunked, jb.diameters(adjs, chunk=4))
    lazy = tb.diameters_of_rings(w, genomes, chunk=5, device=CPU)
    assert np.array_equal(lazy, jb.diameters_of_rings(w, genomes, chunk=5))
    src = tb.RingBlockSource(w, genomes)
    assert len(src) == 23 and src.n == 18
    assert np.array_equal(src.block(3, 7),
                          jb.RingBlockSource(w, genomes).block(3, 7))


_REPORT_KEYS = ("b", "n", "method", "dtype", "chunk", "tile",
                "workingset_bytes", "device_calls", "quant_scale",
                "quant_rel_err", "fallback")


@pytest.mark.parametrize("dtype,rtol", [("bfloat16", None), ("int16", None),
                                        ("bfloat16", 0.0)])
def test_reduced_precision_reports_and_fallback(dtype, rtol):
    """bf16 / int16 match the reference's diameters and report fields; with
    ``exact_rtol=0`` both fall back to an exact float32 rerun."""
    _, _, adjs = _batch("gaussian", n=32, b=10, seed=5)
    want = jb.diameters(adjs, dtype=dtype, exact_rtol=rtol)
    jrep = jb.last_eval_report()
    got = tb.diameters(adjs, dtype=dtype, exact_rtol=rtol, device=CPU)
    trep = tb.last_eval_report()
    assert trep["device"] == "cpu"
    assert {k: trep[k] for k in _REPORT_KEYS} == \
        {k: jrep[k] for k in _REPORT_KEYS}
    np.testing.assert_allclose(got, want, rtol=0.05)
    assert np.array_equal(got, want)
    exact = jb.diameters(adjs)
    if trep["fallback"]:
        assert np.array_equal(got, exact)
    else:
        assert 0 < trep["quant_rel_err"] < 0.05
        np.testing.assert_allclose(got, exact, rtol=0.05)


def test_eval_options_precedence_and_env(monkeypatch):
    _, _, adjs = _batch(n=20, b=3, seed=6)
    monkeypatch.setenv("REPRO_APSP_METHOD", "squaring")
    monkeypatch.setenv("REPRO_APSP_CHUNK", "2")
    with tb.eval_options(device=CPU):
        tb.diameters(adjs)
        rep = tb.last_eval_report()
        assert (rep["method"], rep["chunk"]) == ("squaring", 2)
        with tb.eval_options(method="tiled", tile=8):
            tb.diameters(adjs)
            assert tb.last_eval_report()["method"] == "tiled"
            tb.diameters(adjs, method="fw")       # call-site kwarg wins
            assert tb.last_eval_report()["method"] == "fw"
        tb.diameters(adjs)
        assert tb.last_eval_report()["method"] == "squaring"
    with pytest.raises(ValueError):
        with tb.eval_options(bogus=1):
            pass
    with pytest.raises(ValueError):
        with tb.eval_options(method="dijkstra"):
            pass


@pytest.mark.parametrize("method", ["fw", "squaring", "tiled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_memory_model_matches_reference(method, dtype):
    for n in (64, 300, 4096):
        for use_kernel in (False, True):
            assert tb.workingset_bytes(3, n, method, dtype=dtype,
                                       use_kernel=use_kernel) == \
                jb.workingset_bytes(3, n, method, dtype=dtype,
                                    use_kernel=use_kernel)
            assert tb.default_chunk(n, method, dtype=dtype,
                                    use_kernel=use_kernel) == \
                jb.default_chunk(n, method, dtype=dtype,
                                 use_kernel=use_kernel)


# --- diameter primitives --------------------------------------------------

def test_largest_cc_first_max_anchor_and_disconnected():
    """Two components of EQUAL size and different diameters: the anchor is
    the first node of maximal component size, as in the reference."""
    w = make_latency("uniform", 12, seed=0)
    e_tie = np.concatenate([td.ring_edges(np.arange(6)),
                            td.ring_edges(np.arange(6, 12)[::-1])])
    w2 = w.copy()
    w2[6:, 6:] *= 3
    e_big = np.concatenate([td.ring_edges(np.arange(4)),
                            td.ring_edges(np.arange(4, 12))])
    for ww, e in ((w, e_tie), (w2, e_tie), (w, e_big)):
        adj = td.adjacency_from_edges(ww, e)
        d = td.apsp(torch.from_numpy(adj))
        assert np.array_equal(d.numpy(),
                              np.asarray(jd.apsp(jnp.asarray(adj))))
        want = float(jd.largest_cc_diameter(jnp.asarray(d.numpy())))
        assert float(td.largest_cc_diameter(d)) == want
        assert float(td.largest_cc_diameter(d.bfloat16())) == float(
            jd.largest_cc_diameter(jnp.asarray(d.numpy()).astype(
                jnp.bfloat16)))
        stacked = td.largest_cc_diameter(torch.stack([d, d]))
        assert stacked.tolist() == [want, want]
    adj = td.adjacency_from_edges(w2, e_tie)
    assert np.array_equal(tb.diameters(adj[None], device=CPU),
                          jb.diameters(adj[None]))


def test_relax_edge_update_and_diameter_of_rings():
    rng = np.random.default_rng(9)
    w = make_latency("bitnode", 30, seed=9)
    rings = [rng.permutation(30)]
    adj = td.adjacency_from_rings(w, rings)
    d = td.apsp(torch.from_numpy(adj))
    got = td.relax_edge_update(d, 3, 17, torch.tensor(w[3, 17]))
    want = jd.relax_edge_update(jnp.asarray(d.numpy()), 3, 17,
                                jnp.asarray(w[3, 17]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert td.diameter_of_rings(w, rings, device=CPU) == \
        jd.diameter_of_rings(w, rings)
    assert td.diameter_scipy(adj) == jd.diameter_scipy(adj)


# --- the sharded entry points on one device, diameter.minplus, protocols ----

@pytest.mark.parametrize("method", [None, "fw", "squaring", "tiled"])
@pytest.mark.parametrize("dtype", [None, "bfloat16", "int16"])
def test_diameters_sharded_bit_equal_reference(method, dtype):
    """The reference's default mesh has one CPU device here, so it takes
    its own fallback to the streaming ``diameters``: the port is that."""
    _, _, adjs = _batch(n=30, b=5, seed=6)
    tile = 8 if method == "tiled" else None
    want = jb.diameters_sharded(adjs, method=method, dtype=dtype, tile=tile)
    got = tb.diameters_sharded(adjs, method=method, dtype=dtype, tile=tile,
                               device=CPU)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    empty = np.zeros((0, 30, 30), np.float32)
    assert tb.diameters_sharded(empty, device=CPU).shape == (0,)
    assert jb.diameters_sharded(empty).shape == (0,)


@pytest.mark.parametrize("n", [2, 3, 17, 40])
def test_apsp_rowshard_bit_equal_reference(n):
    rng = np.random.default_rng(n)
    w = make_latency("fabric", n, seed=n)
    adj = jd.adjacency_from_rings(w, [rng.permutation(n) for _ in range(2)])
    adj[0, :] = adj[:, 0] = float(td.INF)      # an isolated node, too
    adj[0, 0] = 0.0
    got = tb.apsp_rowshard(adj, device=CPU)
    want = jb.apsp_rowshard(adj)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    with tb.eval_options(device=CPU):
        assert np.array_equal(tb.apsp_rowshard(adj), want)


def test_apsp_rowshard_observed_like_the_reference():
    from repro_torch.obs import REGISTRY

    adj = jd.adjacency_from_rings(make_latency("uniform", 9, seed=1),
                                  [np.arange(9)])
    hist = REGISTRY.get("repro_apsp_seconds")
    before = sum(c.count for _, c in hist._series())
    tb.apsp_rowshard(adj, device=CPU)
    assert sum(c.count for _, c in hist._series()) == before + 1
    assert REGISTRY.get("repro_apsp_workingset_bytes").value == 4 * 3 * 81


@pytest.mark.parametrize("shape", [(7, 7, 7), (5, 13, 9), (1, 4, 1)])
def test_diameter_minplus_matches_reference(shape):
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0, 10, (m, k)).astype(np.float32)
    b = rng.uniform(0, 10, (k, n)).astype(np.float32)
    want = np.asarray(jd.minplus(jnp.asarray(a), jnp.asarray(b)))
    want_k = np.asarray(jd.minplus(jnp.asarray(a), jnp.asarray(b),
                                   use_kernel=True))
    for use_kernel in (False, True):
        got = td.minplus(torch.from_numpy(a), torch.from_numpy(b),
                         use_kernel=use_kernel)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), want_k)


def test_node_degrees_and_removed_protocol_names():
    from repro.core import protocols as jp
    from repro_torch.core import protocols as tp

    rng = np.random.default_rng(2)
    w = make_latency("gaussian", 20, seed=2)
    adj = jd.adjacency_from_rings(w, [rng.permutation(20) for _ in range(3)])
    assert np.array_equal(tp.node_degrees(adj), jp.node_degrees(adj))
    assert np.array_equal(tp.node_degrees(adj[:1, :1]),
                          jp.node_degrees(adj[:1, :1]))
    for name in ("chord", "rapid", "perigee", "with_replaced_rings"):
        with pytest.raises(AttributeError) as got:
            getattr(tp, name)
        with pytest.raises(AttributeError) as want:
            getattr(jp, name)
        assert str(got.value) == str(want.value).replace(
            "repro.", "repro_torch.")
    with pytest.raises(AttributeError, match="no attribute"):
        tp.nonexistent
