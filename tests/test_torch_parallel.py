"""The port's partitioned construction (paper Alg. 4) and the two new
builders against the JAX package, on the CPU: the batched nearest rings
(first-min ties, INF padding), the partition plan, every engine at N=30
for M in {1, 3, 4, 7, 40} (non-divisible, M > N) and both stitches, the
block scores, the DQN segment constructor with the reference's trained
parameters carried into the port's cache, and ``build("parallel")`` /
``build("dgro-dqn")`` with byte-identical JSON."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import overlay as jov
from repro.core import construction as jc
from repro.core import embedding as je
from repro.core import parallel as jp
from repro.core.topology import make_latency
from repro_torch import overlay as tov
from repro_torch.core import batcheval as tb
from repro_torch.core import construction as tc
from repro_torch.core import embedding as te
from repro_torch.core import parallel as tp
from repro_torch.core import qlearning as tq


@pytest.fixture(autouse=True)
def _on_cpu():
    with tb.eval_options(device="cpu"):
        yield


def _carry(jparams):
    return te.qparams_from_jax({k: np.asarray(v) for k, v in
                                jparams._asdict().items()}, device="cpu")


def _same_rings(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_nearest_ring_batched_padded_and_tied():
    rng = np.random.default_rng(0)
    m, p = 5, 12
    blocks = rng.uniform(1, 100, (m, p, p)).astype(np.float32)
    blocks = np.minimum(blocks, blocks.transpose(0, 2, 1))
    for i, size in enumerate((12, 9, 5, 1, 3)):        # INF-padded blocks
        blocks[i, size:, :] = blocks[i, :, size:] = jp.INF
    blocks[0, 3] = blocks[0, :, 3] = 7.0               # a row of ties
    blocks[4] = 1.0                                    # all tied
    starts = np.array([3, 0, 4, 0, 2], np.int32)
    want = np.asarray(jc.nearest_rings_batched(jnp.asarray(blocks),
                                               jnp.asarray(starts)))
    got = tc.nearest_ring_batched(torch.from_numpy(blocks),
                                  torch.from_numpy(starts))
    assert np.array_equal(got.numpy(), want)
    assert tc.nearest_rings_batched is tc.nearest_ring_batched
    for i in range(m):
        assert sorted(got[i].tolist()) == list(range(p))


@pytest.mark.parametrize("n,m", [(30, 1), (30, 7), (30, 40), (100, 7), (5, 8)])
def test_plan_partitions_identical(n, m):
    a = tp.plan_partitions(n, m, np.random.default_rng(n + m))
    b = jp.plan_partitions(n, m, np.random.default_rng(n + m))
    _same_rings(a.parts, b.parts)
    assert np.array_equal(a.sizes, b.sizes)
    assert np.array_equal(a.starts, b.starts)
    assert a.p_max == b.p_max
    with pytest.raises(ValueError):
        tp.plan_partitions(n, 0, np.random.default_rng(0))


@pytest.mark.parametrize("stitch", ["naive", "scored"])
@pytest.mark.parametrize("m", [1, 3, 4, 7, 40])
def test_engines_match_reference(m, stitch):
    w = make_latency("gaussian", 30, seed=3)
    want = jp.parallel_ring(w, m, seed=0, stitch=stitch)
    assert sorted(want) == list(range(30))
    assert np.array_equal(tp.parallel_ring(w, m, seed=0, stitch=stitch), want)
    assert np.array_equal(tp.parallel_ring_host(w, m, seed=0, stitch=stitch),
                          jp.parallel_ring_host(w, m, seed=0, stitch=stitch))
    assert np.array_equal(tp.parallel_ring_host(w, m, seed=0, stitch=stitch),
                          want)
    assert np.array_equal(tp.parallel_ring_shmap(w, m, seed=0, stitch=stitch),
                          want)
    seeds = [3, 11, 42]
    _same_rings(tp.parallel_rings(w, m, seeds, stitch=stitch),
                jp.parallel_rings(w, m, seeds, stitch=stitch))
    ring_t, sc_t = tp.parallel_ring_scored(w, m, seed=5, score_blocks=True,
                                           stitch=stitch)
    ring_j, sc_j = jp.parallel_ring_scored(w, m, seed=5, score_blocks=True,
                                           stitch=stitch)
    assert np.array_equal(ring_t, ring_j)
    assert np.array_equal(np.isnan(sc_t), np.isnan(sc_j))
    assert np.array_equal(sc_t, sc_j, equal_nan=True)
    ov_t, _ = tp.parallel_overlay(w, m, seed=2, stitch=stitch)
    ov_j, _ = jp.parallel_overlay(w, m, seed=2, stitch=stitch)
    assert ov_t.to_json() == ov_j.to_json()
    assert ov_t.diameter() == ov_j.diameter()


def test_score_partition_blocks_nan_for_empty():
    w = make_latency("uniform", 9, seed=1)
    segs = [np.array([0, 1]), np.array([], np.intp), np.array([2, 3, 4, 8]),
            np.array([5]), np.array([], np.intp)]
    got = tp.score_partition_blocks(w, segs)
    want = jp.score_partition_blocks(w, segs)
    assert np.array_equal(got, want, equal_nan=True)
    assert np.isnan(got[[1, 4]]).all() and np.isfinite(got[[0, 2, 3]]).all()
    assert np.isnan(tp.score_partition_blocks(w, [np.array([], np.intp)])).all()
    with pytest.raises(ValueError):
        tp.stitch_segments(w, [np.array([], np.intp)])
    with pytest.raises(ValueError):
        tp.stitch_segments(w, [np.arange(9)], stitch="bogus")


def _carry_segment_params(monkeypatch, p, j_dqn, t_dqn):
    """Train the reference's segment constructor and place its parameters in
    the port's cache under the port's key."""
    jparams, jcfg = jp._segment_qparams(p, j_dqn)
    tcfg = tq.DQNConfig(**{f: getattr(jcfg, f)
                           for f in jcfg.__dataclass_fields__})
    monkeypatch.setitem(tp._SEGMENT_PARAMS_CACHE, (p, t_dqn),
                        (_carry(jparams), tcfg))


@pytest.mark.parametrize("stitch", ["naive", "scored"])
def test_dqn_segments_with_carried_params(monkeypatch, stitch):
    """n=13, m=3: unequal (5, 4, 4) padded blocks through the rollout's
    ``sizes``; the reference's trained parameters give the same segments."""
    w = make_latency("uniform", 13, seed=1)
    kw = dict(epochs=2, n_envs=2)
    _carry_segment_params(monkeypatch, 5, jp.SegmentDQNConfig(**kw),
                          tp.SegmentDQNConfig(**kw))
    plans = [tp.plan_partitions(13, 3, np.random.default_rng(s))
             for s in (0, 1)]
    got = tp._segments_dqn_many(w, plans, tp.SegmentDQNConfig(**kw))
    want = jp._segments_dqn_many(w, [jp.plan_partitions(
        13, 3, np.random.default_rng(s)) for s in (0, 1)],
        jp.SegmentDQNConfig(**kw))
    for segs_t, segs_j in zip(got, want):
        _same_rings(segs_t, segs_j)
    rings_t = tp.parallel_rings(w, 3, [0, 1], constructor="dqn",
                                stitch=stitch, dqn=tp.SegmentDQNConfig(**kw))
    rings_j = jp.parallel_rings(w, 3, [0, 1], constructor="dqn",
                                stitch=stitch, dqn=jp.SegmentDQNConfig(**kw))
    _same_rings(rings_t, rings_j)
    # blocks of <= 2 nodes go to the nearest constructor on both sides
    w6 = make_latency("uniform", 6, seed=0)
    assert np.array_equal(tp.parallel_ring(w6, 3, seed=0, constructor="dqn"),
                          jp.parallel_ring(w6, 3, seed=0, constructor="dqn"))


@pytest.mark.parametrize("cfg", [
    dict(m=3, stitch="naive"), dict(m=4), dict(m=7, extra_random=2),
    dict(m=40, stitch="scored")])
def test_build_parallel_json_identical(cfg):
    w = make_latency("fabric", 30, seed=4)
    got = tov.build("parallel", w, tov.ParallelConfig(**cfg), seed=2)
    want = jov.build("parallel", w, jov.ParallelConfig(**cfg), seed=2)
    assert got.to_json() == want.to_json()
    assert got.policy == "parallel"


def test_build_parallel_dqn_json_identical(monkeypatch):
    w = make_latency("uniform", 13, seed=1)
    _carry_segment_params(monkeypatch, 5, jp.SegmentDQNConfig(epochs=2),
                          tp.SegmentDQNConfig(epochs=2))
    cfg = dict(m=3, constructor="dqn", dqn_epochs=2)
    got = tov.build("parallel", w, tov.ParallelConfig(**cfg), seed=0)
    want = jov.build("parallel", w, jov.ParallelConfig(**cfg), seed=0)
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("rollout", ["device", "host"])
def test_build_dgro_dqn_json_identical(monkeypatch, rollout):
    """The port's Q-network init is patched to return the reference's
    ``jax.random`` draws for the builder's seed."""
    monkeypatch.setattr(
        tq, "init_qparams",
        lambda gen, p, h, device=None: _carry(je.init_qparams(
            jax.random.PRNGKey(gen.initial_seed()), p, h)))
    w = make_latency("bitnode", 10, seed=3)
    kw = dict(k=2, epochs=2, n_starts=3, rollout=rollout)
    got = tov.build("dgro-dqn", w, tov.DGRODQNConfig(**kw), seed=1)
    want = jov.build("dgro-dqn", w, jov.DGRODQNConfig(**kw), seed=1)
    assert got.to_json() == want.to_json()
    assert got.policy == "dgro-dqn" and got.num_rings == 2
    assert got.diameter() == pytest.approx(want.diameter(), rel=1e-6)
    got._cache.clear()                       # recompute through batcheval
    assert got.diameter() == pytest.approx(want.diameter(), rel=1e-5)
