"""The slice as a whole against the JAX package: ``build("dgro")`` and the
other builders draw the same rings and score the same diameters,
``selection.adapt`` makes the same choice, and the JSON snapshot is
byte-identical both ways.  The port runs on the CPU here, asked for with
``eval_options(device="cpu")``."""
import numpy as np
import pytest

from repro import overlay as jov
from repro.core import selection as jsel
from repro.core.ga import GAConfig as JGAConfig
from repro.core.topology import make_latency
from repro_torch import overlay as tov
from repro_torch.core import batcheval as tb
from repro_torch.core import selection as tsel
from repro_torch.core.ga import GAConfig


@pytest.fixture(autouse=True)
def _on_cpu():
    with tb.eval_options(device="cpu"):
        yield


def _same(a, b):
    assert a.policy == b.policy
    assert len(a.rings) == len(b.rings)
    assert all(np.array_equal(x, y) for x, y in zip(a.rings, b.rings))
    assert np.array_equal(a.extra_edges, b.extra_edges)
    assert np.array_equal(a.adjacency, b.adjacency)
    assert a.to_json() == b.to_json()


@pytest.mark.parametrize("dist", ["uniform", "gaussian", "fabric", "bitnode"])
@pytest.mark.parametrize("n", [32, 64])
def test_dgro_build_matches_reference(dist, n):
    w = make_latency(dist, n, seed=n)
    for s in (0, 1):
        want = jov.build("dgro", w, rng=np.random.default_rng(s))
        got = tov.build("dgro", w, rng=np.random.default_rng(s))
        _same(want, got)
        assert got.diameter() == want.diameter()
        got._cache.clear()                     # recompute through the engine
        assert got.diameter() == want.diameter()
        assert np.array_equal(got.distances(), want.distances())


@pytest.mark.parametrize("policy", ["chord", "perigee", "rapid", "random"])
def test_adapt_matches_reference(policy):
    w = make_latency("bitnode", 48, seed=4)
    base_j = jov.build(policy, w, seed=2)
    base_t = tov.build(policy, w, seed=2)
    _same(base_j, base_t)
    for seed in (0, 3):
        new_j, kind_j, rho_j = jsel.adapt(base_j, seed=seed)
        new_t, kind_t, rho_t = tsel.adapt(base_t, seed=seed)
        assert (kind_t, rho_t) == (kind_j, rho_j)
        _same(new_j, new_t)
        assert new_t.diameter() == new_j.diameter()


@pytest.mark.parametrize("policy,overrides", [
    ("random", {}), ("nearest", {"k": 2}), ("chord", {"ring": "nearest"}),
    ("rapid", {"k": 3}), ("perigee", {}), ("kleinberg", {}),
    ("papillon", {"k": 3})])
def test_builders_match_reference(policy, overrides):
    w = make_latency("fabric", 40, seed=1)
    _same(jov.build(policy, w, seed=5, **overrides),
          tov.build(policy, w, seed=5, **overrides))


def test_ga_matches_reference():
    w = make_latency("uniform", 16, seed=16)
    want = jov.build("ga", w, JGAConfig(k_rings=2, population=8, budget=24))
    got = tov.build("ga", w, GAConfig(k_rings=2, population=8, budget=24))
    _same(want, got)
    assert got.diameter() == want.diameter()


def test_json_byte_identical_both_ways_and_numpy_state():
    w = make_latency("gaussian", 32, seed=9)
    ref = jov.build("perigee", w, seed=1)
    port = tov.Overlay.from_json(ref.to_json())
    assert port.to_json() == ref.to_json()
    back = jov.Overlay.from_json(port.to_json())
    assert back.equals(ref)
    state = tov.Overlay.from_numpy_state(ref.w, ref.rings, ref.extra_edges,
                                         ref.policy)
    _same(ref, state)
    assert tov.from_topology_json(ref.to_json()).to_json() == ref.to_json()


def test_schema2_payload_names_the_hier_slice():
    payload = '{"kind": "hier_overlay", "schema": 2}'
    with pytest.raises(NotImplementedError, match="hier"):
        tov.from_topology_json(payload)
    with pytest.raises(ValueError, match="schema-2"):
        tov.Overlay.from_json(payload)


def test_registry_holds_this_slice():
    assert set(tov.builders()) == {"random", "nearest", "chord", "rapid",
                                   "perigee", "kleinberg", "papillon",
                                   "dgro", "dgro-dqn", "ga", "parallel"}
    assert set(tov.builders()) == set(jov.builders()) - {"dgro-hier"}
    with pytest.raises(ValueError, match="dgro-hier"):
        tov.build("dgro-hier", make_latency("uniform", 8, seed=0))
