"""``repro_torch.launch.mesh`` and ``repro_torch.distributed`` against the
JAX package's ``launch/mesh.py``, on the CPU.

The DGRO host order and the latency model are held bitwise to the
reference in process; the production grids to JAX's device-id grids in one
subprocess with 512 forced host devices; the groups, ring order and
collectives in 4 gloo ranks spawned once for the module (a ``FileStore``
under ``tmp_path``).
"""
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import subproc_env

from repro_torch import distributed as D
from repro_torch.launch import mesh as M

JAX_GRIDS = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import numpy as np
from repro.launch.mesh import make_production_mesh
out = {}
for multi in (False, True):
    for dgro in (False, True):
        m = make_production_mesh(multi_pod=multi, dgro_order=dgro)
        key = f"{int(multi)}{int(dgro)}"
        out["ids" + key] = np.vectorize(lambda d: d.id)(m.devices)
        out["axes" + key] = np.array(m.axis_names)
        if dgro:
            out["diam" + key] = np.float64(m.dgro_report["diameter"])
np.savez(sys.argv[1], **out)
print("OK")
"""


def _rank_groups(rank, world):
    """Groups, ring order and the collectives over a 2 x 2 grid and a
    permuted ring, on one rank."""
    out = {}
    grid = M.Mesh(np.array([[0, 3], [2, 1]]), ("a", "b"))
    out["a"] = grid.group("a").ranks
    out["b"] = grid.group("b").ranks
    out["ab"] = grid.group(("a", "b")).ranks
    out["index_b"] = grid.axis_index("b")
    ring = M.Mesh(np.array([2, 0, 3, 1]), ("ring",))
    g = ring.group("ring")
    x = torch.full((2,), float(rank))
    out["next"] = float(D.ppermute(x, g)[0])          # from the member before
    out["back2"] = float(D.ppermute(x, g, shift=2)[0])
    out["gather"] = D.all_gather(x[None], g)[:, 0].tolist()
    out["sum"] = float(D.psum(x, g)[0])
    out["mean"] = float(D.pmean(x, g)[0])
    # int8 and several tensors in one hop
    q, s = D.ppermute([torch.full((3,), rank, dtype=torch.int8),
                       torch.tensor(rank + 0.5)], g)
    out["int8"] = (q.tolist(), float(s))
    out["gloo_staged"] = g.staged
    try:
        M.make_eval_mesh(2).group("batch")
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    out["eval_world"] = dict(M.make_eval_mesh().shape)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return D.spawn_ranks(_rank_groups, 4, timeout=120,
                         workdir=str(tmp_path_factory.mktemp("mesh")))


@pytest.fixture(scope="module")
def jax_grids(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_ref") / "grids.npz"
    out = subprocess.run([sys.executable, "-c", JAX_GRIDS, str(path)],
                         capture_output=True, text=True, env=subproc_env(),
                         cwd=".", timeout=300)
    assert "OK" in out.stdout, out.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("n,pods,seed", [(32, 2, 0), (32, 2, 1), (8, 1, 0)])
def test_latency_and_host_order_are_bitwise_the_reference(n, pods, seed):
    from repro.launch import mesh as JM

    lat = M.model_dcn_latency(n, n_pods=pods, seed=seed)
    jlat = JM.model_dcn_latency(n, n_pods=pods, seed=seed)
    assert lat.dtype == jlat.dtype and np.array_equal(lat, jlat)
    order, rep = M.dgro_host_order(lat, seed=seed)
    jorder, jrep = JM.dgro_host_order(jlat, seed=seed)
    assert np.array_equal(np.asarray(order), np.asarray(jorder))
    assert rep == jrep


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("dgro", [False, True])
def test_production_grids_are_jax_device_id_grids(jax_grids, multi, dgro):
    m = M.make_production_mesh(multi_pod=multi, dgro_order=dgro)
    key = f"{int(multi)}{int(dgro)}"
    assert np.array_equal(m.ranks, jax_grids["ids" + key])
    assert m.axis_names == tuple(jax_grids["axes" + key])
    assert list(m.shape.values()) == list(m.ranks.shape)
    if dgro:
        assert m.dgro_report["diameter"] == jax_grids["diam" + key]


def test_a_mesh_is_a_plan_without_a_process_group():
    m = M.make_production_mesh(multi_pod=True)
    assert dict(m.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m.axis_index("model") == 0 and m.axis_index("pod") == 0
    assert m.lines("pod").shape == (256, 2)
    assert list(m.lines("pod")[1]) == [1, 257]
    with pytest.raises(ValueError, match="512 ranks"):
        m.group("pod")
    assert dict(M.make_eval_mesh().shape) == {"batch": 1}
    with pytest.raises(ValueError):
        M.Mesh(np.array([0, 0]), ("x",))


def test_groups_are_the_grid_lines_in_order(ranks):
    """Grid [[0, 3], [2, 1]] over ("a", "b"): along "a" the columns
    (0, 2) and (3, 1), along "b" the rows, both axes the row-major grid."""
    for r, out in enumerate(ranks):
        assert out["a"] == ((0, 2) if r in (0, 2) else (3, 1))
        assert out["b"] == ((0, 3) if r in (0, 3) else (2, 1))
        assert out["ab"] == (0, 3, 2, 1)
        assert out["index_b"] == {0: 0, 3: 1, 2: 0, 1: 1}[r]


def test_collectives_follow_the_ring_order(ranks):
    """Ring (2, 0, 3, 1): each rank receives from the member before it,
    ``all_gather`` tiles in ring order, gloo moves CPU tensors unstaged."""
    ring = [2, 0, 3, 1]
    for r, out in enumerate(ranks):
        i = ring.index(r)
        assert out["next"] == ring[(i - 1) % 4]
        assert out["back2"] == ring[(i - 2) % 4]
        assert out["gather"] == [float(x) for x in ring]
        assert out["sum"] == 6.0 and out["mean"] == 1.5
        before = ring[(i - 1) % 4]
        assert out["int8"] == ([before] * 3, before + 0.5)
        assert out["gloo_staged"] is True


def _rank_fails_or_hangs(rank, world, how):
    """Rank 1 raises or sleeps; the others wait in a collective for it."""
    if rank == 1:
        if how == "fail":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(600)
    D.psum(torch.ones(1))


@pytest.mark.parametrize("how", ["fail", "hang"])
def test_a_failed_or_hung_rank_fails_the_spawn_in_time(tmp_path, how):
    """No silent wait: a failing rank fails the call as soon as it exits
    (its peers, stuck in a collective, are killed), well before the
    timeout; a hung one fails it at the timeout."""
    timeout = 100 if how == "fail" else 10
    t0 = time.monotonic()
    err = RuntimeError if how == "fail" else TimeoutError
    with pytest.raises(err, match="failed" if how == "fail"
                       else "did not finish in 10 s"):
        D.spawn_ranks(_rank_fails_or_hangs, 3, args=(how,), timeout=timeout,
                      workdir=str(tmp_path))
    assert time.monotonic() - t0 < timeout + 20


def test_a_mesh_that_is_not_the_world_raises(ranks):
    for out in ranks:
        assert "holds 2 ranks but the process group has 4" in out["mismatch"]
        assert out["eval_world"] == {"batch": 4}
