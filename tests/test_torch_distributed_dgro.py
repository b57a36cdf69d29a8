"""The multi-device DGRO path of the port against the JAX package's, bit
for bit, on the CPU: ``batcheval.diameters_sharded`` (B not a multiple of
the axis), ``batcheval.apsp_rowshard`` (N = 30 padded to 32 over 8) and
``parallel.parallel_ring_shmap`` (M = 4 and 8).

The port runs in 8 gloo ranks spawned once for the module (a ``FileStore``
under ``tmp_path``); an axis of 4 is the second axis of a (2, 4) mesh of
the 8, whose two lines each score the whole batch.  The reference runs
once, in a subprocess with 8 forced host devices, on meshes of 8 and 4
devices (``tests/test_apsp_engine.py``'s pattern), written to an ``.npz``.
A min over the same fp32 sums is exact, so the gate is equality.
"""
import subprocess
import sys

import numpy as np
import pytest

from conftest import subproc_env

from repro_torch.core import batcheval, parallel
from repro_torch.core.construction import random_ring
from repro_torch.core.diameter import INF
from repro_torch.core.topology import make_latency
from repro_torch import distributed as D
from repro_torch.launch.mesh import Mesh

CASES = [(k, method, dtype) for k in (8, 4) for method in (None, "squaring")
         for dtype in (None, "int16", "bfloat16")]
PARTITIONS = (4, 8)
N_RING = 45                       # not a multiple of 4 or 8


def _genomes():
    rng = np.random.default_rng(0)
    return np.stack([[random_ring(rng, 30)] for _ in range(13)])


def _inputs():
    """13 one-ring overlays of 30 nodes (13 is not a multiple of 4 or 8),
    the latency matrix for the partitioned build."""
    w = make_latency("uniform", 30, seed=1)
    adjs = batcheval.adjacency_batch_from_rings(w, _genomes())
    adjs[2, 0, :] = adjs[2, :, 0] = float(INF)      # a split overlay, too
    adjs[2, 0, 0] = 0.0
    return adjs, make_latency("fabric", N_RING, seed=3)


JAX_CODE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from repro.compat import make_mesh
from repro.core import batcheval
from repro.core.parallel import parallel_ring_shmap
from repro.launch.mesh import make_eval_mesh
sys.path.insert(0, "tests")
from test_torch_distributed_dgro import _inputs, CASES, PARTITIONS

adjs, w = _inputs()
out = {}
for k, method, dtype in CASES:
    out[f"d{k}{method}{dtype}"] = batcheval.diameters_sharded(
        adjs, mesh=make_eval_mesh(k), method=method, dtype=dtype)
out["rows"] = np.asarray(batcheval.apsp_rowshard(adjs[0]))
for m in PARTITIONS:
    mesh = make_mesh((m,), ("partitions",), devices=jax.devices()[:m])
    out[f"ring{m}"] = parallel_ring_shmap(w, mesh)
np.savez(sys.argv[1], **out)
print("OK")
"""


def _rank_results(rank, world):
    adjs, w = _inputs()
    out = {"groups_made": []}
    # the default mesh's groups are made by the first call alone
    made, real = [], D.new_group
    D.new_group = lambda ranks, timeout=None: (made.append(ranks)
                                               or real(ranks, timeout))
    try:
        for _ in range(2):
            batcheval.diameters_sharded(adjs, device="cpu")
            batcheval.apsp_rowshard(adjs[0], device="cpu")
            out["groups_made"].append(len(made))
    finally:
        D.new_group = real
    flat = Mesh(np.arange(8), ("batch",))
    lines = Mesh(np.arange(8).reshape(2, 4), ("rep", "batch"))
    for k, method, dtype in CASES:
        mesh = flat if k == 8 else lines
        out[f"d{k}{method}{dtype}"] = batcheval.diameters_sharded(
            adjs, mesh=mesh, method=method, dtype=dtype, device="cpu")
        out[f"report{k}{method}{dtype}"] = batcheval.last_eval_report()
    src = batcheval.RingBlockSource(make_latency("uniform", 30, seed=1),
                                    _genomes())
    out["lazy"] = batcheval.diameters_sharded(src, mesh=flat, device="cpu")
    out["rows"] = batcheval.apsp_rowshard(adjs[0], device="cpu")
    out["rows_default_mesh"] = batcheval.apsp_rowshard(
        adjs[0], mesh=Mesh(np.arange(8), ("rows",)), device="cpu")
    with batcheval.eval_options(device="cpu"):
        for m in PARTITIONS:
            mesh = (Mesh(np.arange(8), ("partitions",)) if m == 8 else
                    Mesh(np.arange(8).reshape(2, 4), ("rep", "partitions")))
            out[f"ring{m}"] = parallel.parallel_ring_shmap(w, mesh)
    out["traffic"] = dict(vars(D.TRAFFIC))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dgro")
    ref = tmp / "ref.npz"
    proc = subprocess.Popen([sys.executable, "-c", JAX_CODE, str(ref)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=subproc_env(), cwd=".")
    try:
        ranks = D.spawn_ranks(_rank_results, 8, timeout=120,
                              workdir=str(tmp))
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "OK" in stdout, stderr[-3000:]
    return dict(np.load(ref)), ranks


@pytest.mark.parametrize("k,method,dtype", CASES)
def test_diameters_sharded_is_bitwise_the_reference(results, k, method,
                                                    dtype):
    ref, ranks = results
    key = f"d{k}{method}{dtype}"
    for out in ranks:
        assert out[key].shape == (13,) and out[key].dtype == np.float32
        assert np.array_equal(out[key], ref[key])
        rep = out[f"report{k}{method}{dtype}"]
        assert rep["devices"] == k and rep["b"] == 13


def test_diameters_sharded_takes_a_lazy_block_source(results):
    """The port's widening: a ``RingBlockSource`` over the mesh scores as
    the streaming facade does, each rank assembling only its rows."""
    _, ranks = results
    want = batcheval.diameters(batcheval.RingBlockSource(
        make_latency("uniform", 30, seed=1), _genomes()), device="cpu")
    for out in ranks:
        assert np.array_equal(out["lazy"], want)


def test_apsp_rowshard_is_bitwise_the_reference(results):
    ref, ranks = results
    for out in ranks:
        assert out["rows"].shape == (30, 30)
        assert np.array_equal(out["rows_default_mesh"], ref["rows"])
        # with no mesh the eval mesh spans the world: the same 8 ranks
        assert np.array_equal(out["rows"], ref["rows"])
        assert out["traffic"]["bytes_staged"] == 0      # CPU over gloo


def test_default_mesh_makes_its_groups_once(results):
    """Two default-mesh calls in one world: the first makes one group for
    each axis ("batch", "rows"), the second makes none."""
    _, ranks = results
    for out in ranks:
        assert out["groups_made"] == [2, 2]


@pytest.mark.parametrize("m", PARTITIONS)
def test_parallel_ring_shmap_is_bitwise_the_reference(results, m):
    ref, ranks = results
    _, w = _inputs()
    host = parallel.parallel_ring_host(w, m)
    for out in ranks:
        assert np.array_equal(out[f"ring{m}"], ref[f"ring{m}"])
        assert np.array_equal(out[f"ring{m}"], host)


def test_one_rank_is_the_one_device_path():
    """No process group, or a one-rank mesh: today's one-device results."""
    adjs, w = _inputs()
    one = Mesh(np.arange(1), ("batch",))
    want = batcheval.diameters(adjs, device="cpu")
    assert np.array_equal(batcheval.diameters_sharded(adjs, device="cpu"),
                          want)
    assert np.array_equal(
        batcheval.diameters_sharded(adjs, mesh=one, device="cpu"), want)
    rows = batcheval.apsp_rowshard(adjs[0], device="cpu")
    assert np.array_equal(batcheval.apsp_rowshard(
        adjs[0], mesh=Mesh(np.arange(1), ("rows",)), device="cpu"), rows)
    with batcheval.eval_options(device="cpu"):
        ring = parallel.parallel_ring(w, 1)
        assert np.array_equal(parallel.parallel_ring_shmap(
            w, Mesh(np.arange(1), ("partitions",))), ring)
        assert np.array_equal(parallel.parallel_ring_shmap(w, 3),
                              parallel.parallel_ring_host(w, 3))
