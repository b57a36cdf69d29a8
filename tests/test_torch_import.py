"""The port's package rules: no jax and nothing of ``repro`` inside
``repro_torch``, latency generators bit-identical to the reference, serde
stamps shared, and the device rule (CUDA unless the caller asks for the
CPU; raise otherwise)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import serde as jserde
from repro.core import topology as jtopology
from repro_torch import serde, resolve_device
from repro_torch.core import batcheval, topology

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.overlay, "
            "repro_torch.core.batcheval, repro_torch.core.selection, "
            "repro_torch.core.ga, repro_torch.kernels.minplus.ops, "
            "repro_torch.configs, repro_torch.models.model, "
            "repro_torch.models.moe, repro_torch.models.mamba, "
            "repro_torch.kernels.selective_scan.ops, "
            "repro_torch.models.convert, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.rmsnorm.ops, "
            "repro_torch.core.embedding, repro_torch.core.rollout, "
            "repro_torch.core.qlearning, repro_torch.core.parallel, "
            "repro_torch.train.optimizer, repro_torch.obs, "
            "repro_torch.obs.logsetup, repro_torch.core.protocols, "
            "repro_torch.membership.gossip, "
            "repro_torch.membership.elastic, repro_torch.dynamics, "
            "repro_torch.routing, repro_torch.hier, repro_torch.service, "
            "repro_torch.service.client, repro_torch.train.train_step, "
            "repro_torch.data.pipeline, repro_torch.checkpoint.checkpoint, "
            "repro_torch.launch.train, repro_torch.distributed, "
            "repro_torch.launch.mesh, repro_torch.train.collectives, "
            "repro_torch.train.pod_compress, repro_torch.models.sharding, "
            "repro_torch.launch.shardings, repro_torch.roofline, "
            "repro_torch.roofline.analysis, repro_torch.roofline.walk, "
            "repro_torch.launch.dryrun; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m == 'repro' or m.startswith('repro.')))")
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300,
                         cwd=PORT.parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_ast_scan_finds_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15, files
    scanned = {str(p.relative_to(PORT)) for p in files}
    for mod in ("models/layers.py", "models/model.py", "models/convert.py",
                "models/moe.py", "models/mamba.py",
                "kernels/selective_scan/kernel.py",
                "kernels/selective_scan/ops.py",
                "kernels/selective_scan/ref.py",
                "launch/serve.py", "configs/base.py", "kernels/_build.py",
                "kernels/flash_attention/kernel.py",
                "kernels/flash_attention/ops.py",
                "kernels/rmsnorm/kernel.py", "kernels/rmsnorm/ops.py",
                "core/embedding.py", "core/rollout.py", "core/qlearning.py",
                "core/parallel.py", "train/optimizer.py", "core/protocols.py",
                "obs/__init__.py", "obs/metrics.py", "obs/tracing.py",
                "obs/logsetup.py", "membership/gossip.py",
                "membership/elastic.py", "dynamics/__init__.py",
                "dynamics/scenarios.py", "dynamics/incremental.py",
                "dynamics/engine.py", "routing/__init__.py",
                "routing/greedy.py", "routing/metrics.py",
                "routing/workload.py", "hier/__init__.py", "hier/geo.py",
                "hier/core.py", "hier/routing.py", "hier/engine.py",
                "service/__init__.py", "service/__main__.py",
                "service/client.py", "service/reoptimizer.py",
                "service/server.py", "service/snapshots.py",
                "service/state.py", "train/train_step.py",
                "data/pipeline.py", "checkpoint/checkpoint.py",
                "launch/train.py", "distributed.py", "launch/mesh.py",
                "train/collectives.py", "train/pod_compress.py",
                "models/sharding.py", "launch/shardings.py",
                "roofline/__init__.py", "roofline/analysis.py",
                "roofline/walk.py", "launch/dryrun.py"):
        assert mod in scanned, mod
    bad = [(str(p.relative_to(PORT)), mod) for p in files
           for mod in _imports(p)
           if mod == "jax" or mod.startswith("jax.")
           or mod == "repro" or mod.startswith("repro.")]
    assert bad == []


@pytest.mark.parametrize("dist", sorted(jtopology.DISTRIBUTIONS))
@pytest.mark.parametrize("n", [17, 64])
def test_latency_generators_bit_identical(dist, n):
    for seed in (0, 7):
        got = topology.make_latency(dist, n, seed=seed)
        want = jtopology.make_latency(dist, n, seed=seed)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


def test_serde_matches_reference():
    payload = {"b": [1, 2], "a": "x"}
    assert serde.dumps(payload) == jserde.dumps(payload)
    assert serde.dumps(payload, schema=2) == jserde.dumps(payload, schema=2)
    assert (serde.SCHEMA_VERSION, serde.HIER_SCHEMA, serde.MAX_SCHEMA) == \
        (jserde.SCHEMA_VERSION, jserde.HIER_SCHEMA, jserde.MAX_SCHEMA)
    with pytest.raises(serde.SchemaError):
        serde.loads('{"schema": 3}')


def test_device_rule_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    adjs = batcheval.adjacency_batch_from_rings(
        topology.make_latency("uniform", 8, seed=0),
        np.stack([[np.random.default_rng(0).permutation(8)]]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batcheval.diameters(adjs)
    from repro_torch import overlay
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overlay.build("dgro", topology.make_latency("uniform", 16, seed=0))
    assert resolve_device("cpu") == torch.device("cpu")
    assert batcheval.diameters(adjs, device="cpu").shape == (1,)
    with batcheval.eval_options(device="cpu"):
        assert batcheval.diameters(adjs).shape == (1,)
        assert batcheval.last_eval_report()["device"] == "cpu"


def test_new_entry_points_raise_without_cuda(monkeypatch):
    """The deep-Q and partitioned constructors follow the same rule."""
    from repro_torch import overlay
    from repro_torch.core import embedding, parallel, qlearning, rollout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = topology.make_latency("uniform", 12, seed=0)
    calls = [
        lambda: embedding.init_qparams(torch.Generator(), 4, 8),
        lambda: embedding.qparams_from_jax(
            {k: np.zeros(1, np.float32) for k in embedding.THETAS}),
        lambda: rollout.init_buffer(8, 4, 2),
        lambda: qlearning.train_dqn(qlearning.DQNConfig(n=6, epochs=1)),
        lambda: parallel.parallel_ring(w, 3),
        lambda: parallel.parallel_ring_shmap(w, 3),
        lambda: overlay.build("parallel", w),
        lambda: overlay.build("dgro-dqn", w, epochs=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = embedding.init_qparams(torch.Generator(), 16, 64, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qlearning.construct_ring_dqn(params, qlearning.DQNConfig(n=12), w,
                                     np.random.default_rng(0))


def test_device_rule_rejects_other_devices():
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(ValueError):
        with batcheval.eval_options(device="meta"):
            pass


def test_service_daemon_exits_with_the_device_error_without_cuda():
    """``python -m repro_torch.service`` with no CUDA device and no
    ``--device cpu``: a non-zero exit with the device error, before it
    binds a port (CUDA is hidden from the child, whatever the machine)."""
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "repro_torch.service",
                          "--n0", "8", "--port", "0", "--no-reopt"],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=PORT.parents[1])
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr, out.stderr
    assert "device='cpu'" in out.stderr
    assert "SERVING" not in out.stdout
