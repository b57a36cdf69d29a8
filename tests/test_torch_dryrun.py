"""The port's dry run (``repro_torch.launch.dryrun``) and its planned world
(``distributed.planned``) on the CPU.

* Per-rank argument bytes: the port's count of a smoke cell on a (2, 4)
  ("data", "model") mesh equals the reference's
  ``compiled.memory_analysis().argument_size_in_bytes`` of the same cell
  compiled for 8 forced host devices (``tests/test_shardings.py``'s
  ``test_mini_dryrun_8dev`` machinery, in one subprocess a file): a dense
  and a MoE train cell, and a decode cell.  Both hold rank 0's blocks of
  the same specs, so the bytes are equal exactly.
* Planned against real collectives: 4 gloo ranks run a smoke tensor-
  parallel train step and a prefill plus a decode step on real CPU
  tensors under a walk, then count the same steps on meta in a planned
  world; each rank's (op, result bytes, group size) list is the same, and
  so are its GEMM FLOPs and kernel calls.
* ``run_cell`` is ``ok`` for a smoke cell of every family in every kind
  on the production mesh, and ``skipped`` / ``error`` where the
  reference's rules say; the CLI writes one JSON a cell and resumes.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import subproc_env

from repro_torch import distributed as D
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import Mesh

RANKS = 4
# (label, config, shape) of the argument-bytes cells on (2, 4)
MINI = (("dense_train", "gemma3-1b", ("t", 64, 8, "train")),
        ("moe_train", "moonshot-v1-16b-a3b", ("t", 64, 8, "train")),
        ("dense_decode", "qwen1.5-4b", ("d", 64, 8, "decode")))

REF_CODE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
jax.devices()                 # fix the device count before dryrun's import
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as RD
from repro.launch.shardings import (batch_specs, cache_specs, param_specs,
                                    state_specs, to_shardings)
from repro.models import model as JM

mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for label, name, shape in json.loads(sys.argv[1]):
    cfg = get_arch(name).smoke()
    shape = ShapeConfig(*shape)
    specs_in = RD.input_specs(cfg, shape)
    b_shard = to_shardings(batch_specs(specs_in, mesh, ("data",)), mesh)
    if shape.kind == "train":
        st = RD.state_shapes(cfg, jnp.float32)
        st_shard = to_shardings(state_specs(st, mesh, ("data",), zero=True,
                                            mode="tp"), mesh)
        step = RD.make_step(cfg, shape, mesh, ("data",),
                            grad_shardings=st_shard.opt.mu)
        lowered = jax.jit(step, in_shardings=(st_shard, b_shard),
                          donate_argnums=(0,)).lower(st, specs_in)
    else:
        p = jax.eval_shape(lambda: JM.init_params(
            cfg, jax.random.PRNGKey(0), RD.PARAM_DTYPE))
        p_shard = to_shardings(param_specs(p, mesh), mesh)
        c = jax.eval_shape(lambda: JM.init_caches(
            cfg, shape.global_batch, shape.seq_len, RD.PARAM_DTYPE))
        c_shard = to_shardings(cache_specs(c, mesh, shape.global_batch,
                                           ("data",)), mesh)
        step = RD.make_step(cfg, shape, mesh, ("data",))
        lowered = jax.jit(step, in_shardings=(p_shard, c_shard, b_shard),
                          donate_argnums=(1,)).lower(p, c, specs_in)
    mem = lowered.compile().memory_analysis()
    out[label] = int(mem.argument_size_in_bytes)
print("JSON" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    """The reference's argument bytes, computed in a subprocess started
    when the file's first test asks for it and read when needed."""
    proc = subprocess.Popen([sys.executable, "-c", REF_CODE,
                             json.dumps([[a, b, list(c)] for a, b, c
                                         in MINI])],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=subproc_env(), cwd=".")
    box = {}

    def result():
        if "out" not in box:
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("JSON")]
            assert line, stderr[-3000:]
            box["out"] = json.loads(line[-1][4:])
        return box["out"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# planned against real collectives, 4 gloo ranks
# ---------------------------------------------------------------------------

def _meta_like(tree):
    from repro_torch.launch.shardings import tree_map_with_path

    return tree_map_with_path(
        lambda path, t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        tree)


def _summary(costs):
    return {"collectives": [(c.op, c.result_bytes, c.group_size)
                            for c in costs.collectives],
            "dot_flops": costs.dot_flops,
            "kernels": costs.kernel_calls()}


def _train_case(rank, mesh_shape):
    from repro_torch.launch.shardings import local_batch
    from repro_torch.roofline.walk import walk
    from repro_torch.train import train_step as TT

    cfg = get_arch("gemma3-1b").smoke()
    tc = TT.TrainConfig(remat=True)
    out = {}
    for kind in ("real", "planned"):
        mesh = Mesh(np.arange(RANKS).reshape(mesh_shape), ("data", "model"))
        specs = TT.state_layout(cfg, mesh)
        state = TT.init_sharded_state(cfg, specs, mesh, rank,
                                      torch.Generator().manual_seed(0),
                                      device="cpu")
        rng = np.random.default_rng(0)
        batch = local_batch({k: torch.as_tensor(rng.integers(
            0, cfg.vocab, (4, 32))) for k in ("tokens", "labels")}, mesh,
            rank)
        if kind == "real":
            costs = walk(TT.train_step, cfg, tc, state, batch, mesh=mesh,
                         specs=specs)
        else:
            with D.planned(RANKS, rank):
                costs = walk(TT.train_step, cfg, tc, _meta_like(state),
                             _meta_like(batch), mesh=mesh, specs=specs)
        out[kind] = _summary(costs)
    return out


def _serve_case(rank, mesh_shape):
    from repro_torch.launch.serve import greedy
    from repro_torch.launch.shardings import (batch_specs, local_slice,
                                              param_specs, shard_params)
    from repro_torch.models import model as Mdl
    from repro_torch.roofline.walk import walk

    cfg = get_arch("qwen1.5-4b").smoke()
    b, t, max_len = 4, 24, 32
    whole = Mdl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    out = {}
    for kind in ("real", "planned"):
        mesh = Mesh(np.arange(RANKS).reshape(mesh_shape), ("data", "model"))
        params = shard_params(whole, param_specs(whole, mesh), mesh, rank)
        caches = Mdl.init_caches(cfg, b, max_len, torch.float32, "cpu",
                                 mesh=mesh, rank=rank)
        prompts = torch.as_tensor(np.random.default_rng(1).integers(
            1, cfg.vocab, (b, t)))
        spec = batch_specs({"p": prompts}, mesh)["p"]
        mine = local_slice(prompts, spec, mesh, rank)

        def step(params, caches, tokens):
            kw = dict(mesh=mesh, max_len=max_len)
            tp, _ = Mdl.mesh_groups(mesh)
            logits, caches, _ = Mdl.forward(cfg, params, tokens,
                                            mode="prefill", caches=caches,
                                            **kw)
            tok = greedy(cfg, params, logits, tp)
            logits, caches = Mdl.forward(cfg, params, tok[:, None],
                                         mode="decode", caches=caches,
                                         pos=t, **kw)
            return greedy(cfg, params, logits, tp), caches

        if kind == "real":
            costs = walk(step, params, caches, mine)
        else:
            with D.planned(RANKS, rank):
                costs = walk(step, _meta_like(params), _meta_like(caches),
                             _meta_like(mine))
        out[kind] = _summary(costs)
    return out


def _zero3_case(rank):
    """A ZeRO-3 train step and prefill on (2, 2) (parameters split over
    data too, gathered at use) against the tensor-parallel ones from the
    same whole weights, and its planned collectives against its real
    ones."""
    from repro_torch.launch.shardings import (gather_params, local_batch,
                                              param_specs, shard_params,
                                              state_specs, zero3_gather,
                                              zero3_param_specs)
    from repro_torch.models.convert import flatten
    from repro_torch.models import model as Mdl
    from repro_torch.roofline.walk import walk
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import adamw_init

    cfg = get_arch("gemma3-1b").smoke()
    tc = TT.TrainConfig(remat=True)
    mesh = Mesh(np.arange(RANKS).reshape(2, 2), ("data", "model"))
    meta = TT.TrainState(*(lambda p: (p, adamw_init(p)))(
        Mdl.init_params(cfg, device="meta")))
    whole = Mdl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    batch = local_batch({k: torch.as_tensor(rng.integers(
        0, cfg.vocab, (4, 32))) for k in ("tokens", "labels")}, mesh, rank)
    out = {}
    for kind in ("tp", "zero3"):
        specs = state_specs(meta, mesh, ("data",), zero3=kind == "zero3")
        state = TT.init_sharded_state(cfg, specs, mesh, rank,
                                      torch.Generator().manual_seed(0),
                                      device="cpu")
        new, m = TT.train_step(cfg, tc, state, batch, mesh=mesh,
                               specs=specs)
        out[kind] = (float(m["loss"]), float(m["grad_norm"]),
                     gather_params(new.params, specs.params, mesh))
        if kind == "zero3":
            real = walk(TT.train_step, cfg, tc, state, batch, mesh=mesh,
                        specs=specs)
            plan_mesh = Mesh(np.arange(RANKS).reshape(2, 2),
                             ("data", "model"))
            with D.planned(RANKS, rank):
                planned = walk(TT.train_step, cfg, tc, _meta_like(state),
                               _meta_like(batch), mesh=plan_mesh,
                               specs=specs)
    (l0, n0, p0), (l1, n1, p1) = out["tp"], out["zero3"]
    f0, f1 = flatten(p0), flatten(p1)
    worst = max(float((f0[k] - f1[k]).abs().max())
                / max(1.0, float(f0[k].abs().max())) for k in f0)
    # prefill: ZeRO-3 blocks gathered at use against the TP blocks
    tokens = local_batch({"t": torch.as_tensor(np.random.default_rng(1)
                                               .integers(1, cfg.vocab,
                                                         (4, 24)))},
                         mesh, rank)["t"]
    logits = []
    for specs in (param_specs(whole, mesh),
                  zero3_param_specs(whole, mesh, ("data",))):
        caches = Mdl.init_caches(cfg, 4, 32, torch.float32, "cpu",
                                 mesh=mesh, rank=rank)
        logits.append(Mdl.forward(
            cfg, shard_params(whole, specs, mesh, rank), tokens,
            mode="prefill", caches=caches, mesh=mesh, max_len=32,
            gather=zero3_gather(specs, mesh))[0])
    return {"loss": (l0, l1), "grad_norm": (n0, n1), "worst_param": worst,
            "logits": float((logits[0] - logits[1]).abs().max()),
            "max_logit": float(logits[0].abs().max()),
            "real": _summary(real), "planned": _summary(planned)}


POD_MESH = ((2, 2, 1), ("pod", "data", "model"))
POD_SHAPE = ShapeConfig("smoke_train", 64, 32, "train")


def _pod_case(rank):
    """The pod-compressed train step (the int8 ring over pods) on a (pod,
    data) mesh, as ``count_cell`` builds it: whole bf16 parameters and fp32
    moments on every rank, the reference's microbatch rule; its real
    collectives against its planned ones."""
    from repro_torch.models import model as Mdl
    from repro_torch.roofline.walk import walk
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.pod_compress import (pod_compressed_train_step,
                                                shard_batch)

    cfg = get_arch("gemma3-1b").smoke()
    mesh = Mesh(np.arange(RANKS).reshape(POD_MESH[0]), POD_MESH[1])
    tc = TT.TrainConfig(optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1),
                        remat=True, microbatches=DR._microbatches(
                            POD_SHAPE, mesh, ("pod", "data")))
    params = Mdl.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=DR.PARAM_DTYPE)
    state = TT.TrainState(params, adamw_init(params, torch.float32))
    rng = np.random.default_rng(0)
    batch = shard_batch({k: torch.as_tensor(rng.integers(
        0, cfg.vocab, (POD_SHAPE.global_batch, POD_SHAPE.seq_len)),
        dtype=torch.int32) for k in ("tokens", "labels")}, mesh)
    real = walk(pod_compressed_train_step(cfg, tc, mesh), state, batch)
    with D.planned(RANKS, rank):     # a new mesh: its groups planned
        step = pod_compressed_train_step(
            cfg, tc, Mesh(np.arange(RANKS).reshape(POD_MESH[0]), POD_MESH[1]))
        planned = walk(step, _meta_like(state), _meta_like(batch))
    return {"real": _summary(real), "planned": _summary(planned),
            "real_by_op": dict(real.collective_by_op)}


def _reduce_scatter_case(rank):
    """``reduce_scatter`` over a group whose ring order is not its sorted
    numbering, on dims 0 and 1: this member's block of the sum."""
    g = D.new_group([2, 0, 3, 1])
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1)
    y = torch.arange(48, dtype=torch.float32).reshape(3, 8, 2) * (rank + 1)
    return {"index": g.index, "dim0": D.reduce_scatter(x, g).tolist(),
            "dim1": D.reduce_scatter(y, g, dim=1).tolist()}


def collectives_rank(rank, world):
    torch.use_deterministic_algorithms(True)
    return {"train (2, 2)": _train_case(rank, (2, 2)),
            "serve (1, 4)": _serve_case(rank, (1, 4)),
            "serve (2, 2)": _serve_case(rank, (2, 2)),
            "zero3": _zero3_case(rank),
            "pod (2, 2, 1)": _pod_case(rank),
            "reduce_scatter": _reduce_scatter_case(rank)}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    reference                    # start the JAX reference first
    return D.spawn_ranks(collectives_rank, RANKS, timeout=300,
                         workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("case", ["train (2, 2)", "serve (1, 4)",
                                  "serve (2, 2)", "pod (2, 2, 1)"])
@pytest.mark.parametrize("rank", range(RANKS))
def test_planned_collectives_equal_the_real_ones(ranks, case, rank):
    got = ranks[rank][case]
    assert got["real"]["collectives"], "the step ran no collective"
    assert got["planned"] == got["real"]


@pytest.mark.parametrize("rank", range(RANKS))
def test_zero3_step_equals_the_tensor_parallel_one(ranks, rank):
    """ZeRO-3 (the maverick cells' layout): the same loss and grad norm as
    the tensor-parallel step to fp32 rounding (rel 1e-6 / 1e-5), the
    parameters after the step within the AdamW bound of the TP tests (1e-4
    x max(1, max |leaf|)), the same prefill logits (1e-5 x max |logit|),
    and its planned collectives (gathers and reduce-scatters among them)
    equal to the real ones."""
    got = ranks[rank]["zero3"]
    (l0, l1), (n0, n1) = got["loss"], got["grad_norm"]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert abs(n1 - n0) <= 1e-5 * n0
    assert got["worst_param"] <= 1e-4
    assert got["logits"] <= 1e-5 * got["max_logit"]
    ops = {c[0] for c in got["real"]["collectives"]}
    assert {"all-gather", "reduce-scatter"} <= ops
    assert got["planned"] == got["real"]


@pytest.mark.parametrize("rank", range(RANKS))
def test_reduce_scatter_sends_each_member_its_ring_block(ranks, rank):
    """Each member's block is the sum over the 4 ranks (1 + 2 + 3 + 4 = 10
    times rank 0's tensor), cut at its place in the ring."""
    got = ranks[rank]["reduce_scatter"]
    i = got["index"]
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * 10
    y = torch.arange(48, dtype=torch.float32).reshape(3, 8, 2) * 10
    assert i == [2, 0, 3, 1].index(rank)
    assert got["dim0"] == x[i:i + 1].tolist()
    assert got["dim1"] == y[:, 2 * i:2 * i + 2].tolist()


def test_count_cell_plans_the_pod_compressed_step(ranks):
    """``count_cell``'s pod-compressed branch (on a (pod, data) mesh: the
    port's pod compression takes no model axis wider than 1) counts rank
    0's collectives as rank 0's real run sent them: the int8 ring's
    permutes over pods and the data mean's all-reduces."""
    cfg = get_arch("gemma3-1b").smoke()
    mesh = Mesh(np.arange(RANKS).reshape(POD_MESH[0]), POD_MESH[1])
    rec = DR.count_cell(cfg, POD_SHAPE, mesh, ("pod", "data"),
                        pod_compress=True)
    assert rec["status"] == "ok" and rec["pod_compress"]
    by_op = rec["roofline"]["by_op"]
    assert by_op == ranks[0]["pod (2, 2, 1)"]["real_by_op"]
    assert by_op["collective-permute"] > 0 and by_op["all-reduce"] > 0


def test_a_planned_collective_refuses_a_real_tensor():
    with D.planned(4, 1):
        g = D.new_group([0, 1, 2, 3])
        assert g.planned and g.index == 1 and g.pg is None
        assert (D.rank(), D.world_size()) == (1, 4)
        for fn in (D.psum, D.pmax, D.all_gather, D.ppermute):
            with pytest.raises(ValueError, match="planned"):
                fn(torch.zeros(3), g)
        x = torch.empty((2, 3), device="meta")
        assert D.all_gather(x, g).shape == (8, 3)
        assert D.psum(x, g).device.type == "meta"
        assert D.ppermute([x, x], g)[1].shape == (2, 3)
    assert (D.rank(), D.world_size()) == (0, 1)


# ---------------------------------------------------------------------------
# per-rank argument bytes against the reference's compiled cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label,name,shape", MINI,
                         ids=[m[0] for m in MINI])
def test_argument_bytes_equal_the_reference(reference, label, name, shape):
    cfg = get_arch(name).smoke()
    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    rec = DR.count_cell(cfg, ShapeConfig(*shape), mesh, ("data",))
    assert rec["memory"]["argument_bytes"] == reference()[label]
    assert rec["roofline"]["flops"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]


# ---------------------------------------------------------------------------
# run_cell and the CLI
# ---------------------------------------------------------------------------

FAMILIES = ("gemma3-1b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
            "zamba2-7b", "pixtral-12b", "musicgen-large")
KINDS = {"train": ShapeConfig("smoke_train", 64, 32, "train"),
         "prefill": ShapeConfig("smoke_prefill", 64, 32, "prefill"),
         "decode": ShapeConfig("smoke_decode", 64, 32, "decode")}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_counts_a_smoke_cell_of_every_family(arch, kind):
    cfg = get_arch(arch).smoke()
    if cfg.n_experts:        # expert parallel: E divides over model (16)
        cfg = dataclasses.replace(cfg, n_experts=16)
    rec = DR.run_cell(cfg, KINDS[kind], "single")
    assert rec["status"] == "ok", rec
    assert rec["n_chips"] == 256
    roof, mem = rec["roofline"], rec["memory"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert mem["fits_80gb"] and mem["temp_bytes"] >= 0
    assert rec["n_params_active"] <= rec["n_params_total"]
    calls = {k: v["calls"] for k, v in roof["by_kernel"].items()}
    assert calls.get("rmsnorm", 0) > 0
    if kind == "train":
        assert calls.get("rmsnorm_bwd", 0) > 0
        assert mem["alias_bytes"] == 0
    else:
        assert mem["alias_bytes"] > 0      # the caches, written in place
    if kind == "decode" and cfg.family not in ("ssm",):
        assert calls.get("decode_attention", 0) \
            + calls.get("decode_attention_partial", 0) > 0


def test_run_cell_follows_the_reference_rules():
    rec = DR.run_cell("qwen1.5-4b", "long_500k", "multi")
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]
    rec = DR.run_cell("moonshot-v1-16b-a3b", "train_4k", "single",
                      sharding_mode="fsdp")
    assert rec == {**rec, "status": "error",
                   "error": "fsdp mode not wired for shard_map EP archs"}
    with pytest.raises(NotImplementedError, match="fsdp"):
        DR.run_cell("qwen1.5-4b", "decode_32k", "single",
                    sharding_mode="fsdp")
    # the ZeRO-3 arch: its weights gathered over data a layer at a time
    rec = DR.run_cell("llama4-maverick-400b-a17b", "decode_32k", "single")
    assert rec["status"] == "ok" and rec["zero3"]
    assert rec["roofline"]["by_op"]["all-gather"] > 0


def test_cli_writes_a_resumable_json(tmp_path, capsys):
    argv = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)]
    assert DR.main(argv) == 0
    path = tmp_path / "gemma3-1b__decode_32k__single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["memory"]["fits_80gb"]
    assert rec["roofline"]["by_kernel"]["decode_attention_partial"][
        "calls"] == get_arch("gemma3-1b").n_layers
    before = path.stat().st_mtime_ns
    assert DR.main(argv) == 0
    assert "[skip existing]" in capsys.readouterr().out
    assert path.stat().st_mtime_ns == before
    assert DR.main(argv + ["--force", "--tag", "again"]) == 0
    assert (tmp_path / "gemma3-1b__decode_32k__single__again.json").exists()
