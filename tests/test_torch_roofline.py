"""The port's roofline (``repro_torch.roofline``: the H100 table,
``ring_transfer``, ``roofline_from``, ``model_flops``,
``active_param_count``, and ``walk``, the counting pass that stands in for
the reference's HLO walk) against the JAX package's ``repro.roofline``, on
the CPU.

The reference's numbers that need JAX come from one subprocess a file
(:data:`REF_CODE`): ``active_param_count`` of all 10 configs at full width
over ``jax.eval_shape`` of their inits, and ``hlo_walk.walk`` of a dense
smoke prefill compiled by XLA.  Exact equality is asserted throughout: the
counts are integers and the FLOPs sums of integers.

What the two walks count differently, with its reason: the port's
``dot_flops`` leaves out attention's two products (QK and PV), which run
inside K4 and are counted under ``by_kernel``, while the reference's
``_masked_attention`` is two XLA dots over every (query, key) pair of the
mask.  The test takes those products off the reference's count from the
shapes: 2 B Hq T S hd each, per layer.  And XLA rewrites one pair of dots:
prefill writes K and V into the cache from ``h @ wk`` and ``h @ wv``
computed again (``_prefill_kv``), and XLA's common-subexpression pass
merges them with attention's own; the port computes them twice, so the
test adds 2 x 2 B T d (Hkv hd) a layer back.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import subproc_env

from repro.roofline.analysis import parse_collectives

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import model as Mdl
from repro_torch.roofline import analysis as A
from repro_torch.roofline.walk import WalkCosts, walk

# the reference's test string (tests/test_roofline.py), copied
HLO = """
ENTRY %main {
  %ar = f32[16,4096]{1,0} all-reduce(%x), channel_id=1, replica_groups=[16,16]<=[256], use_global_device_ids=true
  %ag = bf16[32,1024]{1,0} all-gather(%y), channel_id=2, replica_groups=[4,8]<=[32], dimensions={1}
  %rs = f32[8,128]{1,0} reduce-scatter(%z), channel_id=3, replica_groups=[2,4]<=[8], dimensions={0}
  %cp = bf16[64]{0} collective-permute(%w), channel_id=4, source_target_pairs={{0,1},{1,2}}
  %a2a = f32[16,16]{1,0} all-to-all(%v), channel_id=5, replica_groups={{0,1,2,3}}, dimensions={0}
  %ags = (bf16[8,8]{1,0}, bf16[8,64]{1,0}) all-gather-start(%u), channel_id=6, replica_groups=[1,8]<=[8], dimensions={1}
  %dot = f32[128,128]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""

PREFILL = dict(arch="qwen1.5-4b", batch=2, prompt=32, max_len=48)

REF_CODE = r'''
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS, get_arch
from repro.models import model as JM
from repro.roofline.analysis import active_param_count, model_flops
from repro.roofline.hlo_walk import walk

out = {"configs": {}}
for name in sorted(ARCHS):
    cfg = get_arch(name)
    shapes = jax.eval_shape(
        lambda: JM.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    n = active_param_count(cfg, shapes)
    out["configs"][name] = {
        "total": int(sum(int(l.size) for l in jax.tree.leaves(shapes))),
        "active": int(n), "model_flops": model_flops(cfg, 4096 * 256, n)}

spec = json.loads(sys.argv[1])
cfg = get_arch(spec["arch"]).smoke()
params = JM.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
caches = JM.init_caches(cfg, spec["batch"], spec["max_len"], jnp.float32)
tokens = jnp.zeros((spec["batch"], spec["prompt"]), jnp.int32)

def prefill(p, c, t):
    return JM.forward(cfg, p, t, mode="prefill", caches=c)[:2]

hlo = jax.jit(prefill).lower(params, caches, tokens).compile().as_text()
out["prefill_dot_flops"] = walk(hlo).dot_flops
print("JSON" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref():
    res = subprocess.run([sys.executable, "-c", REF_CODE,
                          json.dumps(PREFILL)], capture_output=True,
                         text=True, env=subproc_env(), cwd=".", timeout=600)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JSON")]
    assert line, res.stderr[-3000:]
    return json.loads(line[-1][4:])


# ---------------------------------------------------------------------------
# the hardware table and the per-op formulas
# ---------------------------------------------------------------------------

def test_h100_table():
    assert A.peak_flops(torch.float32) == 67e12
    assert A.peak_flops(torch.bfloat16) == 989.4e12
    assert (A.HBM_BW, A.HBM_BYTES) == (3.35e12, 80e9)
    assert (A.COLLECTIVE_BW, A.NVLINK_BW) == (50e9, 450e9)
    with pytest.raises(ValueError):
        A.peak_flops(torch.int8)


@pytest.mark.parametrize("op", ["all-reduce", "all-gather",
                                "reduce-scatter", "collective-permute",
                                "all-to-all"])
def test_ring_transfer_equals_the_reference_parser(op):
    colls = [c for c in parse_collectives(HLO) if c.op == op]
    assert colls
    for c in colls:
        assert A.ring_transfer(c.op, c.result_bytes, c.group_size) == \
            c.transfer_bytes


def test_ring_transfer_group_of_one_and_unknown_op():
    for op in A.COLLECTIVE_OPS:
        want = 1 << 20 if op == "collective-permute" else 0.0
        assert A.ring_transfer(op, 1 << 20, 1) == want
    with pytest.raises(ValueError):
        A.ring_transfer("broadcast", 8, 2)


def test_roofline_terms_and_dominant():
    costs = WalkCosts(dot_flops=A.FP32_FLOP_PER_S * 0.25,
                      naive_bytes=A.HBM_BW * 1.5)
    costs.by_kernel["rmsnorm"] = {"calls": 3, "flops": A.FP32_FLOP_PER_S
                                  * 0.25, "bytes": A.HBM_BW * 0.5,
                                  "exps": 0.0}
    costs.collectives.append(A.Collective("all-reduce", 100, 4, 150.0))
    costs.collective_bytes = 150.0
    costs.collective_by_op["all-reduce"] = 150.0
    roof = A.roofline_from(costs, torch.float32)
    assert roof.compute_s == pytest.approx(0.5)
    assert roof.memory_s == pytest.approx(2.0)
    assert roof.collective_s == pytest.approx(150.0 / A.COLLECTIVE_BW)
    assert roof.dominant == "memory"
    assert (roof.n_collectives, roof.collective_raw_bytes) == (1, 100.0)
    # the GEMMs' dtype picks the peak
    bf = A.roofline_from(costs, torch.bfloat16)
    assert bf.compute_s == pytest.approx(roof.flops / A.BF16_FLOP_PER_S)
    costs.collective_bytes = A.COLLECTIVE_BW * 3.0
    assert A.roofline_from(costs, torch.float32).dominant == "collective"


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_walk_counts_a_python_loop(device):
    w = torch.zeros((64, 64), device=device)
    x = torch.zeros((64,), device=device)

    def unrolled(x, w):
        for _ in range(7):
            x = w @ x
        return x

    assert walk(unrolled, x, w).dot_flops == 7 * 2 * 64 * 64


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_walk_counts_nested_loops(device):
    w = torch.zeros((32, 32), device=device)
    x = torch.zeros((32,), device=device)

    def nested(x, w):
        for _ in range(5):
            for _ in range(3):
                x = w @ x
        return x

    assert walk(nested, x, w).dot_flops == 5 * 3 * 2 * 32 * 32


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_walk_products_and_bytes(device):
    a = torch.zeros((3, 8, 16), device=device)
    b = torch.zeros((3, 16, 4), device=device)
    bias = torch.zeros((4,), device=device)

    def fn(a, b, bias):
        y = torch.bmm(a, b)                          # 2 * 3*8*4 * 16
        z = torch.nn.functional.linear(a[0], b[0].T, bias)   # addmm
        return y.sum() + z.sum()

    c = walk(fn, a, b, bias)
    assert c.dot_flops == 2 * 3 * 8 * 4 * 16 + 2 * 8 * 4 * 16
    assert c.naive_bytes > 0
    assert c.argument_bytes == 4 * (3 * 8 * 16 + 3 * 16 * 4 + 4)
    assert c.output_bytes == 4


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_peak_live_bytes_of_a_chain(device):
    x = torch.zeros((1000,), device=device)            # 4,000 B argument

    def chain(x):
        a = x * 2                  # 8,000 live
        b = a + 1                  # 12,000 live: the peak
        del a                      # 8,000
        c = b.view(10, 100) * 3    # 12,000 again (the view holds b)
        del b
        return c.sum()             # 4 B out; c dies with the frame

    got = walk(chain, x)
    assert got.argument_bytes == 4000
    assert got.peak_live_bytes == 12000
    assert (got.output_bytes, got.alias_bytes) == (4, 0)

    def in_place(x):
        return x.add_(1)           # the argument's storage comes back

    got = walk(in_place, x)
    assert (got.output_bytes, got.alias_bytes) == (4000, 4000)


def test_walk_kernel_work_replaces_the_plain_versions_ops():
    """A kernel wrapper's plain version (its CPU branch) is not counted op
    by op: the call reports its ``work`` and the walk of the same call on
    meta gives the same numbers."""
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.rmsnorm.kernel import work

    counts = {}
    for device in ("cpu", "meta"):
        x = torch.zeros((6, 32), device=device)
        s = torch.zeros((32,), device=device)
        counts[device] = walk(lambda x, s: rn.rmsnorm(x, s), x, s)
    cpu, meta = counts["cpu"], counts["meta"]
    assert cpu.by_kernel == meta.by_kernel
    k = cpu.by_kernel["rmsnorm"]
    assert (k["calls"], k["flops"], k["bytes"]) == (1, *work(6, 32)[:2])
    assert cpu.dot_flops == meta.dot_flops == 0
    assert cpu.naive_bytes == meta.naive_bytes


# ---------------------------------------------------------------------------
# against the reference's integers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_active_params_and_model_flops_equal_the_reference(ref, name):
    cfg = get_arch(name)
    params = Mdl.init_params(cfg, device="meta", dtype=torch.bfloat16)
    want = ref["configs"][name]
    assert Mdl.param_count(params) == want["total"]
    n = A.active_param_count(cfg, params)
    assert n == want["active"]
    assert A.model_flops(cfg, 4096 * 256, n) == want["model_flops"]
    if cfg.n_experts:
        assert n < want["total"]


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_prefill_dot_flops_equal_the_reference_walk(ref, device):
    """A dense smoke prefill: the port's GEMM FLOPs (outside K4) equal the
    reference HLO walk's dot FLOPs less attention's QK and PV products,
    on meta and on the CPU alike; K4 is counted once a layer."""
    cfg = get_arch(PREFILL["arch"]).smoke()
    b, t, max_len = PREFILL["batch"], PREFILL["prompt"], PREFILL["max_len"]
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = Mdl.init_params(cfg, gen, device=device)
    caches = Mdl.init_caches(cfg, b, max_len, device=device)
    tokens = torch.zeros((b, t), dtype=torch.int64, device=device)

    def prefill(params, caches, tokens):
        return Mdl.forward(cfg, params, tokens, mode="prefill",
                           caches=caches)[:2]

    got = walk(prefill, params, caches, tokens)
    attention = cfg.n_layers * 2 * (2 * b * cfg.n_heads * t * t * cfg.hd)
    merged = cfg.n_layers * 2 * (2 * b * t * cfg.d_model
                                 * cfg.n_kv_heads * cfg.hd)
    assert got.dot_flops == ref["prefill_dot_flops"] - attention + merged
    assert got.kernel_calls()["flash_attention"] == cfg.n_layers
    assert got.by_kernel["flash_attention"]["flops"] == \
        cfg.n_layers * 4.0 * b * cfg.n_heads * (t * (t + 1) // 2) * cfg.hd
    assert got.alias_bytes == sum(
        c.numel() * c.element_size() for g in caches.values()
        for layer in g.values() for c in layer.values())


def test_meta_and_cpu_walks_of_a_train_step_agree():
    """One smoke train step (dense, remat) counted on meta and on real CPU
    tensors: the same GEMM FLOPs, bytes, kernel calls and work, and the
    same peak of live storages."""
    from repro_torch.train import train_step as TT

    cfg = get_arch("gemma3-1b").smoke()
    tc = TT.TrainConfig(remat=True)
    res = {}
    for device in ("meta", "cpu"):
        gen = torch.Generator().manual_seed(0) if device == "cpu" else None
        state = TT.init_state(cfg, gen, device=device)
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)),
                                    device=device) for k in ("tokens",
                                                            "labels")}
        res[device] = walk(TT.train_step, cfg, tc, state, batch)
    meta, cpu = res["meta"], res["cpu"]
    assert meta.dot_flops == cpu.dot_flops > 0
    assert meta.naive_bytes == cpu.naive_bytes
    assert meta.by_kernel == cpu.by_kernel
    assert meta.argument_bytes == cpu.argument_bytes
    assert meta.peak_live_bytes == cpu.peak_live_bytes
    assert meta.output_bytes == cpu.output_bytes
    assert meta.kernel_calls()["rmsnorm_bwd"] > 0
