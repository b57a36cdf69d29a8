"""The port's dense LM serving path against the JAX package, on the CPU.

Same numpy inputs and the JAX package's own parameters (carried across by
``convert.params_from_jax``) go through both.  JAX runs as its own tests
run it: Pallas kernels in interpret mode, the model on its plain path.
On the CPU the port's kernel wrappers take their plain versions (K3
``rmsnorm_ref``, K4 ``attention_ref``); the kernels themselves are held to
those on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances, with their reasons:
  * RMSNorm fp32: max |diff| <= 1e-6 (one rsqrt and two products in fp32,
    summed in another order); bf16: at most one bf16 ulp of the value.
  * Flash attention: the JAX kernel tests' own, fp32 2e-5 and bf16 3e-2
    (online against dense softmax).
  * Layers and whole models in fp32: rtol = atol = 1e-4; measured max
    |diff| of the logits is ~2e-6 at smoke width (matmuls summed in another
    order by torch and XLA, and RoPE's cos/sin differing by ulps).
  * Greedy tokens: identical.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.rmsnorm.ops import rmsnorm as jrmsnorm
from repro.models import layers as JL
from repro.models import model as JM

from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch.serve import generate
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

RTOL = ATOL = 1e-4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _cfgs(name, n_layers=None):
    jc, tc = jget_arch(name).smoke(), get_arch(name).smoke()
    if n_layers is not None:
        jc = dataclasses.replace(jc, n_layers=n_layers)
        tc = dataclasses.replace(tc, n_layers=n_layers)
    return jc, tc


# --- configs ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JARCHS))
def test_configs_equal_field_by_field(name):
    assert sorted(ARCHS) == sorted(JARCHS)
    want, got = JARCHS[name], ARCHS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())
    for g, w in ((got, want), (got.smoke(), want.smoke())):
        assert (g.d_inner, g.dt_rank) == (w.d_inner, w.dt_rank)
        assert [(g.is_global_layer(i), g.is_moe_layer(i), g.is_attn_block(i))
                for i in range(12)] == \
            [(w.is_global_layer(i), w.is_moe_layer(i), w.is_attn_block(i))
             for i in range(12)]


# --- K3 RMSNorm (plain version on the CPU) ----------------------------------

def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("rows", [1, 7, 300])
@pytest.mark.parametrize("d", [1, 3, 64, 96, 256, 1150, 1152, 2049])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(rows, d, dtype):
    rng = np.random.default_rng(rows * d)
    x = rng.normal(0, 2, (rows, d)).astype(np.float32)
    s = rng.normal(0, 0.1, (d,)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = rn_ops.rmsnorm(_t(x, tdt), _t(s, tdt)).float().numpy()
    for want in (_np(jrmsnorm(_j(x, jdt), _j(s, jdt), interpret=True)),
                 _np(JL.rms_norm(_j(x, jdt), _j(s, jdt)))):
        err = np.abs(got - want)
        if dtype == "float32":
            assert err.max() <= 1e-6, err.max()
        else:
            assert np.all(err <= _bf16_ulp(want)), err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_variant_choice(dtype):
    """Which K3 variant a shape and an alignment take (decided on the host
    before the launch, so it is checked here on CPU tensors)."""
    epv = 16 // torch.empty((), dtype=dtype).element_size()
    dmax = rn_kernel.D_MAX
    many = rn_kernel.WARP_ROWS
    # the widest row "block" holds: 32 warps of BLOCK_NV vectors a lane
    widest = 32 * rn_kernel.BLOCK_WARPS * rn_kernel.BLOCK_NV * epv

    def pick(rows, d, offset=0, ld=None):
        ld = d if ld is None else ld
        buf = torch.zeros(rows * ld + offset, dtype=dtype)
        s = torch.zeros(d, dtype=dtype)
        assert buf.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0
        x = buf[offset:].view(rows, ld)[:, :d]
        return rn_kernel.variant(x, s)

    assert pick(8192, 1152) == ("warp", -(-1152 // (32 * epv)))
    assert pick(32768, 256) == ("warp", -(-256 // (32 * epv)))
    assert pick(many, epv) == ("warp", 1)
    assert pick(many, dmax) == ("warp", dmax // (32 * epv))
    # few rows, or rows wider than D_MAX: a block of warps a row
    assert pick(3, epv) == ("block", 1)
    # FILL_WARPS over 2111 rows: 5 warps a row
    assert pick(many - 1, dmax) == ("block", -(-dmax // (160 * epv)))
    assert pick(3, dmax) == ("block", 1)
    assert pick(3, dmax + epv) == ("block", 1)
    assert pick(8, 7168) == ("block", -(-7168 // (32 * 32 * epv)))
    assert pick(3, 8192) == ("block", 8192 // (32 * 32 * epv))
    assert pick(8192, 4096) == ("block", 8)
    assert pick(3, widest) == ("block", 8)
    assert pick(3, widest + epv) == ("loop", 0)
    assert pick(3, 1152, offset=1) == ("scalar", 0)
    assert pick(3, 256, ld=301) == ("scalar", 0)
    assert pick(3, 1150) == ("scalar", 0)
    assert pick(3, dmax + 1) == ("scalar", 0)


def test_rmsnorm_any_leading_shape():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 5, 3, 16)).astype(np.float32)
    s = rng.normal(0, 0.1, (16,)).astype(np.float32)
    got = rn_ops.rmsnorm(_t(x), _t(s)).numpy()
    np.testing.assert_allclose(got, _np(JL.rms_norm(_j(x), _j(s))),
                               rtol=0, atol=1e-6)


# --- K4 flash attention (plain version on the CPU) --------------------------

CASES = [
    dict(b=1, hq=2, hkv=2, tq=128, tk=128, d=128, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, tq=256, tk=256, d=64, causal=True, window=None),
    dict(b=1, hq=4, hkv=1, tq=200, tk=200, d=80, causal=True, window=96),
    dict(b=1, hq=2, hkv=2, tq=128, tk=384, d=128, causal=False, window=None),
    dict(b=1, hq=8, hkv=2, tq=64, tk=64, d=32, causal=True, window=32),
    # gemma3-shaped: 4:1 GQA, head_dim 256, a sliding window, ragged T
    dict(b=1, hq=4, hkv=1, tq=200, tk=200, d=256, causal=True, window=64),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_flash_attention_matches_jax(case, dtype, tol):
    rng = np.random.default_rng(0)
    shapes = [(case["b"], case["hq"], case["tq"], case["d"])] + \
        [(case["b"], case["hkv"], case["tk"], case["d"])] * 2
    q, k, v = (rng.normal(0, 1, s).astype(np.float32) for s in shapes)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = fa_ops.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                 causal=case["causal"], window=case["window"])
    want = jflash(_j(q, jdt), _j(k, jdt), _j(v, jdt), causal=case["causal"],
                  window=case["window"], interpret=True)
    assert got.dtype == tdt and tuple(got.shape) == shapes[0]
    err = np.abs(got.float().numpy() - _np(want)).max()
    assert err < tol, (case, dtype, err)


# K4's KV tiles and stages (64 keys) and D buckets (128, 256): the plain
# version against the JAX kernel in interpret mode at the edges of each
RAGGED_CASES = [
    # Tk below, one past one and one past two 64-key stages
    dict(b=1, hq=2, hkv=1, tq=45, tk=45, d=16, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=63, tk=63, d=128, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=65, tk=65, d=16, causal=True, window=None),
    dict(b=1, hq=2, hkv=2, tq=129, tk=129, d=80, causal=True, window=None),
    # windows that end inside a stage, on its edge and one past it
    dict(b=1, hq=2, hkv=2, tq=100, tk=100, d=80, causal=True, window=40),
    dict(b=1, hq=2, hkv=1, tq=130, tk=130, d=32, causal=True, window=64),
    dict(b=1, hq=2, hkv=1, tq=200, tk=200, d=16, causal=True, window=65),
    # D = 200 and 255 (not a multiple of 4: element-by-element loads)
    dict(b=1, hq=1, hkv=1, tq=33, tk=33, d=200, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=65, tk=65, d=255, causal=True, window=None),
    # 8:1 GQA
    dict(b=1, hq=8, hkv=1, tq=70, tk=70, d=64, causal=True, window=None),
    dict(b=1, hq=8, hkv=1, tq=129, tk=129, d=16, causal=True, window=None),
    # Tq < Tk, not causal
    dict(b=2, hq=2, hkv=1, tq=20, tk=97, d=80, causal=False, window=None),
    dict(b=1, hq=2, hkv=1, tq=20, tk=129, d=64, causal=False, window=None),
    # Tq > Tk with a window: rows 23.. see no key (a fully masked row is 0)
    dict(b=1, hq=2, hkv=1, tq=64, tk=16, d=16, causal=True, window=8),
]


@pytest.mark.parametrize("case", RAGGED_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_flash_attention_ragged_stages_match_jax(case):
    rng = np.random.default_rng(case["tq"] * case["d"])
    shapes = [(case["b"], case["hq"], case["tq"], case["d"])] + \
        [(case["b"], case["hkv"], case["tk"], case["d"])] * 2
    q, k, v = (rng.normal(0, 1, s).astype(np.float32) for s in shapes)
    got = fa_ops.flash_attention(_t(q), _t(k), _t(v), causal=case["causal"],
                                 window=case["window"]).numpy()
    want = _np(jflash(_j(q), _j(k), _j(v), causal=case["causal"],
                      window=case["window"], interpret=True))
    assert np.abs(got - want).max() < 2e-5, case
    if case["window"] and case["tq"] > case["tk"] + case["window"]:
        assert not got[:, :, case["tk"] + case["window"]:].any()


# --- layers -----------------------------------------------------------------

def _layer_params(jcfg, tcfg, seed):
    jp = JL.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    # non-zero norms and biases, so that each of them is exercised
    jp = {k: (jnp.asarray(rng.normal(0, 0.2, v.shape).astype(np.float32))
              if k[0] == "b" or k.endswith("norm") else v)
          for k, v in jp.items()}
    return jp, {k: _t(np.asarray(v)) for k, v in jp.items()}


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 37, 3, 256)).astype(np.float32)
    pos = np.arange(1000, 1037, dtype=np.int32)
    got = TL.rope(_t(x), torch.from_numpy(pos), 1e6).numpy()
    want = _np(JL.rope(_j(x), jnp.asarray(pos), 1e6))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["gemma3-1b", "qwen1.5-4b"])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_attention_prefill_matches_jax(name, window, impl):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _layer_params(jcfg, tcfg, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    want, _ = JL.attention_apply(jp, _j(x), jcfg, positions=jnp.asarray(pos),
                                 window=window)
    got, cache = TL.attention_apply(tp, _t(x), tcfg,
                                    positions=torch.from_numpy(pos),
                                    window=window, impl=impl)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [None, 48, 100])
def test_chunked_attention_matches_jax(window):
    """The plain long-prefill path (T > 2048 at the model's own 1024 blocks),
    here at 64-row blocks: windows that start mid-panel and span panels."""
    rng = np.random.default_rng(6)
    q = rng.normal(0, 1, (2, 4, 256, 32)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 2, 256, 32)).astype(np.float32)
            for _ in range(2))
    got = TL._chunked_attention(_t(q), _t(k), _t(v), window=window, bq=64,
                                bk=64)
    want = JL._chunked_attention(_j(q), _j(k), _j(v), window=window, bq=64,
                                 bk=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("cache_pos", [5, 15, 16, 37])
def test_attention_decode_over_rolling_cache_matches_jax(cache_pos):
    """Decode against a window-sized cache (S = window = 16) before, at and
    after it wraps: slot ``pos % S`` and the floor-mod absolute positions."""
    jcfg, tcfg = _cfgs("gemma3-1b")
    jp, tp = _layer_params(jcfg, tcfg, 3)
    rng = np.random.default_rng(cache_pos)
    s = jcfg.sliding_window
    ck = rng.normal(0, 1, (2, jcfg.n_kv_heads, s, jcfg.hd)).astype(np.float32)
    cv = rng.normal(0, 1, ck.shape).astype(np.float32)
    x = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
    want, (jk, jv) = JL.attention_apply(
        jp, _j(x), jcfg, positions=jnp.asarray([cache_pos], jnp.int32),
        window=s, cache=(_j(ck), _j(cv)), cache_pos=jnp.int32(cache_pos))
    tk, tv = _t(ck), _t(cv)
    got, (gk, gv) = TL.attention_apply(
        tp, _t(x), tcfg, positions=torch.tensor([cache_pos]), window=s,
        cache=(tk, tv), cache_pos=cache_pos)
    assert gk is tk and gv is tv                       # written in place
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), _np(jk), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), _np(jv), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_jax(kind):
    jp = JL.init_mlp(jax.random.PRNGKey(4), 64, 128, kind, jnp.float32)
    x = np.random.default_rng(4).normal(0, 1, (2, 9, 64)).astype(np.float32)
    got = TL.mlp_apply({k: _t(np.asarray(v)) for k, v in jp.items()},
                       _t(x), kind).numpy()
    np.testing.assert_allclose(got, _np(JL.mlp_apply(jp, _j(x), kind)),
                               rtol=RTOL, atol=ATOL)


# --- whole model ------------------------------------------------------------

MODELS = [("gemma3-1b", None), ("gemma3-1b", 14), ("qwen1.5-4b", None),
          ("granite-8b", None)]


def _carried(jcfg, tcfg):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")


@pytest.mark.parametrize("name,n_layers", MODELS)
def test_forward_train_prefill_decode_match_jax(name, n_layers):
    """gemma3-1b smoke: 12 layers = 2 scanned blocks; with 14 layers, 2
    blocks + 2 remainder layers; qwen1.5-4b adds QKV bias."""
    jcfg, tcfg = _cfgs(name, n_layers)
    jp, tp = _carried(jcfg, tcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab, size=(2, 24))
    want, _ = JM.forward(jcfg, jp, jnp.asarray(toks), mode="train")
    got, aux = TM.forward(tcfg, tp, torch.from_numpy(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    assert float(aux) == 0.0

    jc = JM.init_caches(jcfg, 2, 40)
    tc = TM.init_caches(tcfg, 2, 40, device="cpu")
    want, jc, _ = JM.forward(jcfg, jp, jnp.asarray(toks), mode="prefill",
                             caches=jc)
    got, tc, _ = TM.forward(tcfg, tp, torch.from_numpy(toks), mode="prefill",
                            caches=tc)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    for i in range(3):
        nxt = rng.integers(1, jcfg.vocab, size=(2, 1))
        want, jc = JM.forward(jcfg, jp, jnp.asarray(nxt), mode="decode",
                              caches=jc, pos=jnp.int32(24 + i))
        got, tc = TM.forward(tcfg, tp, torch.from_numpy(nxt), mode="decode",
                             caches=tc, pos=24 + i)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)
    jflat = convert.flatten(jax.tree.map(np.asarray, jc))
    tflat = convert.flatten(tc)
    assert sorted(jflat) == sorted(tflat)
    for key, val in tflat.items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=RTOL,
                                   atol=ATOL)


def test_forward_impls_agree_and_unported_families_raise():
    jcfg, tcfg = _cfgs("gemma3-1b", 14)
    _, tp = _carried(jcfg, tcfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, 256, (2, 30)))
    a, _ = TM.forward(tcfg, tp, toks, impl="flash")
    b, _ = TM.forward(tcfg, tp, toks, impl="ref")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    # the frontend configs, refused before their port, initialise and run
    # a smoke forward, kernel and plain paths alike, with patch embeddings
    # where the config has a vision frontend
    for name in ("llama4-maverick-400b-a17b", "musicgen-large",
                 "pixtral-12b"):
        cfg = get_arch(name).smoke()
        params = TM.init_params(cfg, device="cpu")
        vis = torch.from_numpy(np.random.default_rng(6).normal(
            0, 1, (2, cfg.n_patches, cfg.d_model)).astype(np.float32)) \
            if cfg.frontend == "vision" else None
        a, _ = TM.forward(cfg, params, toks, impl="flash", vision_embeds=vis)
        b, _ = TM.forward(cfg, params, toks, impl="ref", vision_embeds=vis)
        assert a.shape == (2, 30 + (0 if vis is None else cfg.n_patches),
                           cfg.vocab)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)
    for name in ("falcon-mamba-7b", "zamba2-7b"):
        TM.check_supported(get_arch(name))


def _jax_serve_loop(cfg, params, prompts, max_new, max_len):
    """The loop of the JAX package's ``launch/serve.py`` (greedy)."""
    prefill = jax.jit(lambda p, c, t: JM.forward(cfg, p, t, mode="prefill",
                                                 caches=c))
    decode = jax.jit(lambda p, c, t, pos: JM.forward(
        cfg, p, t, mode="decode", caches=c, pos=pos))
    caches = JM.init_caches(cfg, prompts.shape[0], max_len=max_len)
    logits, caches, _ = prefill(params, caches, jnp.asarray(prompts))
    out = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for i in range(max_new - 1):
        pos = jnp.int32(prompts.shape[1] + i)
        logits, caches = decode(params, caches, out[-1][:, None], pos)
        out.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return np.stack([np.asarray(o) for o in out], axis=1)


def test_generate_greedy_tokens_match_jax_serve_loop():
    """gemma3-1b smoke with a 24-token prompt against its window of 16:
    the local layers' prefill takes the rolling-cache branch."""
    jcfg, tcfg = _cfgs("gemma3-1b", 14)
    jp, tp = _carried(jcfg, tcfg)
    prompts = np.random.default_rng(0).integers(1, jcfg.vocab, size=(3, 24))
    want = _jax_serve_loop(jcfg, jp, prompts, max_new=10, max_len=40)
    got, t = generate(tcfg, tp, prompts, max_new=10, max_len=40)
    assert got.shape == (3, 10) and t["prefill_s"] > 0 and t["decode_s"] > 0
    np.testing.assert_array_equal(got.numpy(), want)


# --- full-width layout, without allocating it -------------------------------

@pytest.mark.parametrize("name", ["gemma3-1b", "qwen1.5-4b"])
def test_full_width_layout_matches_jax(name):
    want = jax.eval_shape(lambda k: JM.init_params(jget_arch(name), k),
                          jax.random.PRNGKey(0))
    want = {n: tuple(s.shape) for n, s in convert.flatten(want).items()}
    got = convert.param_shapes(get_arch(name))
    assert got == want
    meta = TM.init_params(get_arch(name), device="meta")
    assert TM.param_count(meta) == sum(int(np.prod(s)) for s in want.values())
    if name == "gemma3-1b":
        assert TM.param_count(meta) == 999_826_048
        assert "lm_head" not in got                    # tied to embed


def test_params_from_jax_rejects_a_wrong_layout():
    jcfg, tcfg = _cfgs("qwen1.5-4b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tree["rem"] = {"rem0": tree["blocks"]["pos0"]}
    with pytest.raises(ValueError, match="names differ"):
        convert.params_from_jax(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"] = tree["embed"][:, :32]
    with pytest.raises(ValueError, match="shapes differ"):
        convert.params_from_jax(tree, tcfg, device="cpu")
    bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp)
    got = convert.params_from_jax(bf, tcfg, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  bf["embed"].astype(np.float32))


# --- CLI --------------------------------------------------------------------

def _serve(*extra):
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-1b", "--smoke", "--requests", "2", "--prompt-len", "20",
         "--max-new", "4", *extra],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=os.path.join(os.path.dirname(__file__), ".."))


def test_serve_cli_on_cpu_prints_serve_lines():
    out = _serve("--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("[serve]") == 3, out.stdout


def test_serve_cli_without_a_card_raises_the_device_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _serve()
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr, out.stderr[-2000:]
