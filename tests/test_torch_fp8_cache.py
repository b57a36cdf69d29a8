"""The port's fp8 KV cache and the plain twin of its decode attention (K6)
against the JAX package, on the CPU.

The same numpy inputs and the JAX package's own parameters (carried across
by ``convert.params_from_jax``) go through both; fp8 caches are compared
as bytes, the reference's buffer (ml_dtypes float8) viewed as uint8.  On
the CPU ``decode_attention`` takes its plain twin; K6 itself is held to
that twin on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances, with their reasons:
  * The cast to float8_e4m3fn: bitwise (integer arithmetic on the fp32
    bits in the port, XLA's conversion in the reference).
  * The fp8 cache against the fp32 cache, within the port: the
    reference's own bound (``tests/test_models.py``), max |dlogit| < 0.7
    and mean < 0.1 (e4m3 keeps about two significant digits).
  * Port against reference, both on fp8 caches: logits rtol = atol = 1e-4
    (the LM tests'); cache bytes within one e4m3 step (codes differing by
    at most 1: a K/V value a last bit away from a rounding midpoint, since
    the two packages' fp32 products sum in another order).
  * The plain twin against the reference's ``_masked_attention``: rtol =
    atol = 1e-5 (the same fp32 einsums and softmax, summed in another
    order, on scores up to ~10 that exp amplifies; measured ~1.4e-6).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import model as JM

from repro_torch.configs import get_arch
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

RTOL = ATOL = 1e-4
FP8 = torch.float8_e4m3fn
LLAMA4 = "llama4-maverick-400b-a17b"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _codes(t):
    """The uint8 bytes of a port fp8 tensor."""
    return t.contiguous().view(torch.uint8).numpy()


def _jcodes(a):
    """The uint8 bytes of a reference fp8 array."""
    return np.asarray(a).view(np.uint8)


def _carried(name, **kw):
    jcfg = dataclasses.replace(jget_arch(name).smoke(), **kw)
    tcfg = dataclasses.replace(get_arch(name).smoke(), **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jp, tp


# --- the cast ---------------------------------------------------------------

def _sweep():
    """fp32 values around every boundary of e4m3: +-464 and the ulps around
    it, 448 and 480, values far past 448, the subnormals and their
    midpoints, the smallest normal, +-0, infinities, NaN of both signs,
    normals at several scales, and every 4099th fp32 bit pattern."""
    rng = np.random.default_rng(0)
    base = np.array([464, 448, 480, 240, 2.0 ** -6, 2.0 ** -9, 2.0 ** -10,
                     1.5 * 2.0 ** -9, 3 * 2.0 ** -10], np.float32)
    near = (base.view(np.int32)[:, None] + np.arange(-64, 65)[None]) \
        .astype(np.int32).view(np.float32).ravel()
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e4,
                        -1e4, 3.4e38, -3.4e38, 1e-45, -1e-45, 464.0,
                        -464.0, 449.0, 500.0], np.float32)
    scales = [rng.normal(0, s, 20000).astype(np.float32)
              for s in (1e-3, 1.0, 50.0, 600.0)]
    every = np.arange(0, 2 ** 32, 4099, dtype=np.uint64).astype(np.uint32) \
        .view(np.float32)
    return np.concatenate([near, -near, special, *scales, every])


@pytest.mark.parametrize("src", ["fp32", "bf16"])
def test_cast_to_fp8_is_bitwise_the_reference_astype(src):
    x = _sweep()
    jx = jnp.asarray(x) if src == "fp32" else \
        jnp.asarray(x).astype(jnp.bfloat16)
    want = _jcodes(jx.astype(jnp.float8_e4m3fn))
    tx = torch.from_numpy(x.copy())
    if src == "bf16":
        tx = torch.from_numpy(np.asarray(jx).view(np.uint16).copy()) \
            .view(torch.bfloat16)
    got = _codes(TL.to_cache_dtype(tx, FP8))
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, [(float(x[i]), hex(want[i]), hex(got[i]))
                           for i in bad[:8]]
    # past 464 the reference gives NaN with x's sign, not +-448
    at = np.array([464.0, 464.00003, -464.00003, 1e4], np.float32)
    assert list(_codes(TL.to_cache_dtype(torch.from_numpy(at), FP8))) == \
        [0x7E, 0x7F, 0xFF, 0x7F]


def test_fp8_upcast_of_every_code_matches_the_reference():
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jnp.asarray(codes.view(jnp.float8_e4m3fn))
                      .astype(jnp.float32))
    got = torch.from_numpy(codes.copy()).view(FP8).float().numpy()
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got)) and nan.sum() == 2
    assert np.array_equal(want[~nan].view(np.uint32),
                          got[~nan].view(np.uint32))


def test_to_cache_dtype_other_dtypes_and_write_cache():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 3, (2, 3, 5, 4)).astype(np.float32))
    assert torch.equal(TL.to_cache_dtype(x, torch.bfloat16),
                       x.to(torch.bfloat16))
    assert TL.to_cache_dtype(x, torch.float32) is x
    with pytest.raises(ValueError, match="cache dtype"):
        TL.to_cache_dtype(x, torch.float16)
    slots = [6, 1, 3, 0, 2]
    index = (slice(None), slice(None), torch.tensor(slots))
    for dtype in (FP8, torch.bfloat16):
        ck, cv = (torch.zeros((2, 3, 8, 4), dtype=dtype) for _ in range(2))
        TL.write_cache((ck, cv), index, (x, -x))
        for cache, val in ((ck, x), (cv, -x)):
            assert cache.dtype == dtype
            if dtype == FP8:
                want = _jcodes(jnp.asarray(val.numpy())
                               .astype(jnp.float8_e4m3fn))
                np.testing.assert_array_equal(_codes(cache)[:, :, slots],
                                              want)
            else:
                assert torch.equal(cache[:, :, slots], val.to(dtype))
            assert not cache[:, :, [4, 5, 7]].float().any()


# --- whole models on fp8 caches ----------------------------------------------

def test_fp8_cache_decode_close_to_fp32_cache():
    """The reference's ``test_fp8_kv_cache_decode_close`` on the port:
    granite-8b smoke, the same parameters and tokens (the reference's
    ``jax.random`` draws, carried over)."""
    jcfg, tcfg, _, tp = _carried("granite-8b")
    b, s = 2, 24
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(1), (b, s + 2), 0, jcfg.vocab)))
    ref_c = TM.init_caches(tcfg, b, 64, torch.float32, device="cpu")
    f8_c = TM.init_caches(tcfg, b, 64, FP8, device="cpu")
    assert f8_c["blocks"]["pos0"]["k"].dtype == FP8
    lr, ref_c, _ = TM.forward(tcfg, tp, toks[:, :s], mode="prefill",
                              caches=ref_c)
    l8, f8_c, _ = TM.forward(tcfg, tp, toks[:, :s], mode="prefill",
                             caches=f8_c)
    errs = [float((lr - l8).abs().max())]
    for t in range(s, s + 2):
        dr, ref_c = TM.forward(tcfg, tp, toks[:, t:t + 1], mode="decode",
                               caches=ref_c, pos=t)
        d8, f8_c = TM.forward(tcfg, tp, toks[:, t:t + 1], mode="decode",
                              caches=f8_c, pos=t)
        errs.append(float((dr - d8).abs().max()))
    assert errs[0] == 0.0               # prefill does not read the cache
    assert 0.0 < max(errs) < 0.7, errs
    assert float((dr - d8).abs().mean()) < 0.1


def _both_on_fp8(name, prompt, steps, max_len, **kw):
    """Prefill and ``steps`` decode steps of both packages on fp8 caches
    (vision configs with patch embeddings): logits of each, caches after."""
    jcfg, tcfg, jp, tp = _carried(name, **kw)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jcfg.vocab, (2, prompt + steps))
    vis = None
    if jcfg.frontend == "vision":
        vis = rng.normal(0, 1, (2, jcfg.n_patches, jcfg.d_model)) \
            .astype(np.float32)
    n_vis = 0 if vis is None else vis.shape[1]
    jc = JM.init_caches(jcfg, 2, max_len, jnp.float8_e4m3fn)
    tc = TM.init_caches(tcfg, 2, max_len, FP8, device="cpu")
    jl, jc, _ = jax.jit(lambda p, c, t, v: JM.forward(
        jcfg, p, t, mode="prefill", caches=c, vision_embeds=v))(
        jp, jc, jnp.asarray(toks[:, :prompt]),
        None if vis is None else jnp.asarray(vis))
    tl, tc, _ = TM.forward(tcfg, tp, torch.from_numpy(toks[:, :prompt]),
                           mode="prefill", caches=tc,
                           vision_embeds=None if vis is None
                           else torch.from_numpy(vis))
    out = [(_np(jl), tl.numpy())]
    jdec = jax.jit(lambda p, c, t, pos: JM.forward(
        jcfg, p, t, mode="decode", caches=c, pos=pos))
    for i in range(prompt, prompt + steps):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.int32(n_vis + i))
        tl, tc = TM.forward(tcfg, tp, torch.from_numpy(toks[:, i:i + 1]),
                            mode="decode", caches=tc, pos=n_vis + i)
        out.append((_np(jl), tl.numpy()))
    return out, jc, tc


def _caches_within_one_step(jc, tc):
    jflat = convert.flatten(jc)
    tflat = convert.flatten(tc)
    assert sorted(jflat) == sorted(tflat)
    for key, t in tflat.items():
        assert t.dtype == {"float8_e4m3fn": FP8, "bfloat16": torch.bfloat16,
                           "float32": torch.float32}[jflat[key].dtype.name], \
            key
        if t.dtype == FP8:
            a = _codes(t).astype(np.int16)
            b = _jcodes(jflat[key]).astype(np.int16)
            assert np.abs(a - b).max() <= 1, key
            assert (a == b).mean() > 0.99, key
        else:
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(jflat[key], np.float32),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name,prompt,steps,max_len", [
    ("granite-8b", 20, 3, 32),
    ("gemma3-1b", 24, 4, 40),          # local layers roll past window 16
    ("pixtral-12b", 12, 3, 32),
    (LLAMA4, 12, 3, 32),
])
def test_port_and_reference_agree_on_fp8_caches(name, prompt, steps,
                                                max_len):
    out, jc, tc = _both_on_fp8(name, prompt, steps, max_len)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _caches_within_one_step(jc, tc)


def test_zamba2_decodes_on_fp8_caches_with_a_bf16_conv_state():
    """zamba2-7b smoke: the SSM conv state is bf16 after prefill (fp8 is
    for the K/V buffers only), and the reference's decode step hands it
    back in fp32 (its arithmetic's dtype with fp32 weights), as the port's
    tree then carries it; the shared block's K/V are fp8."""
    jcfg, tcfg, _, _ = _carried("zamba2-7b")
    tc = TM.init_caches(tcfg, 2, 24, FP8, device="cpu")
    conv = [c["conv"].dtype for c in tc["blocks"].values()]
    assert conv == [torch.bfloat16] * len(conv)
    assert tc["blocks"]["pos5"]["k"].dtype == FP8
    assert tc["blocks"]["pos0"]["h"].dtype == torch.float32
    out, jc, tc = _both_on_fp8("zamba2-7b", 16, 4, 24)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _caches_within_one_step(jc, tc)
    assert tc["blocks"]["pos0"]["conv"].dtype == torch.float32


def test_init_caches_refuses_other_dtypes():
    tcfg = get_arch("granite-8b").smoke()
    with pytest.raises(ValueError, match="KV cache dtype"):
        TM.init_caches(tcfg, 1, 8, torch.float16, device="cpu")


# --- K6's plain twin ---------------------------------------------------------

def _jax_decode_attention(q, ck, cv, pos, window):
    """The reference's decode read: its ``attention_apply`` decode branch
    after the write, on the given cache."""
    s = ck.shape[2]
    idx = jnp.arange(s)
    abs_pos = pos - ((pos - idx) % s)
    kv_valid = jnp.broadcast_to(jnp.where(abs_pos >= 0, abs_pos, -1)[None],
                                (ck.shape[0], s))
    return JL._masked_attention(q, ck, cv, causal_from=jnp.asarray([pos]),
                                kv_valid=kv_valid, window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 16), (5, 1, 32), (4, 4, 24)])
def test_decode_attention_twin_matches_masked_attention(dtype, window, hq,
                                                        hkv, d):
    """Rolling (S = 16, the window) and global (S = 40) caches at several
    positions: partly written, full, and wrapped past S (a rolling cache
    overwritten, and a global one decoded past its max_len as the
    reference's modular slots allow)."""
    rng = np.random.default_rng(hq * 100 + d)
    s = 16 if window else 40
    b = 3
    q = rng.normal(0, 1, (b, hq, 1, d)).astype(np.float32)
    kv = rng.normal(0, 2, (2, b, hkv, s, d)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jk, jv = (jnp.asarray(a).astype(jdt) for a in kv)
    tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
              for a in (jk, jv))
    if dtype == "float8_e4m3fn":
        tk, tv = (torch.from_numpy(_jcodes(a).copy()).view(FP8)
                  for a in (jk, jv))
        np.testing.assert_array_equal(_codes(tk), _jcodes(jk))
    elif dtype == "bfloat16":
        tk, tv = (torch.from_numpy(np.asarray(a).view(np.uint16).copy())
                  .view(torch.bfloat16) for a in (jk, jv))
    for pos in (0, 5, s - 1, s + 7, 3 * s + 2):
        want = _np(_jax_decode_attention(jnp.asarray(q), jk, jv, pos,
                                         window))
        got = decode_attention_ref(torch.from_numpy(q), tk, tv, pos, window)
        assert got.dtype == torch.float32 and got.shape == (b, hq, 1, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        # the entry points take the twin on the CPU
        for impl in ("flash", "ref"):
            assert torch.equal(da_ops.decode_attention(
                torch.from_numpy(q), tk, tv, pos, window, impl), got)
        assert torch.equal(da_kernel.decode_attention(
            torch.from_numpy(q), tk, tv, pos, window), got)


def test_decode_attention_result_in_q_dtype_and_refusals():
    q = torch.ones((1, 4, 1, 8), dtype=torch.bfloat16)
    k = torch.ones((1, 2, 6, 8), dtype=torch.bfloat16)
    assert da_ops.decode_attention(q, k, k, 3).dtype == torch.bfloat16
    with pytest.raises(ValueError, match=r"\(B, Hq, 1, D\)"):
        da_kernel.decode_attention(q[:, :, :0], k, k, 3)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        da_kernel.decode_attention(q[:, :3], k, k, 3)
    with pytest.raises(ValueError, match="pos"):
        da_kernel.decode_attention(q, k, k, -1)
    with pytest.raises(ValueError, match="window"):
        da_kernel.decode_attention(q, k, k, 3, 0)


@pytest.mark.parametrize("n_bh,s,sms", [(64, 1312, 132), (64, 8192, 132),
                                         (256, 1312, 132), (8, 512, 132),
                                         (8, 63, 132), (4096, 40, 132),
                                         (1, 1, 132)])
def test_decode_attention_splits_cover_every_slot_once(n_bh, s, sms):
    """K6's split of a cache over the CTAs of a cluster, for each cache
    dtype at pixtral's D: the CTAs' tile spans partition the tiles, the
    tiles cover the S slots with no empty tile, and a split (C > 1) gives
    every CTA at least a tile a warp within one wave of 8 warps an SM."""
    resident = {w: {c: 8 // w * sms // c for c in (1, 2, 4, 8, 16)}
                for w in da_kernel.WARPS}
    for size in (4, 2, 1):
        ts = da_kernel.tile(128, size)
        w, c = da_kernel.launch_shape(n_bh, s, ts, resident)
        span = da_kernel.spans(s, ts, c)
        tiles = -(-s // ts)
        assert tiles * ts >= s > (tiles - 1) * ts     # no empty tile
        assert [lo for lo, _ in span[1:]] == [hi for _, hi in span[:-1]]
        assert span[0][0] == 0 and span[-1][1] == tiles
        assert c == 1 or (min(hi - lo for lo, hi in span) >= w
                          and n_bh * c * w <= 8 * sms)