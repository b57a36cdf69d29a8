"""K6 ``decode_attention``'s partial form: a rank's block of slots s0 ..
s0 + S - 1 of a cache of s_all slots (a KV cache split over slots by
``cache_specs``), returning the output over those slots and its
log-sum-exp, merged across ranks by ``models.layers.merge_partials``.

On the CPU the plain version, split into 2 or 4 slot ranges and merged,
and the plain version over the whole cache both compute the function
within 1e-6 x max |want| of its float64 evaluation, for fp32 / bf16 / fp8
caches, full-length and rolled window-sized caches, and ranges with no
valid slot (-inf, zeros).  (Each fp32 form is up to ~8e-7 of the value
from the float64 one at D = 256 over 512 slots, where the scores span
~10: two fp32 forms are held to the float64 one rather than to each
other.)
On the card (marker ``cuda``; skipped here) the kernel's partial form is
held to its plain version and the whole-cache call to the partial form
over (0, S), bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch import distributed as D
from repro_torch.kernels.decode_attention import kernel as da
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models.layers import merge_partials, to_cache_dtype

DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)
IDS = ("fp32", "bf16", "fp8")
# (B, Hq, Hkv, S, D, window, pos): a full-length cache partly written
# (ranges past pos hold no valid slot), written, a window-sized cache
# rolled, a window shorter than the cache, gemma3-1b's global and local
# rank shapes at a 4-way axis
CASES = [
    (2, 4, 1, 24, 16, None, 5),
    (2, 4, 2, 24, 16, None, 23),
    (3, 8, 2, 16, 32, 16, 40),
    (2, 4, 4, 32, 16, 8, 30),
    (1, 4, 1, 1024, 256, None, 1015),
    (1, 4, 1, 512, 256, 512, 1015),
]


def _inputs(case, dtype, seed=0):
    b, hq, hkv, s, d, window, pos = case
    rng = np.random.default_rng(seed + s + d)
    q = torch.from_numpy(rng.normal(0, 1, (b, hq, 1, d)).astype(np.float32))
    k, v = (to_cache_dtype(torch.from_numpy(
        rng.normal(0, 2, (b, hkv, s, d)).astype(np.float32)), dtype)
        for _ in range(2))
    return q, k, v


def _exact(q, k, v, pos, window):
    """The function in float64: a softmax over the valid slots of the whole
    cache, GQA group g reading KV head h // g."""
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    back = torch.remainder(pos - torch.arange(s), s)
    valid = back <= pos
    if window is not None:
        valid &= back < window
    kk = k.double().repeat_interleave(g, 1)
    vv = v.double().repeat_interleave(g, 1)
    sc = (q.double() * kk).sum(-1) / d ** 0.5
    p = torch.softmax(torch.where(valid, sc, -torch.inf), -1)
    return (p[..., None] * vv).sum(2)[:, :, None]


def _merged(parts):
    """The ranks' merge, as ``merge_partials`` computes it over a group."""
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([l for _, l in parts])
    top = lses.max(0).values
    w = torch.where(torch.isinf(top), 0.0, torch.exp(lses - top))
    return (outs * w[..., None]).sum(0) / w.sum(0)[..., None]


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", CASES)
def test_plain_partials_merged_equal_the_whole_cache(case, dtype, ranks):
    b, hq, hkv, s, d, window, pos = case
    q, k, v = _inputs(case, dtype)
    want = decode_attention_ref(q, k, v, pos, window)
    n = s // ranks
    parts = [decode_attention_ref(q, k[:, :, r * n:(r + 1) * n].contiguous(),
                                  v[:, :, r * n:(r + 1) * n].contiguous(),
                                  pos, window, (r * n, s))
             for r in range(ranks)]
    for out, lse in parts:
        assert out.dtype == lse.dtype == torch.float32
        assert out.shape == (b, hq, 1, d) and lse.shape == (b, hq, 1)
    exact = _exact(q, k, v, pos, window)
    bound = 1e-6 * float(exact.abs().max())
    assert float((_merged(parts).double() - exact).abs().max()) <= bound
    assert float((want.double() - exact).abs().max()) <= bound


def test_a_range_with_no_valid_slot_gives_minus_inf_and_zeros():
    """pos 5 of a 24-slot cache: slots 6 .. 23 are unwritten, so ranks 1
    .. 3 of 4 (slots 6 .. 23) hold no valid slot."""
    case = CASES[0]
    q, k, v = _inputs(case, torch.float32)
    for r in range(1, 4):
        out, lse = decode_attention_ref(q, k[:, :, 6 * r:6 * r + 6],
                                        v[:, :, 6 * r:6 * r + 6], 5, None,
                                        (6 * r, 24))
        assert bool(torch.isneginf(lse).all())
        assert not bool(out.any())
    out, lse = decode_attention_ref(q, k[:, :, :6], v[:, :, :6], 5, None,
                                    (0, 24))
    assert bool(torch.isfinite(lse).all())


def test_the_lse_is_the_log_of_the_softmax_denominator():
    case = CASES[1]
    b, hq, hkv, s, d, window, pos = case
    q, k, v = _inputs(case, torch.float32)
    _, lse = decode_attention_ref(q, k, v, pos, window, (0, s))
    # scores by hand, GQA group g reading KV head h // g
    g = hq // hkv
    kk = k.repeat_interleave(g, dim=1)                 # (B, Hq, S, D)
    scores = (q * kk).sum(-1) / d ** 0.5               # (B, Hq, S)
    want = torch.logsumexp(scores, -1, keepdim=True)
    assert torch.allclose(lse, want, rtol=1e-6, atol=1e-6)


def test_the_cpu_wrapper_and_ops_take_the_plain_partial_form():
    case = CASES[2]
    b, hq, hkv, s, d, window, pos = case
    q, k, v = _inputs(case, torch.bfloat16)
    before = dict(da.launches)
    want = decode_attention_ref(q, k[:, :, 8:], v[:, :, 8:], pos, window,
                                (8, s))
    for got in (da.decode_attention(q, k[:, :, 8:], v[:, :, 8:], pos, window,
                                    slots=(8, s)),
                da_ops.decode_attention(q, k[:, :, 8:], v[:, :, 8:], pos,
                                        window, "flash", (8, s)),
                da_ops.decode_attention(q, k[:, :, 8:], v[:, :, 8:], pos,
                                        window, "ref", (8, s))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert da.launches == before       # the CPU runs no kernel


@pytest.mark.parametrize("slots", [(-1, 24), (20, 24), (0, 15)])
def test_the_wrapper_refuses_slots_outside_the_cache(slots):
    q, k, v = _inputs(CASES[0], torch.float32)
    with pytest.raises(ValueError, match="slots"):
        da.decode_attention(q, k[:, :, :16], v[:, :, :16], 5, None,
                            slots=slots)


def test_merge_partials_over_one_rank_is_the_normalised_output():
    """Without a process group ``merge_partials`` acts on a group of one
    rank: the weights are 1 and the output comes back as it is."""
    q, k, v = _inputs(CASES[1], torch.float32)
    out, lse = decode_attention_ref(q, k, v, 23, None, (0, 24))
    got = merge_partials(out, lse, D.as_group(None))
    assert torch.allclose(got, out, rtol=1e-7, atol=0)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_partial_form_matches_its_plain_version(cuda, case, dtype,
                                                       ranks):
    """Each rank's block on the card: the output within 1e-5 x max |want|
    of the plain partial form (fp32 online against dense softmax), the
    log-sum-exp within 1e-5 absolute, -inf where the plain one is; the
    kernel's partials merged within 1e-5 x max |want| of the whole-cache
    plain version; one partial launch a call."""
    b, hq, hkv, s, d, window, pos = case
    q, k, v = (t.to(cuda) for t in _inputs(case, dtype))
    n = s // ranks
    parts = []
    for r in range(ranks):
        kr = k[:, :, r * n:(r + 1) * n].contiguous()
        vr = v[:, :, r * n:(r + 1) * n].contiguous()
        before = da.launches[da.PARTIAL]
        out, lse = da.decode_attention(q, kr, vr, pos, window,
                                       slots=(r * n, s))
        assert da.launches[da.PARTIAL] == before + 1
        w_out, w_lse = decode_attention_ref(q, kr, vr, pos, window,
                                            (r * n, s))
        assert float((out - w_out).abs().max()) <= 1e-5 * max(
            float(w_out.abs().max()), 1e-30)
        assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
        fin = torch.isfinite(w_lse)
        assert float(torch.where(fin, lse - w_lse, 0.0).abs().max()) <= 1e-5
        parts.append((out, lse))
    want = decode_attention_ref(q, k, v, pos, window)
    assert float((_merged(parts) - want).abs().max()) \
        <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_whole_cache_call_is_the_partial_form_over_all_slots(
        cuda, case, dtype):
    """The default call and the partial form over (0, S) run the same
    instructions on the same values: their outputs bitwise equal."""
    b, hq, hkv, s, d, window, pos = case
    q, k, v = (t.to(cuda) for t in _inputs(case, dtype))
    whole = da.decode_attention(q, k, v, pos, window)
    out, _ = da.decode_attention(q, k, v, pos, window, slots=(0, s))
    assert torch.equal(whole, out)
