"""Shared model layers: RMSNorm, RoPE, GQA attention (train / prefill /
decode), SwiGLU / GELU MLP.  Plain functions over dicts of tensors, the JAX
package's ``models/layers.py`` in the same layout.

Kernels: on a CUDA tensor ``rms_norm`` runs K3 (``kernels.rmsnorm``) and
prefill attention with ``impl="flash"`` runs K4 (``kernels.flash_attention``);
on a CPU tensor both take their plain versions.  Under autograd both are
``torch.autograd.Function``s whose backward is K3b / K4b on CUDA (the
plain backward versions on the CPU).  ``impl="ref"`` runs the plain
PyTorch versions throughout, on either device (the kernel-vs-plain check
of a whole forward or training step).  Decode attends over the cache through
K6 (``kernels.decode_attention``) on CUDA, reading the cache in its stored
dtype, and through the JAX package's plain masked softmax over the cache
widened to fp32 on the CPU or with ``impl="ref"``.

A KV cache is fp32, bf16 or float8_e4m3fn.  Every write into it casts with
:func:`to_cache_dtype`, which gives the JAX package's ``astype`` bytes on
any device and torch version (fp8: round to nearest even, NaN with x's sign
past 464, where a bare ``.to(torch.float8_e4m3fn)`` may saturate to 448).

The window of a local layer is a Python int (the JAX package may trace it;
the port's loop over layers is plain Python).

**Tensor parallelism** (``tp``, the ``distributed.Group`` of a mesh's
model axis).  A rank holds the blocks ``launch.shardings.spec_for_param``
gives it: column-parallel ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up``
(and the qkv biases), row-parallel ``wo`` / ``w_down``, each split only
where its dim divides by the axis (else whole on every rank).  Which ones
are split is read from the blocks themselves: a leaf narrower than its
config width is split.  The residual
stream is replicated; a column-parallel product takes it through
``distributed.copy_to`` and a row-parallel one ends in
``distributed.reduce_from`` (Megatron's conjugate pair), so every rank
holds the whole gradient of every replicated tensor.  Attention runs on a
rank's ``H / m`` query heads (K4 / K4b at the local head count) where the
heads divide; a K / V projection split inside a head (gemma3-1b's one KV
head of 256 columns at a 4-way axis) is gathered over the group first,
and each local query head reads its own KV head.  Where the query heads do
not divide, every rank runs all heads and keeps its columns of the output
for ``wo``.

**Decode over a model group** (:func:`decode_tp`) reads the rank's block of
the KV cache as ``launch.shardings.cache_specs`` lays it out.  Where the
cache is split over KV heads, a rank runs K6 on its KV heads and their
query heads, writes its heads of the new K/V row and multiplies by its rows
of ``wo``.  Where it is split over slots (a KV head count that does not
divide the axis: gemma3-1b's one head), q and the new K/V row are gathered
whole, the rank that holds slot ``pos % S`` writes the row, every rank runs
K6's partial form (``slots``) on all query heads against its slots, and
:func:`merge_partials` merges the ranks' results by their log-sum-exps
before each rank keeps its heads' columns for its rows of ``wo``.  A cache
whose split dim does not divide the axis is whole on every rank (the
specs' fallback): every rank writes and attends over all of it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import distributed as D
from ..configs.base import ArchConfig
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.rmsnorm.ops import rmsnorm
from ..kernels.rmsnorm.ref import rmsnorm_ref

NEG_INF = -1e30
IMPLS = ("flash", "ref")
CHUNKED_THRESHOLD = 2048
CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Draws:
    """A generator for the init functions whose every drawn leaf is handed
    to ``keep`` before the next draw, and replaced by what it returns (a
    rank's block: ``train_step.init_sharded_state`` then holds one whole
    leaf at a time).  The bits are ``generator``'s, as drawn without it."""
    generator: Optional[torch.Generator]
    keep: Callable[[torch.Tensor], torch.Tensor]


def dense_init(generator, d_in: int, d_out: int, dtype, device,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """(lead..., d_in, d_out) normal weights scaled by sqrt(2/(d_in+d_out)),
    drawn in fp32 from ``generator`` (a ``torch.Generator`` on ``device``,
    or :class:`Draws`).  On the ``meta`` device only the shape is made."""
    keep = None
    if isinstance(generator, Draws):
        generator, keep = generator.generator, generator.keep
    shape = tuple(lead) + (d_in, d_out)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(generator=generator).mul_((2.0 / (d_in + d_out)) ** 0.5)
    w = w.to(dtype)
    return w if keep is None else keep(w)


def zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# cache dtypes
# ---------------------------------------------------------------------------

def _e4m3fn_codes(x: torch.Tensor) -> torch.Tensor:
    """The float8_e4m3fn bytes (uint8) of ``x`` as the JAX package's
    ``astype(jnp.float8_e4m3fn)`` gives them, in integer arithmetic on
    x's fp32 bits: round to nearest even; |x| past 464 (what rounds above
    448), infinities and NaN give NaN (0x7f) with x's sign.  Each op is a
    launch on a host-bound decode step, so they are few."""
    bits = x.float().contiguous().view(torch.int32)
    sign = (bits >> 24) & 0x80
    # |x| clamped at 480 (code 127, NaN) keeps the integer sums in range
    mag = (bits & 0x7FFFFFFF).clamp_(max=0x43F00000)
    # |x| >= 2^-6, e4m3's normal range: the fp32 mantissa rounded to 3 bits
    # to nearest even, then the exponent rebiased from 127 to 7
    normal = (((mag >> 20) & 1).add_(mag).add_(0x7FFFF) >> 20).sub_(120 << 3)
    # below 2^-6: multiples of 2^-9 (x 512 is exact), nearest even; 8 is
    # 2^-6, the smallest normal's code
    sub = torch.round(mag.view(torch.float32) * 512.0).to(torch.int32)
    code = torch.where(mag < 0x3C800000, sub, normal).clamp_(max=0x7F)
    return code.bitwise_or_(sign).to(torch.uint8)


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a cache dtype exactly as the JAX package's
    ``astype``: float8_e4m3fn by :func:`_e4m3fn_codes`, fp32 / bf16 by
    ``.to`` (round to nearest even in both packages)."""
    if dtype == torch.float8_e4m3fn:
        return _e4m3fn_codes(x).view(torch.float8_e4m3fn)
    if dtype not in CACHE_DTYPES:
        raise ValueError(f"cache dtype must be one of {CACHE_DTYPES}, got "
                         f"{dtype}")
    return x.to(dtype)


def write_cache(caches: tuple, index: tuple, values: tuple) -> None:
    """``cache[index] = to_cache_dtype(value, cache.dtype)`` in place for
    each cache of ``caches`` (one dtype, K and V) and its value.  fp8
    caches take one cast of the values stacked (half the launches) and are
    written through uint8 views (plain byte copies on any device)."""
    dtype = caches[0].dtype
    if dtype == torch.float8_e4m3fn:
        codes = to_cache_dtype(torch.stack(values), dtype).view(torch.uint8)
        for cache, code in zip(caches, codes):
            cache.view(torch.uint8)[index] = code
    else:
        for cache, value in zip(caches, values):
            cache[index] = to_cache_dtype(value, dtype)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plain: bool = False, ss=None, n=None) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim: K3 on
    CUDA, its plain version on the CPU or with ``plain``.  With ``ss`` /
    ``n``, x is a block of rows of ``n`` columns whose sums of squares are
    ``ss`` (``rmsnorm.ops.rmsnorm``)."""
    if plain:
        return rmsnorm_ref(x, scale, eps, ss, n)
    return rmsnorm(x, scale, eps, ss, n)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., T, H, D), positions: (..., T)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., :, None, None].float() * freq   # (..., T, 1, half)
    cos, sin = torch.cos(angle), torch.sin(angle)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(generator, cfg: ArchConfig, dtype, device,
                   lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(generator, d, cfg.n_heads * hd, dtype, device, lead),
        "wk": dense_init(generator, d, cfg.n_kv_heads * hd, dtype, device,
                         lead),
        "wv": dense_init(generator, d, cfg.n_kv_heads * hd, dtype, device,
                         lead),
        "wo": dense_init(generator, cfg.n_heads * hd, d, dtype, device, lead),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros(lead + (cfg.n_heads * hd,), dtype, device)
        p["bk"] = zeros(lead + (cfg.n_kv_heads * hd,), dtype, device)
        p["bv"] = zeros(lead + (cfg.n_kv_heads * hd,), dtype, device)
    if cfg.qk_norm:
        p["q_norm"] = zeros(lead + (hd,), dtype, device)
        p["k_norm"] = zeros(lead + (hd,), dtype, device)
    return p


def _masked_attention(q, k, v, *, causal_from: torch.Tensor,
                      kv_valid: torch.Tensor, window) -> torch.Tensor:
    """fp32 masked softmax attention.

    q: (B, Hq, Tq, D); k/v: (B, Hkv, Tk, D).
    causal_from: (Tq,) absolute position of each query row.
    kv_valid:    (B, Tk) absolute position of each kv slot, or -1 if unwritten.
    window: None | int.
    """
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    groups = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, groups, tq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale

    qpos = causal_from[:, None]                        # (Tq, 1)
    kpos = kv_valid[:, None, None, :]                  # (B, 1, 1, Tk)
    mask = (kpos >= 0) & (kpos <= qpos[None, None])    # causal + written
    if window is not None:
        mask &= qpos[None, None] - kpos < window
    s = torch.where(mask[:, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, tq, d).to(q.dtype)


def _chunked_attention(q, k, v, *, window, bq: int = 1024,
                       bk: int = 1024) -> torch.Tensor:
    """Memory-bounded causal attention: online softmax over KV panels with
    O(bq*bk) score temporaries, numerically the dense path's.  Each query
    block visits only its static KV extent [lo, hi) (causal frontier,
    sliding window).  q/k/v: (B, H*, T, D), GQA folded as in
    ``_masked_attention``; self-attention at positions [0, T)."""
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, t, d)
    kf, vf = k.float(), v.float()
    bq = min(bq, t)
    if t % bq:
        raise ValueError(f"T={t} is not a multiple of the query block {bq}")
    out_blocks = []
    for qi in range(t // bq):
        q_lo, q_hi = qi * bq, (qi + 1) * bq
        lo = 0 if window is None else max(0, q_lo - (int(window) - 1))
        lo = (lo // bk) * bk
        qb = qf[:, :, :, q_lo:q_hi]                    # (B, hkv, g, bq, D)
        m = torch.full((b, hkv, g, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, bq, d), dtype=torch.float32,
                          device=q.device)
        for k_lo in range(lo, q_hi, bk):
            k_hi = min(k_lo + bk, q_hi)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb,
                             kf[:, :, k_lo:k_hi]) * scale
            qpos = q_lo + torch.arange(bq, device=q.device)[:, None]
            kpos = k_lo + torch.arange(k_hi - k_lo, device=q.device)[None, :]
            mask = kpos <= qpos
            if window is not None:
                mask &= qpos - kpos < int(window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vf[:, :, k_lo:k_hi])
            m = m_new
        out_blocks.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.cat(out_blocks, dim=3)
    return out.reshape(b, hq, t, d).to(q.dtype)


def attention_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                      # (B, T, d)
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,              # (T,) absolute positions
    window: Optional[int] = None,         # None = global
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B,Hkv,S,hd)
    cache_pos: Optional[int] = None,      # decode: write index
    impl: str = "flash",
    tp: Optional[D.Group] = None,         # tensor parallel
    cache_len: Optional[int] = None,      # decode over tp: the cache's slots
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """GQA attention for train / prefill (cache None) and decode (cache
    given).

    Decode: T == 1, the new K/V row is written IN PLACE into the cache at
    ``cache_pos % S`` (rolling for windowed layers where S == window) and
    attention runs over the cache; the cache tensors are returned.
    ``impl``: "flash" = the kernels (K4 for train / prefill attention, K6
    for decode, K3 for the q / k norms) on CUDA; "ref" = the plain versions
    throughout.  ``tp``: this rank's blocks of the weights, tensor-parallel
    over the model group, and in decode this rank's block of the cache of
    ``cache_len`` slots in all (the module docstring).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    plain = impl == "ref"
    if tp is not None:
        if cache is not None:
            return decode_tp(p, x, cfg, positions=positions, window=window,
                             cache=cache, cache_pos=cache_pos,
                             cache_len=cache_len, plain=plain, tp=tp), cache
        return _attention_tp(p, x, cfg, positions=positions, window=window,
                             plain=plain, tp=tp), None
    b, t, _ = x.shape
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, hq, hd)
    k = k.reshape(b, t, hkv, hd)
    v = v.reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, plain)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, plain)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = q.transpose(1, 2)                              # (B, Hq, T, hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is None:
        # train / prefill: self-attention over the block
        out = _self_attention(q, k, v, positions=positions, window=window,
                              plain=plain)
        new_cache = None
    else:
        ck, cv = cache                                 # (B, Hkv, S, hd)
        slot = int(cache_pos) % ck.shape[2]
        index = (slice(None), slice(None), slice(slot, slot + 1))
        write_cache((ck, cv), index, (k, v))
        # slot i holds absolute position p = i (mod S), the latest <= pos:
        # K6 on CUDA, the plain masked softmax on the CPU or with "ref"
        out = decode_attention(q, ck, cv, int(cache_pos), window, impl)
        new_cache = (ck, cv)

    out = out.transpose(1, 2).reshape(b, t, hq * hd)
    return out @ p["wo"], new_cache


def _self_attention(q, k, v, *, positions, window, plain):
    """Causal self-attention of (B, H*, T, D) q / k / v at ``positions``:
    K4 (K4b under autograd) unless ``plain``."""
    b, _, t, _ = q.shape
    if not plain:
        return flash_attention(q, k, v, causal=True, window=window)
    if t > CHUNKED_THRESHOLD and t % 1024 == 0:
        return _chunked_attention(q, k, v, window=window)
    kv_valid = positions[None, :].expand(b, t)
    return _masked_attention(q, k, v, causal_from=positions,
                             kv_valid=kv_valid, window=window)


def _kv_for_heads(k: torch.Tensor, hq: int, h0: int, hl: int) -> torch.Tensor:
    """The KV heads that query heads h0 .. h0 + hl - 1 of ``hq`` read, of the
    whole (B, Hkv, T, D) ``k``, laid out for grouped attention over the hl
    local heads: a run of whole groups, one shared head, or one head per
    query head where the groups straddle the local heads."""
    hkv = k.shape[1]
    g = hq // hkv
    if hl % g == 0:
        return k[:, h0 // g:h0 // g + hl // g]
    if g % hl == 0:
        return k[:, h0 // g:h0 // g + 1]
    idx = torch.div(torch.arange(h0, h0 + hl, device=k.device), g,
                    rounding_mode="floor")
    return k.index_select(1, idx)


def _attention_tp(p, x, cfg: ArchConfig, *, positions, window, plain: bool,
                  tp: D.Group) -> torch.Tensor:
    """Tensor-parallel self-attention of the replicated (B, T, d) ``x``:
    (B, T, d), replicated.  Where the query heads divide by m, a rank runs
    its H / m heads; else every rank runs all heads and keeps its columns
    of the output (or, where ``wo`` is whole, all of them)."""
    b, t, _ = x.shape
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    m, r = tp.size, tp.index
    q_split = p["wq"].shape[-1] != hq * hd
    kv_split = p["wk"].shape[-1] != hkv * hd
    wo_split = p["wo"].shape[-2] != hq * hd
    local_heads = q_split and wo_split and hq % m == 0
    local_kv = local_heads and kv_split and hkv % m == 0
    xc = D.copy_to(x, tp)

    def proj(w, bias, split):
        y = (xc if split else x) @ p[w]
        return y + p[bias] if cfg.qkv_bias else y

    def whole(y, split):
        """A projection's output over every head (gathered if split)."""
        return D.gather_from(y, tp, dim=-1) if split else y

    q = proj("wq", "bq", q_split)
    k = proj("wk", "bk", kv_split)
    v = proj("wv", "bv", kv_split)
    if not local_heads:
        q = whole(q, q_split)
    if not local_kv:
        k, v = whole(k, kv_split), whole(v, kv_split)
    q = q.reshape(b, t, -1, hd)
    k = k.reshape(b, t, -1, hd)
    v = v.reshape(b, t, -1, hd)
    if cfg.qk_norm:
        # a norm applied to one rank's heads has a part of its gradient
        qn, kn = p["q_norm"], p["k_norm"]
        if local_heads:
            qn = D.copy_to(qn, tp)
        if local_kv:
            kn = D.copy_to(kn, tp)
        q = rms_norm(q, qn, cfg.norm_eps, plain)
        k = rms_norm(k, kn, cfg.norm_eps, plain)
    q = rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)

    if local_heads:
        hl = hq // m
        if not local_kv:
            # every rank holds every KV head; its heads use a part of them
            k, v = D.copy_to(k, tp), D.copy_to(v, tp)
            k = _kv_for_heads(k, hq, r * hl, hl)
            v = _kv_for_heads(v, hq, r * hl, hl)
        out = _self_attention(q, k, v, positions=positions, window=window,
                              plain=plain)
        out = out.transpose(1, 2).reshape(b, t, hl * hd)
        return D.reduce_from(out @ p["wo"], tp)
    if wo_split:
        # all heads on every rank, each keeping its columns for its rows
        # of wo: the heads' gradient is summed over the group
        q, k, v = (D.copy_to(y, tp) for y in (q, k, v))
    out = _self_attention(q, k, v, positions=positions, window=window,
                          plain=plain)
    out = out.transpose(1, 2).reshape(b, t, hq * hd)
    if not wo_split:
        return out @ p["wo"]
    c = p["wo"].shape[-2]                 # this rank's rows of wo
    return D.reduce_from(out[..., r * c:(r + 1) * c] @ p["wo"], tp)


def kv_block(cache_k: torch.Tensor, cfg: ArchConfig, cache_len: int,
             tp: D.Group) -> tuple:
    """How this rank's block ``cache_k`` (B, Hkv or Hkv / m, S or S / m,
    hd) of a KV cache of ``cache_len`` slots is laid out by ``cache_specs``:
    (heads, slots), ``heads`` True where it holds its KV heads, ``slots``
    (s0, cache_len) where it holds slots s0 .. s0 + S / m - 1, else None
    (its KV heads, or the whole cache)."""
    if cache_k.shape[1] != cfg.n_kv_heads:
        return True, None
    s_l = cache_k.shape[2]
    if s_l == cache_len:
        return False, None
    if s_l * tp.size != cache_len:
        raise ValueError(f"a KV cache block of {s_l} slots is neither the "
                         f"whole {cache_len} nor its 1 / {tp.size}")
    return False, (tp.index * s_l, cache_len)


def gather_columns(ys: list, tp: D.Group) -> list:
    """Each of ``ys`` (..., n_i), a rank's column block of a product, whole
    over ``tp`` (..., m n_i), in one ``all_gather`` of their
    concatenation.  Each comes back contiguous: a block one column wide
    flattens to a view of stride ``sum(widths)``, which K3 refuses."""
    widths = [y.shape[-1] for y in ys]
    both = D.gather_from(torch.cat(ys, dim=-1), tp, dim=-1)
    parts = both.unflatten(-1, (tp.size, sum(widths))).split(widths, dim=-1)
    return [p.flatten(-2).contiguous() for p in parts]


def merge_partials(out: torch.Tensor, lse: torch.Tensor,
                   group: D.Group) -> torch.Tensor:
    """The whole cache's attention from the ranks' partial results over
    their slots: ``out`` (B, Hq, 1, D) normalised over a rank's slots and
    ``lse`` (B, Hq, 1) its log-sum-exp (-inf where it had no valid slot).
    Each rank's output weighs exp(lse - max lse); the weighted outputs and
    the weights are summed in one all-reduce.  fp32 (B, Hq, 1, D)."""
    top = D.pmax(lse, group)
    w = torch.where(torch.isinf(top), 0.0, torch.exp(lse - top))
    both = D.psum(torch.cat([out * w[..., None], w[..., None]], dim=-1),
                  group)
    den = both[..., -1:]
    return torch.where(den > 0, both[..., :-1] / den, 0.0)


def decode_tp(p, x, cfg: ArchConfig, *, positions, window, cache, cache_pos,
              cache_len: int, plain: bool, tp: D.Group) -> torch.Tensor:
    """One decode step of attention over the model group ``tp``: x (B, 1,
    d) replicated; this rank's blocks of the weights (``spec_for_param``)
    and of the cache (:func:`kv_block`).  Writes the new K/V row into the
    rank's block in place and returns (B, 1, d), replicated."""
    if cache_len is None:
        raise ValueError("decode over a model group needs the cache's "
                         "whole slot count (cache_len)")
    b = x.shape[0]
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    r = tp.index
    ck, cv = cache
    heads, slots = kv_block(ck, cfg, cache_len, tp)
    q_split = p["wq"].shape[-1] != hq * hd
    kv_split = p["wk"].shape[-1] != hkv * hd
    wo_split = p["wo"].shape[-2] != hq * hd
    if heads and not (q_split and kv_split and wo_split):
        raise ValueError("a KV cache split over heads needs wq / wk / wv / "
                         "wo split over the same heads")

    def proj(w, bias):
        y = x @ p[w]
        return y + p[bias] if cfg.qkv_bias else y

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    if not heads:
        # every rank attends with every head: q and the new row whole,
        # the split ones gathered in one collective
        split = [y for y, sp in ((q, q_split), (k, kv_split), (v, kv_split))
                 if sp]
        if split:
            whole = gather_columns(split, tp)
            q = whole.pop(0) if q_split else q
            if kv_split:
                k, v = whole
    q = q.reshape(b, 1, -1, hd)
    k = k.reshape(b, 1, -1, hd)
    v = v.reshape(b, 1, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, plain)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, plain)
    q = rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)
    slot = int(cache_pos) % cache_len
    if slots is not None:
        slot -= slots[0]              # written by the rank that holds it
    if 0 <= slot < ck.shape[2]:
        index = (slice(None), slice(None), slice(slot, slot + 1))
        write_cache((ck, cv), index, (k, v))
    impl = "ref" if plain else "flash"
    if slots is None:
        out = decode_attention(q, ck, cv, int(cache_pos), window, impl)
    else:
        part, lse = decode_attention(q, ck, cv, int(cache_pos), window, impl,
                                     slots=slots)
        out = merge_partials(part, lse, tp).to(q.dtype)
    out = out.transpose(1, 2).reshape(b, 1, -1)
    if heads:
        return D.reduce_from(out @ p["wo"], tp)
    if not wo_split:
        return out @ p["wo"]
    c = p["wo"].shape[-2]                 # this rank's rows of wo
    return D.reduce_from(out[..., r * c:(r + 1) * c] @ p["wo"], tp)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(generator, d: int, f: int, kind: str, dtype, device,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    if kind == "swiglu":
        return {"w_gate": dense_init(generator, d, f, dtype, device, lead),
                "w_up": dense_init(generator, d, f, dtype, device, lead),
                "w_down": dense_init(generator, f, d, dtype, device, lead)}
    return {"w_up": dense_init(generator, d, f, dtype, device, lead),
            "w_down": dense_init(generator, f, d, dtype, device, lead)}


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, kind: str,
              group=None) -> torch.Tensor:
    """SwiGLU or GELU MLP of x.  ``group``: the model group over which this
    rank holds column-parallel ``w_gate`` / ``w_up`` and row-parallel
    ``w_down`` blocks (None: the whole weights)."""
    if group is not None:
        x = D.copy_to(x, group)
    if kind == "swiglu":
        y = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    else:
        # jax.nn.gelu's default is the tanh approximation
        y = F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    return y if group is None else D.reduce_from(y, group)
