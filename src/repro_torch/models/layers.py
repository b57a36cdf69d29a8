"""Shared model layers: RMSNorm, RoPE, GQA attention (train / prefill /
decode), SwiGLU / GELU MLP.  Plain functions over dicts of tensors, the JAX
package's ``models/layers.py`` in the same layout.

Kernels: on a CUDA tensor ``rms_norm`` runs K3 (``kernels.rmsnorm``) and
prefill attention with ``impl="flash"`` runs K4 (``kernels.flash_attention``);
on a CPU tensor both take their plain versions.  ``impl="ref"`` runs the
plain PyTorch versions throughout, on either device (the kernel-vs-plain
check of a whole forward).  Decode attends over the cache with the plain
masked softmax, as the JAX package does.

The window of a local layer is a Python int (the JAX package may trace it;
the port's loop over layers is plain Python).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.rmsnorm.ops import rmsnorm
from ..kernels.rmsnorm.ref import rmsnorm_ref

NEG_INF = -1e30
IMPLS = ("flash", "ref")
CHUNKED_THRESHOLD = 2048


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               dtype, device, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """(lead..., d_in, d_out) normal weights scaled by sqrt(2/(d_in+d_out)),
    drawn in fp32 from ``generator`` (which lives on ``device``).  On the
    ``meta`` device only the shape is made."""
    shape = tuple(lead) + (d_in, d_out)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(generator=generator).mul_((2.0 / (d_in + d_out)) ** 0.5)
    return w.to(dtype)


def zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plain: bool = False) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim: K3 on
    CUDA, its plain version on the CPU or with ``plain``."""
    if plain:
        return rmsnorm_ref(x, scale, eps)
    return rmsnorm(x, scale, eps)


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
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """GQA attention for train / prefill (cache None) and decode (cache
    given).

    Decode: T == 1, the new K/V row is written IN PLACE into the cache at
    ``cache_pos % S`` (rolling for windowed layers where S == window) and
    attention runs over the cache; the cache tensors are returned.
    ``impl``: "flash" = the kernels (K4 for train / prefill attention, K3 for
    the q / k norms) on CUDA; "ref" = the plain versions throughout.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    plain = impl == "ref"
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
        if not plain:
            out = flash_attention(q, k, v, causal=True, window=window)
        elif t > CHUNKED_THRESHOLD and t % 1024 == 0:
            out = _chunked_attention(q, k, v, window=window)
        else:
            kv_valid = positions[None, :].expand(b, t)
            out = _masked_attention(q, k, v, causal_from=positions,
                                    kv_valid=kv_valid, window=window)
        new_cache = None
    else:
        ck, cv = cache                                 # (B, Hkv, S, hd)
        s = ck.shape[2]
        slot = int(cache_pos) % s
        ck[:, :, slot:slot + 1] = k.to(ck.dtype)
        cv[:, :, slot:slot + 1] = v.to(cv.dtype)
        # slot i holds absolute position p = i (mod s), the latest <= cache_pos
        idx = torch.arange(s, device=x.device)
        abs_pos = int(cache_pos) - torch.remainder(int(cache_pos) - idx, s)
        kv_valid = torch.where(abs_pos >= 0, abs_pos, -1)[None, :].expand(b, s)
        out = _masked_attention(q, ck, cv, causal_from=positions,
                                kv_valid=kv_valid, window=window)
        new_cache = (ck, cv)

    out = out.transpose(1, 2).reshape(b, t, hq * hd)
    return out @ p["wo"], new_cache


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


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
