"""Plain PyTorch version of flash attention: dense masked softmax in fp32,
the JAX package's ``kernels/flash_attention/ref.py`` in the same layout."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D) -> (B, Hq, Tq, D) in q's
    dtype.  Query head h reads KV head ``h // (Hq // Hkv)``.  ``q_offset``
    places the queries at absolute positions [q_offset, q_offset + Tq)
    against keys at [0, Tk)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    groups = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kr = k.repeat_interleave(groups, dim=1)
    vr = v.repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
    return out.to(q.dtype)
