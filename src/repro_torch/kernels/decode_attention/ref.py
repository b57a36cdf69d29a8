"""Plain PyTorch version of decode attention: the port's
``models.layers._masked_attention`` (the JAX package's function) over the
cache widened to fp32, with the mask of the slots a rolling or full-length
cache holds at decode position ``pos``."""
from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int, window: Optional[int] = None,
                         slots: Optional[tuple] = None):
    """q (B, Hq, 1, D) at absolute position ``pos``; k / v (B, Hkv, S, D)
    in any float dtype, slot i holding the latest position p <= pos with
    p = i (mod S), unwritten where p < 0.  Returns (B, Hq, 1, D) fp32.

    With ``slots`` = (s0, s_all), k / v hold slots s0 .. s0 + S - 1 of a
    cache of s_all slots (slot i of them is slot s0 + i of the whole):
    returns (out, lse), the softmax over those slots' valid ones and its
    log-sum-exp (B, Hq, 1), both fp32; -inf and zeros where none is valid.
    Ranks' results merge as exp(lse - max lse) weights."""
    if slots is None:
        from ...models.layers import _masked_attention   # layers imports ops

        b, s = k.shape[0], k.shape[2]
        idx = torch.arange(s, device=k.device)
        abs_pos = pos - torch.remainder(pos - idx, s)
        kv_valid = torch.where(abs_pos >= 0, abs_pos, -1)[None, :].expand(
            b, s)
        causal_from = torch.tensor([pos], dtype=torch.int32,
                                   device=k.device)
        return _masked_attention(q.float(), k.float(), v.float(),
                                 causal_from=causal_from, kv_valid=kv_valid,
                                 window=window)
    s0, s_all = (int(x) for x in slots)
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    idx = s0 + torch.arange(s, device=k.device)
    back = torch.remainder(pos - idx, s_all)           # steps back from pos
    valid = back <= pos
    if window is not None:
        valid &= back < window
    qf = q.float().reshape(b, hkv, hq // hkv, d)
    sc = torch.einsum("bhgd,bhkd->bhgk", qf, k.float()) * (1.0 / d ** 0.5)
    sc = torch.where(valid, sc, -torch.inf)
    m = sc.amax(-1, keepdim=True)                      # -inf: no valid slot
    p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m))
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float()) \
        / torch.where(den > 0, den, 1.0)
    lse = (m + torch.log(den))[..., 0]
    return out.reshape(b, hq, 1, d), lse.reshape(b, hq, 1)
