"""Plain PyTorch version of decode attention: the port's
``models.layers._masked_attention`` (the JAX package's function) over the
cache widened to fp32, with the mask of the slots a rolling or full-length
cache holds at decode position ``pos``."""
from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int, window: Optional[int] = None
                         ) -> torch.Tensor:
    """q (B, Hq, 1, D) at absolute position ``pos``; k / v (B, Hkv, S, D)
    in any float dtype, slot i holding the latest position p <= pos with
    p = i (mod S), unwritten where p < 0.  Returns (B, Hq, 1, D) fp32."""
    from ...models.layers import _masked_attention   # layers imports ops

    b, s = k.shape[0], k.shape[2]
    idx = torch.arange(s, device=k.device)
    abs_pos = pos - torch.remainder(pos - idx, s)
    kv_valid = torch.where(abs_pos >= 0, abs_pos, -1)[None, :].expand(b, s)
    causal_from = torch.tensor([pos], dtype=torch.int32, device=k.device)
    return _masked_attention(q.float(), k.float(), v.float(),
                             causal_from=causal_from, kv_valid=kv_valid,
                             window=window)
