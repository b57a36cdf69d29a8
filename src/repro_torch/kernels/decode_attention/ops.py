"""Public decode attention: one query position against a KV cache, K6 on
CUDA (``impl="flash"``), the plain version on the CPU or with
``impl="ref"``; the result in q's dtype, as the JAX package's
``_masked_attention`` gives it."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import decode_attention as _decode_kernel
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, window: Optional[int] = None,
                     impl: str = "flash") -> torch.Tensor:
    """q (B, Hq, 1, D) at position ``pos`` against k / v (B, Hkv, S, D):
    (B, Hq, 1, D) in q's dtype, the math in fp32 whatever the cache's."""
    attend = decode_attention_ref if impl == "ref" else _decode_kernel
    return attend(q, k, v, pos, window).to(q.dtype)
