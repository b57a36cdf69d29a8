"""Public flash attention with the JAX package's ``ops.flash_attention``
contract: the scale is 1/sqrt of the true D, keys past the true Tk are
masked, and the result has q's shape and dtype.  The JAX wrapper padded T
and D to its tiles and relaunched the kernel with the true KV length; K4
masks ragged T and D itself, so here nothing is padded."""
from __future__ import annotations

import torch

from .kernel import flash_attention as _flash_kernel
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D) -> (B, Hq, Tq, D): one K4
    launch on CUDA, the plain version on the CPU.  ``scale`` None =
    1/sqrt(D)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _flash_kernel(q, k, v, scale=scale, causal=causal, window=window)
