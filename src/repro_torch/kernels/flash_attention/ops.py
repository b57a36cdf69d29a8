"""Public flash attention with the JAX package's ``ops.flash_attention``
contract: the scale is 1/sqrt of the true D, keys past the true Tk are
masked, and the result has q's shape and dtype.  The JAX wrapper padded T
and D to its tiles and relaunched the kernel with the true KV length; K4
masks ragged T and D itself, so here nothing is padded.

When grad is enabled and q, k or v requires it, the call is a
``torch.autograd.Function``: K4 with its log-sum-exp forward, K4b backward
on CUDA (the plain versions on the CPU).  Otherwise (serving, ``no_grad``)
it is the plain K4 call, output for output the same."""
from __future__ import annotations

import torch

from .kernel import flash_attention as _flash_kernel
from .kernel import flash_attention_bwd
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]


class _FlashAttention(torch.autograd.Function):
    """K4 forward (with L), K4b backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        out, lse = _flash_kernel(q, k, v, scale=scale, causal=causal,
                                 window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(scale=scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D) -> (B, Hq, Tq, D): one K4
    launch on CUDA, the plain version on the CPU.  ``scale`` None =
    1/sqrt(D)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale, causal, window)
    return _flash_kernel(q, k, v, scale=scale, causal=causal, window=window)
