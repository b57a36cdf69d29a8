"""Public RMSNorm over the last dim of any shape: leading dims flattened
to rows, one K3 launch on CUDA, the plain version on the CPU.  Unlike the
JAX package's ``ops.rmsnorm`` it pads nothing: K3 takes any row count.

When grad is enabled and ``x`` or ``scale`` requires it, the call is a
``torch.autograd.Function`` whose backward is K3b on CUDA and
``ref.rmsnorm_bwd_ref`` on the CPU; otherwise (serving, ``no_grad``) it
is the plain K3 call, output for output the same."""
from __future__ import annotations

import torch

from .kernel import rmsnorm_rows, rmsnorm_rows_bwd
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref"]


class _RMSNorm(torch.autograd.Function):
    """K3 forward, K3b backward, over (rows, d)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_rows(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_rows_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim."""
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        out = _RMSNorm.apply(rows, scale, eps)
    else:
        out = rmsnorm_rows(rows, scale, eps)
    return out.reshape(shape)
