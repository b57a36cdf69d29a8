"""Public RMSNorm over the last dim of any shape: leading dims flattened
to rows, one K3 launch on CUDA, the plain version on the CPU.  Unlike the
JAX package's ``ops.rmsnorm`` it pads nothing: K3 takes any row count.

When grad is enabled and ``x`` or ``scale`` requires it, the call is a
``torch.autograd.Function`` whose backward is K3b on CUDA and
``ref.rmsnorm_bwd_ref`` on the CPU; otherwise (serving, ``no_grad``) it
is the plain K3 call, output for output the same.  ``ss`` / ``n`` normalise
a block of each row (a row split across ranks) by the whole row's sum of
squares: K3 / K3b's ``rmsnorm_ext`` / ``rmsnorm_bwd_ext``."""
from __future__ import annotations

import torch

from .kernel import rmsnorm_rows, rmsnorm_rows_bwd
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref"]


class _RMSNorm(torch.autograd.Function):
    """K3 forward, K3b backward, over (rows, d); with ``ss`` / ``n`` a
    block of rows split by columns, the statistic's gradient returned for
    ``ss``."""

    @staticmethod
    def forward(ctx, x, scale, eps, ss, n):
        ctx.save_for_backward(x, scale, ss)
        ctx.eps, ctx.n = eps, n
        return rmsnorm_rows(x, scale, eps, ss, n)

    @staticmethod
    def backward(ctx, g):
        x, scale, ss = ctx.saved_tensors
        if ss is None:
            dx, dscale = rmsnorm_rows_bwd(x, scale, g, ctx.eps)
            return dx, dscale, None, None, None
        dx, dscale, dss = rmsnorm_rows_bwd(x, scale, g, ctx.eps, ss, ctx.n)
        return dx, dscale, None, dss, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            ss=None, n=None) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim.
    With ``ss`` (x's leading shape, fp32) and ``n``, x is a block of rows of
    ``n`` columns whose sums of squares are ``ss`` (the ranks' partial sums,
    summed): the mean square is ss / n, and the gradient reaches ``ss``."""
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    ssr = None if ss is None else ss.reshape(-1).contiguous()
    if torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad
            or (ssr is not None and ssr.requires_grad)):
        out = _RMSNorm.apply(rows, scale, eps, ssr, n)
    else:
        out = rmsnorm_rows(rows, scale, eps, ssr, n)
    return out.reshape(shape)
