"""Plain PyTorch versions of the fused RMSNorm and its gradient (mirror
``models.layers``'s ``rms_norm`` and the JAX package's
``kernels/rmsnorm/ref.py``; the gradient is what ``jax.grad`` of it
computes, written out)."""
from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for float64 inputs (the gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                ss=None, n=None) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim, the
    moment in fp32, the result in x's dtype.  With ``ss`` (x's leading
    shape) and ``n``, x holds a block of rows of ``n`` columns whose sums
    of squares are ``ss``: the mean square is ss / n."""
    x32 = x.to(_acc(x))
    if ss is None:
        var = x32.square().mean(-1, keepdim=True)
    else:
        var = ss.to(x32.dtype)[..., None] / n
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(x32.dtype))
    return out.to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6, ss=None, n=None) -> tuple:
    """The gradient of :func:`rmsnorm_ref` for the output gradient ``g``,
    by its formula: with ``r = rsqrt(mean(x^2) + eps)``,
    ``dx = r * (g (1 + s) - x r^2 mean(g (1 + s) x))`` and
    ``dscale = sum over rows of g x r``.  Returns (dx in x's dtype, dscale
    in scale's).  With ``ss`` / ``n`` (a block of each row), r is
    ``rsqrt(ss / n + eps)`` and the statistic is held: returns (dx = r g
    (1 + s), dscale, dss = -r^3 sum(g (1 + s) x) / (2 n), fp32, the
    statistic's gradient from the block's columns)."""
    acc = _acc(x)
    x32, g32 = x.to(acc), g.to(acc)
    d = x.shape[-1]
    gw = g32 * (1.0 + scale.to(acc))
    if ss is None:
        r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
        k = r * r * (gw * x32).mean(-1, keepdim=True)
        dx = r * (gw - x32 * k)
    else:
        r = torch.rsqrt(ss.to(acc)[..., None] / n + eps)
        dx = r * gw
        dss = -0.5 * (r * r * r) * ((gw * x32).sum(-1, keepdim=True) / n)
    dscale = (g32 * x32 * r).reshape(-1, d).sum(0)
    if ss is None:
        return dx.to(x.dtype), dscale.to(scale.dtype)
    return (dx.to(x.dtype), dscale.to(scale.dtype),
            dss[..., 0].to(torch.promote_types(ss.dtype, torch.float32)))
