"""Plain PyTorch versions of the fused RMSNorm and its gradient (mirror
``models.layers``'s ``rms_norm`` and the JAX package's
``kernels/rmsnorm/ref.py``; the gradient is what ``jax.grad`` of it
computes, written out)."""
from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for float64 inputs (the gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim, the
    moment in fp32, the result in x's dtype."""
    x32 = x.to(_acc(x))
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(x32.dtype))
    return out.to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6) -> tuple:
    """The gradient of :func:`rmsnorm_ref` for the output gradient ``g``,
    by its formula: with ``r = rsqrt(mean(x^2) + eps)``,
    ``dx = r * (g (1 + s) - x r^2 mean(g (1 + s) x))`` and
    ``dscale = sum over rows of g x r``.  Returns (dx in x's dtype, dscale
    in scale's)."""
    acc = _acc(x)
    x32, g32 = x.to(acc), g.to(acc)
    d = x.shape[-1]
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    gw = g32 * (1.0 + scale.to(acc))
    k = r * r * (gw * x32).mean(-1, keepdim=True)
    dx = r * (gw - x32 * k)
    dscale = (g32 * x32 * r).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
