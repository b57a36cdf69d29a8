"""Public selective scan: one K5 launch on CUDA, the plain version on the
CPU.

When grad is enabled and an input requires it, the call is a
``torch.autograd.Function``: K5 saving the state at the start of every
16-step tile, and K5b backward on CUDA; the plain forward and
``ref.selective_scan_bwd_ref`` on the CPU.  Otherwise (serving,
``no_grad``) it is the plain K5 call, output for output the same."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import selective_scan as _scan_kernel
from .kernel import selective_scan_bwd
from .ref import selective_scan_gated_ref, selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref",
           "selective_scan_gated_ref"]


class _SelectiveScan(torch.autograd.Function):
    """K5 forward (saving its tile states), K5b backward."""

    @staticmethod
    def forward(ctx, dt, x, bmat, cmat, a, h0, dskip, z):
        y, h_last, hs = _scan_kernel(dt, x, bmat, cmat, a, h0, dskip, z,
                                     states=True)
        ctx.save_for_backward(dt, x, bmat, cmat, a, h0, hs, dskip, z)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        dt, x, bmat, cmat, a, h0, hs, dskip, z = ctx.saved_tensors
        dout = torch.zeros_like(dt) if dout is None else dout.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        grads = selective_scan_bwd(dt, x, bmat, cmat, a, h0, hs, dout,
                                   dh_last, dskip, z)
        if z is None:
            grads = (*grads, None, None)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                   dskip: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None) -> tuple:
    """(y, h_last) of ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``,
    ``y_t = C_t . h_t``; given ``dskip`` (D) and ``z``, y is Mamba1's gated
    ``(y + D x) * silu(z)``.  Shapes as ``ref.selective_scan_gated_ref``."""
    ins = (dt, x, bmat, cmat, a, h0, dskip, z)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ins):
        return _SelectiveScan.apply(*ins)
    return _scan_kernel(*ins)
