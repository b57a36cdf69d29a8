"""Public selective scan: one K5 launch on CUDA, the plain version on the
CPU (autograd runs through it there).

K5 has no backward kernel yet (K5b, ROADMAP Queue A item 13c′).  So on
CUDA, when grad is enabled and an input requires it, the call raises
rather than run the plain version in the kernel's place; with grad off
(serving, ``no_grad``) it is the plain K5 call."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import selective_scan as _scan_kernel
from .ref import selective_scan_gated_ref, selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref",
           "selective_scan_gated_ref"]


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                   dskip: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None) -> tuple:
    """(y, h_last) of ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``,
    ``y_t = C_t . h_t``; given ``dskip`` (D) and ``z``, y is Mamba1's gated
    ``(y + D x) * silu(z)``.  Shapes as ``ref.selective_scan_gated_ref``."""
    ins = (dt, x, bmat, cmat, a, h0, dskip, z)
    if dt.device.type == "cuda" and torch.is_grad_enabled() \
            and any(t is not None and t.requires_grad for t in ins):
        raise NotImplementedError(
            "selective_scan under autograd on CUDA needs K5b, the backward "
            "of the scan kernel, which is not written yet (ROADMAP Queue A "
            "item 13c′); run it under torch.no_grad()")
    return _scan_kernel(*ins)
