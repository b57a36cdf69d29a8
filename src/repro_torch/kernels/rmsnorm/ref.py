"""Plain PyTorch version of the fused RMSNorm (mirrors ``models.layers``'s
``rms_norm`` and the JAX package's ``kernels/rmsnorm/ref.py``)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim, the
    moment in fp32, the result in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)
