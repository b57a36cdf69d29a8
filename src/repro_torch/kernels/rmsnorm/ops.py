"""Public RMSNorm over the last dim of any shape: leading dims flattened
to rows, one K3 launch on CUDA, the plain version on the CPU.  Unlike the
JAX package's ``ops.rmsnorm`` it pads nothing: K3 takes any row count."""
from __future__ import annotations

import torch

from .kernel import rmsnorm_rows
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim."""
    shape = x.shape
    out = rmsnorm_rows(x.reshape(-1, shape[-1]), scale, eps)
    return out.reshape(shape)
