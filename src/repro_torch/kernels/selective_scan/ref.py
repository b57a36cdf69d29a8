"""Plain PyTorch version of the selective scan, K5's twin: the JAX
package's ``_ssm_scan_chunked`` (``models/mamba.py``).

Chunk by chunk, as the reference, it forms the (B, chunk, d, N) decay and
drive tensors; where the reference combines them with a
``lax.associative_scan``, the steps of a chunk run here one after another.
The sums are then taken in another order than the associative scan's, so
the two agree to rounding, not bitwise.  Autograd runs through it (the
CPU's training path has no kernel to refuse).

``selective_scan_gated_ref`` is the twin of K5's gated mode: the scan,
then Mamba1's two lines after it (the JAX package's ``mamba1_apply``),
``y + D x`` and ``* silu(z)``, in that order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "selective_scan_ref", "selective_scan_gated_ref"]

CHUNK = 128


def selective_scan_ref(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                       chunk: int = CHUNK) -> tuple:
    """``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t`` and
    ``y_t = C_t . h_t`` per (batch, channel).

    dt, x: (B, S, d); bmat, cmat: (B, S, N); a: (d, N); h0: (B, d, N), all
    fp32.  Returns (y (B, S, d), h_last (B, d, N)).  ``chunk`` bounds the
    temporaries only (the last chunk may be shorter).
    """
    h = h0
    ys = []
    for lo in range(0, dt.shape[1], chunk):
        dtq = dt[:, lo:lo + chunk]
        decay = torch.exp(dtq[..., None] * a)              # (B, Q, d, N)
        drive = (dtq * x[:, lo:lo + chunk])[..., None] \
            * bmat[:, lo:lo + chunk, None, :]
        hs = []
        for t in range(dtq.shape[1]):
            h = decay[:, t] * h + drive[:, t]
            hs.append(h)
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1),
                               cmat[:, lo:lo + chunk]))
    return torch.cat(ys, dim=1), h


def selective_scan_gated_ref(dt: torch.Tensor, x: torch.Tensor,
                             bmat: torch.Tensor, cmat: torch.Tensor,
                             a: torch.Tensor, h0: torch.Tensor,
                             dskip: torch.Tensor, z: torch.Tensor,
                             chunk: int = CHUNK) -> tuple:
    """``selective_scan_ref``, then ``(y + dskip * x) * silu(z)``.

    dskip: (d,); z: (B, S, d), fp32.  Returns (out (B, S, d), h_last
    (B, d, N)).
    """
    y, h = selective_scan_ref(dt, x, bmat, cmat, a, h0, chunk)
    y = y + dskip * x
    return y * F.silu(z), h
