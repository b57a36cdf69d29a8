"""Plain PyTorch version of the selective scan, K5's twin: the JAX
package's ``_ssm_scan_chunked`` (``models/mamba.py``).

Chunk by chunk, as the reference, it forms the (B, chunk, d, N) decay and
drive tensors; where the reference combines them with a
``lax.associative_scan``, the steps of a chunk run here one after another.
The sums are then taken in another order than the associative scan's, so
the two agree to rounding, not bitwise.

``selective_scan_bwd_ref`` is K5b's twin: the scan's backward (and the
gate's) as an explicit reverse recurrence, chunk by chunk from the states
at chunk boundaries, not a call to ``torch.autograd``.

``selective_scan_gated_ref`` is the twin of K5's gated mode: the scan,
then Mamba1's two lines after it (the JAX package's ``mamba1_apply``),
``y + D x`` and ``* silu(z)``, in that order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "selective_scan_ref", "selective_scan_gated_ref",
           "selective_scan_bwd_ref"]

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


def selective_scan_bwd_ref(dt: torch.Tensor, x: torch.Tensor,
                           bmat: torch.Tensor, cmat: torch.Tensor,
                           a: torch.Tensor, h0: torch.Tensor,
                           dout: torch.Tensor, dh_last=None, dskip=None,
                           z=None, chunk: int = CHUNK) -> tuple:
    """The gradients of ``selective_scan_ref`` (given ``dskip`` and ``z``,
    of ``selective_scan_gated_ref``) for the cotangents ``dout`` (B, S, d)
    of its output and ``dh_last`` (B, d, N, None = 0) of its last state.

    With ``g_t`` the gradient of the state h_t and ``dy = dout silu(z)``
    (``dout`` ungated): ``g_S = dh_last + C_S dy_S``, ``g_{t-1} = C_{t-1}
    dy_{t-1} + exp(dt_t A) g_t``; ``d dt_t = sum_n g_t (A exp(dt_t A)
    h_{t-1} + x_t B_t)``, ``dx_t = sum_n g_t dt_t B_t`` (+ D dy_t),
    ``dB_t = sum_c g_t dt_t x_t``, ``dC_t = sum_c dy_t h_t``, ``dA = sum
    g_t dt_t exp(dt_t A) h_{t-1}``, ``dh0 = exp(dt_1 A) g_1``; the gate's
    ``dz = dout (y + D x) silu'(z)`` and ``dD = sum dy x``.  A forward pass
    keeps the state at each chunk boundary; each chunk, last first, is run
    forward again from it and walked in reverse.

    Returns (ddt, dx, dB, dC, dA, dh0), then (dD, dz) when gated.
    """
    bsz, s, d = dt.shape
    gated = z is not None
    starts, h = [], h0
    for lo in range(0, s, chunk):
        starts.append(h)
        dtq = dt[:, lo:lo + chunk]
        decay = torch.exp(dtq[..., None] * a)
        drive = (dtq * x[:, lo:lo + chunk])[..., None] \
            * bmat[:, lo:lo + chunk, None, :]
        for t in range(dtq.shape[1]):
            h = decay[:, t] * h + drive[:, t]
    if gated:
        sig = torch.sigmoid(z)
        dy = dout * (z * sig)
    else:
        dy = dout
    g = torch.zeros_like(h0) if dh_last is None else dh_last
    ddt, dx, dbm, dcm, ys = [], [], [], [], []
    da = torch.zeros_like(a)
    for lo, h in zip(reversed(range(0, s, chunk)), reversed(starts)):
        dtq, xq, bq, cq, dyq = (t[:, lo:lo + chunk]
                                for t in (dt, x, bmat, cmat, dy))
        decay = torch.exp(dtq[..., None] * a)              # (B, Q, d, N)
        drive = (dtq * xq)[..., None] * bq[:, :, None, :]
        hs = [h]
        for t in range(dtq.shape[1]):
            hs.append(decay[:, t] * hs[-1] + drive[:, t])
        prev, cur = torch.stack(hs[:-1], 1), torch.stack(hs[1:], 1)
        gs = []
        for t in reversed(range(dtq.shape[1])):
            gt = g + cq[:, t, None, :] * dyq[:, t, :, None]
            gs.append(gt)
            g = decay[:, t] * gt
        gq = torch.stack(gs[::-1], 1)                      # g_t, (B, Q, d, N)
        dprev = decay * prev
        ddt.append((gq * (a * dprev + xq[..., None] * bq[:, :, None, :]))
                   .sum(-1))
        dx.append((gq * bq[:, :, None, :]).sum(-1) * dtq)
        dbm.append(torch.einsum("bqdn,bqd->bqn", gq, dtq * xq))
        dcm.append(torch.einsum("bqdn,bqd->bqn", cur, dyq))
        da = da + (gq * dtq[..., None] * dprev).sum((0, 1))
        if gated:
            ys.append(torch.einsum("bqdn,bqn->bqd", cur, cq))
    out = [torch.cat(v[::-1], 1) for v in (ddt, dx, dbm, dcm)]
    grads = (*out, da, g)
    if not gated:
        return grads
    y = torch.cat(ys[::-1], 1) + dskip * x
    dz = dout * y * (sig * (1 + z * (1 - sig)))
    dxg = grads[1] + dskip * dy
    return (grads[0], dxg, *grads[2:], (dy * x).sum((0, 1)), dz)
