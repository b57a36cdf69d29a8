"""K5 ``selective_scan``: the hand-written CUDA scan of Mamba1, its binding
and wrapper.

Source ``csrc/selective_scan.cu`` (with its design note), built by the
port's shared builder (``repro_torch.kernels._build``) at first use.  Two
lanes per (batch, channel) split its N <= 16 states and walk the sequence
with them in registers; given Mamba1's D and z it writes the gated output
``(y + D x) * silu(z)`` in place of y.  The wrapper takes the plain
versions (``ref.selective_scan_ref`` / ``ref.selective_scan_gated_ref``)
for CPU tensors and launches the kernel for CUDA tensors -- or raises:
there is no fallback.  It takes contiguous fp32 tensors only, allocates
the outputs and counts launches in :data:`launches`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import KernelFamily
from .ref import selective_scan_gated_ref, selective_scan_ref

__all__ = ["SOURCES", "FAMILY", "N_MAX", "launches", "selective_scan"]

SOURCES = {"selective_scan": "selective_scan.cu"}
N_MAX = 16            # the largest state size the kernel is built for
_P, _I = ctypes.c_void_p, ctypes.c_int
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES,
    {"selective_scan": [_P] * 10 + [_I] * 4 + [_P]})
launches = FAMILY.launches


def _check_shapes(dt, x, bmat, cmat, a, h0, dskip, z) -> None:
    if dt.dim() != 3 or x.shape != dt.shape or bmat.dim() != 3:
        raise ValueError(f"selective_scan needs dt and x (B, S, d), got "
                         f"{tuple(dt.shape)} and {tuple(x.shape)}")
    if (dskip is None) != (z is None):
        raise ValueError("selective_scan's gate needs both D and z")
    bsz, s, d = dt.shape
    n = bmat.shape[2]
    want = {"bmat": (bsz, s, n), "cmat": (bsz, s, n), "a": (d, n),
            "h0": (bsz, d, n)}
    got = {"bmat": bmat, "cmat": cmat, "a": a, "h0": h0}
    if z is not None:
        want |= {"D": (d,), "z": (bsz, s, d)}
        got |= {"D": dskip, "z": z}
    bad = {k: tuple(got[k].shape) for k, v in want.items()
           if tuple(got[k].shape) != v}
    if bad or min(bsz, s, d, n) < 1:
        raise ValueError(f"selective_scan shapes for dt {tuple(dt.shape)} "
                         f"and N={n}: {bad or 'empty'}")


def _check_cuda(dt, **others) -> None:
    """Raise unless K5 takes dt and ``others``: contiguous fp32 on one CUDA
    device, N <= N_MAX, B <= 65535 (the grid's y extent)."""
    for what, t in (("dt", dt), *others.items()):
        if t.device != dt.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"selective_scan runs on contiguous fp32 CUDA "
                             f"tensors on one device; {what} is {t.device} "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dt.device}")
    if others["bmat"].shape[2] > N_MAX or dt.shape[0] > 65535:
        raise ValueError(f"selective_scan supports N <= {N_MAX} and B <= "
                         f"65535, got N={others['bmat'].shape[2]} B="
                         f"{dt.shape[0]}")


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                   dskip: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None) -> tuple:
    """K5 on dt, x (B, S, d), bmat, cmat (B, S, N), a (d, N), h0 (B, d, N)
    and, for the gated output, dskip (d,) and z (B, S, d): returns (y or
    the gated output (B, S, d), h_last (B, d, N)), see ``ref``."""
    _check_shapes(dt, x, bmat, cmat, a, h0, dskip, z)
    gated = z is not None
    if dt.device.type == "cpu":
        if gated:
            return selective_scan_gated_ref(dt, x, bmat, cmat, a, h0, dskip,
                                            z)
        return selective_scan_ref(dt, x, bmat, cmat, a, h0)
    gate = {"dskip": dskip, "z": z} if gated else {}
    _check_cuda(dt, x=x, bmat=bmat, cmat=cmat, a=a, h0=h0, **gate)
    bsz, s, d = dt.shape
    n = bmat.shape[2]
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=dt.device)
    fn = FAMILY.fn("selective_scan")
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = fn(dt.data_ptr(), x.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), a.data_ptr(), h0.data_ptr(),
                 dskip.data_ptr() if gated else None,
                 z.data_ptr() if gated else None, y.data_ptr(),
                 h_last.data_ptr(), bsz, s, d, n, stream)
    FAMILY.launched("selective_scan", err)
    return y, h_last
