"""K5 ``selective_scan`` and K5b ``selective_scan_bwd``: the hand-written
CUDA scan of Mamba1 and its gradient, their bindings and wrappers.

Sources ``csrc/selective_scan.cu`` and ``csrc/selective_scan_bwd.cu``
(each with its design note), built by the port's shared builder
(``repro_torch.kernels._build``) at first use.  K5: two lanes per
(batch, channel) split its N <= 16 states and walk the sequence with them
in registers; given Mamba1's D and z it writes the gated output
``(y + D x) * silu(z)`` in place of y.  With ``states=True`` K5 also
stores the state at the start of every 16-step tile.  K5b: four lanes a
channel run each tile forward again from its saved state, keeping the
tile's states in registers, then walk it in reverse.  The wrappers
take the plain versions (``ref.selective_scan_ref`` /
``selective_scan_gated_ref`` / ``selective_scan_bwd_ref``) for CPU tensors
and launch the kernels for CUDA tensors -- or raise: there is no
fallback.  They take contiguous fp32 tensors only, allocate the outputs
and count launches in :data:`launches`.

On ``meta`` tensors (a plan: ``roofline.walk`` on the meta device) the
wrappers run the card path's checks and return empty outputs of the card's
shapes; they compute nothing.  :func:`work` is each call's FLOPs, exps and
bytes, which the wrappers report to a running walk on every device and
``chip_smoke.py``'s bounds read.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ...roofline.walk import Work, launch
from .._build import KernelFamily
from .ref import (selective_scan_bwd_ref, selective_scan_gated_ref,
                  selective_scan_ref)

__all__ = ["SOURCES", "FAMILY", "N_MAX", "STATE_EVERY", "BWD_CH", "launches",
           "selective_scan", "selective_scan_bwd", "bwd_occupancy", "work"]

SOURCES = {"selective_scan": "selective_scan.cu",
           "selective_scan_bwd": "selective_scan_bwd.cu"}
N_MAX = 16            # the largest state size the kernels are built for
STATE_EVERY = 16      # K5's STATE_EVERY, K5b's TILE: steps between states
BWD_CH = 128          # K5b's K5B_CH, channels a block: its dB / dC partials
_P, _I = ctypes.c_void_p, ctypes.c_int
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES,
    {"selective_scan": [_P] * 11 + [_I] * 4 + [_P],
     "selective_scan_bwd": [_P] * 18 + [_I] * 5 + [_P]})
launches = FAMILY.launches


def work(bsz: int, s: int, d: int, n: int, gated: bool = True,
         states: bool = False, bwd: bool = False,
         dh_last: bool = False) -> Work:
    """One call's work at (B, S, d, N), fp32.  K5: per (b, t, c, n) one exp
    on the special-function units and dt*A, decay*h + dx*B and the FMA of y
    (6 FLOP, an FMA = 2), plus dt*x per (b, t, c); the gate adds one exp
    (the sigmoid's) and 5 FLOP per (b, t, c).  Bytes: dt and x read (and
    z), y written, B_t / C_t, A (and D), h0 and h_last (and, with
    ``states``, the saved state of every 16-step tile).  K5b (``bwd``):
    ~22 FLOP per (b, t, c, n) (the state stepped forward, C . h, the
    reverse step and the five sums), the decay's exp per (b, t, c, n) and
    the sigmoid's per (b, t, c) gated; dt, x, dout (and z) read, ddt, dx
    (and dz) written, B_t / C_t read and dB / dC written, A read and dA
    written (and D, dD), h0 read and dh0 written (and dh_last read)."""
    elems, rows = float(bsz) * s * d * n, float(bsz) * s * d
    if bwd:
        nbytes = 4.0 * ((7 if gated else 5) * rows + 4 * bsz * s * n
                        + 2 * d * n + (2 * d if gated else 0)
                        + (3 if dh_last else 2) * bsz * d * n)
        return Work(22.0 * elems, nbytes, elems + (rows if gated else 0.0))
    nbytes = 4.0 * ((4 if gated else 3) * rows + 2 * bsz * s * n + d * n
                    + (d if gated else 0) + 2 * bsz * d * n
                    + (bsz * -(-s // STATE_EVERY) * d * n if states else 0))
    return Work(6.0 * elems + (6 if gated else 1) * rows, nbytes,
                elems + (rows if gated else 0.0))


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
    if dt.device.type not in ("cuda", "meta"):
        raise ValueError(f"selective_scan: unsupported device {dt.device}")
    if others["bmat"].shape[2] > N_MAX or dt.shape[0] > 65535:
        raise ValueError(f"selective_scan supports N <= {N_MAX} and B <= "
                         f"65535, got N={others['bmat'].shape[2]} B="
                         f"{dt.shape[0]}")


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                   dskip: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None,
                   states: bool = False) -> tuple:
    """K5 on dt, x (B, S, d), bmat, cmat (B, S, N), a (d, N), h0 (B, d, N)
    and, for the gated output, dskip (d,) and z (B, S, d): returns (y or
    the gated output (B, S, d), h_last (B, d, N)), see ``ref``.  With
    ``states``, also the state at the start of every ``STATE_EVERY``-step
    tile, (B, ceil(S / 16), d, N), what K5b takes (None on the CPU, where
    the plain backward runs forward again from h0)."""
    _check_shapes(dt, x, bmat, cmat, a, h0, dskip, z)
    return launch("selective_scan", lambda: work(
        *dt.shape, bmat.shape[2], z is not None, states),
        lambda: _selective_scan(dt, x, bmat, cmat, a, h0, dskip, z, states))


def _selective_scan(dt, x, bmat, cmat, a, h0, dskip, z, states) -> tuple:
    gated = z is not None
    if dt.device.type == "cpu":
        plain = selective_scan_gated_ref(dt, x, bmat, cmat, a, h0, dskip,
                                         z) if gated \
            else selective_scan_ref(dt, x, bmat, cmat, a, h0)
        return (*plain, None) if states else plain
    gate = {"dskip": dskip, "z": z} if gated else {}
    _check_cuda(dt, x=x, bmat=bmat, cmat=cmat, a=a, h0=h0, **gate)
    bsz, s, d = dt.shape
    n = bmat.shape[2]
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=dt.device)
    hs = torch.empty((bsz, -(-s // STATE_EVERY), d, n), dtype=torch.float32,
                     device=dt.device) if states else None
    if dt.device.type == "meta":
        return (y, h_last, hs) if states else (y, h_last)
    fn = FAMILY.fn("selective_scan")
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = fn(dt.data_ptr(), x.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), a.data_ptr(), h0.data_ptr(),
                 dskip.data_ptr() if gated else None,
                 z.data_ptr() if gated else None, y.data_ptr(),
                 h_last.data_ptr(), hs.data_ptr() if states else None, bsz,
                 s, d, n, stream)
    FAMILY.launched("selective_scan", err)
    return (y, h_last, hs) if states else (y, h_last)


def selective_scan_bwd(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                       hs: Optional[torch.Tensor], dout: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None,
                       dskip: Optional[torch.Tensor] = None,
                       z: Optional[torch.Tensor] = None) -> tuple:
    """K5b: the gradients of :func:`selective_scan` for the cotangents
    ``dout`` (B, S, d) and ``dh_last`` (B, d, N; None = 0), given its
    inputs and, on CUDA, the states ``hs`` it saved (``states=True``).
    Returns (ddt, dx, dB, dC, dA, dh0) and, gated, (dD, dz), as
    ``ref.selective_scan_bwd_ref``.  On CUDA one launch, then the block
    and batch partials of dB, dC, dA (and dD) summed in a fixed order."""
    _check_shapes(dt, x, bmat, cmat, a, h0, dskip, z)
    bsz, s, d = dt.shape
    n = bmat.shape[2]
    gated = z is not None
    # the block partials of dB / dC and the batch partials of dA (and dD)
    workspace = 4 * (2 * bsz * s * -(-d // BWD_CH) * n + bsz * d * n
                     + (bsz * d if gated else 0))
    return launch("selective_scan_bwd", lambda: work(
        bsz, s, d, n, gated, bwd=True, dh_last=dh_last is not None),
        lambda: _selective_scan_bwd(dt, x, bmat, cmat, a, h0, hs, dout,
                                    dh_last, dskip, z), lambda: workspace)


def _selective_scan_bwd(dt, x, bmat, cmat, a, h0, hs, dout, dh_last, dskip,
                        z) -> tuple:
    gated = z is not None
    if dt.device.type == "cpu":
        return selective_scan_bwd_ref(dt, x, bmat, cmat, a, h0, dout,
                                      dh_last, dskip, z)
    bsz, s, d = dt.shape
    n = bmat.shape[2]
    if hs is None or tuple(hs.shape) != (bsz, -(-s // STATE_EVERY), d, n):
        raise ValueError(f"selective_scan_bwd needs K5's saved states "
                         f"(B, ceil(S / {STATE_EVERY}), d, N), got "
                         f"{None if hs is None else tuple(hs.shape)}")
    others = {"hs": hs, "dout": dout}
    if dh_last is not None:
        others["dh_last"] = dh_last
    if tuple(dout.shape) != (bsz, s, d) or (
            dh_last is not None and tuple(dh_last.shape) != (bsz, d, n)):
        got = None if dh_last is None else tuple(dh_last.shape)
        raise ValueError(f"selective_scan_bwd cotangents: dout "
                         f"{tuple(dout.shape)}, dh_last {got}")
    gate = {"dskip": dskip, "z": z} if gated else {}
    _check_cuda(dt, x=x, bmat=bmat, cmat=cmat, a=a, **others, **gate)
    if dt.device.type == "meta":
        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device="meta")

        grads = (empty(bsz, s, d), empty(bsz, s, d), empty(bsz, s, n),
                 empty(bsz, s, n), empty(d, n), empty(bsz, d, n))
        return (*grads, empty(d), empty(bsz, s, d)) if gated else grads
    blocks = -(-d // BWD_CH)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dt.device)

    ddt, dx, dh0 = new(bsz, s, d), new(bsz, s, d), new(bsz, d, n)
    dbp, dcp, dap = new(bsz, s, blocks, n), new(bsz, s, blocks, n), \
        new(bsz, d, n)
    dz, ddp = (new(bsz, s, d), new(bsz, d)) if gated else (None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = FAMILY.fn("selective_scan_bwd")
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = fn(*(ptr(t) for t in (dt, x, bmat, cmat, a, hs, dskip, z, dout,
                                    dh_last, ddt, dx, dz, dbp, dcp, dap, ddp,
                                    dh0)),
                 bsz, s, d, n, blocks, stream)
    FAMILY.launched("selective_scan_bwd", err)
    grads = (ddt, dx, dbp.sum(2), dcp.sum(2), dap.sum(0), dh0)
    return (*grads, ddp.sum(0), dz) if gated else grads


def bwd_occupancy(n: int, gated: bool, device=None, lib=None) -> dict:
    """What K5b's instance for state size ``n`` gets on a CUDA device: its
    blocks and warps an SM (the occupancy calculator's), threads and
    dynamic shared memory a block, registers and local (spill) bytes a
    thread, and channels a block (``BWD_CH`` must equal it).  ``lib``: a
    library built from another copy of the source (default: the port's)."""
    out = (ctypes.c_int * 6)()
    args = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    if lib is None:
        query = FAMILY.symbol("selective_scan_bwd", "selective_scan_bwd_info",
                              args)
    else:
        query = lib.selective_scan_bwd_info
        query.argtypes, query.restype = args, ctypes.c_int
    with torch.cuda.device(device):
        err = query(n, int(gated), out)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd_info: cudaError {err}")
    blocks, threads, smem, regs, local, ch = out
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "threads": threads, "smem_bytes": smem, "registers": regs,
            "local_bytes": local, "channels": ch}
