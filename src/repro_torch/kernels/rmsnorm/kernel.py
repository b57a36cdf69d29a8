"""K3 ``rmsnorm``: the hand-written CUDA RMSNorm, its binding and wrapper.

Source ``csrc/rmsnorm.cu`` (with its design note), built by the port's
shared builder (``repro_torch.kernels._build``) at first use.  One warp
normalises one row: for d <= :data:`D_MAX` with 16-byte aligned rows it
keeps the row in registers and reads device memory once; :func:`variant`
picks, from shape and alignment and before the launch, that variant or one
of the two strided variants for longer or unaligned rows.  The wrapper
takes the plain version (``ref.rmsnorm_ref``) for a CPU tensor and launches
the kernel for a CUDA tensor -- or raises: there is no fallback.  Launches
are counted in :data:`launches`, one per call whatever the variant.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelFamily
from .ref import rmsnorm_ref

__all__ = ["SOURCES", "FAMILY", "D_MAX", "launches", "rmsnorm_rows",
           "variant"]

SOURCES = {"rmsnorm": "rmsnorm.cu"}
D_MAX = 2048           # the largest d whose row a warp keeps in registers
VARIANTS = ("warp", "loop", "scalar")      # their codes in rmsnorm.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES,
    {"rmsnorm": [_I, _I, _I, _P, _L, _P, _P, _L, _I, _I, _F, _P]})
launches = FAMILY.launches


def variant(x: torch.Tensor, scale: torch.Tensor) -> tuple:
    """The K3 variant for ``x`` (rows, d) and ``scale``, and its 16-byte
    vectors per lane: ``("warp", nv)`` when every row and ``scale`` are
    16-byte aligned, d is a multiple of the vector width and d <= D_MAX;
    ``("loop", 0)`` when only d is too long; ``("scalar", 0)`` otherwise.
    (The output is a fresh allocation, always aligned.)"""
    d = x.shape[1]
    size = x.element_size()
    epv = 16 // size
    aligned = (d % epv == 0 and x.stride(0) * size % 16 == 0
               and x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    if not aligned:
        return "scalar", 0
    if d > D_MAX:
        return "loop", 0
    return "warp", -(-d // (32 * epv))


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """K3 over the rows of ``x`` (rows, d) with ``scale`` (d,), fp32 or
    bf16 alike; any row count, any row stride, unit inner stride."""
    if x.dim() != 2 or scale.shape != (x.shape[1],) or min(x.shape) < 1:
        raise ValueError(f"rmsnorm needs x (rows, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda" or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm runs on CUDA fp32/bf16 tensors, got "
                         f"{x.device} {x.dtype}")
    if scale.device != x.device or scale.dtype != x.dtype \
            or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous {x.dtype} tensor on "
                         f"{x.device}")
    if x.stride(1) != 1:
        raise ValueError("x needs unit stride in its last dimension")
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    kind, nv = variant(x, scale)
    fn = FAMILY.fn("rmsnorm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], VARIANTS.index(kind), nv,
                 x.data_ptr(), x.stride(0),
                 scale.data_ptr(), out.data_ptr(), d, rows, d, float(eps),
                 stream)
    FAMILY.launched("rmsnorm", err)
    return out
