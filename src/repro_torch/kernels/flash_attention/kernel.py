"""K4 ``flash_attention``: the hand-written CUDA flash attention, its
binding and wrapper.

Source ``csrc/flash_attention.cu`` (with its design note), built by the
port's shared builder (``repro_torch.kernels._build``) at first use.  The
wrapper takes the plain version (``ref.attention_ref``) for a CPU tensor
and launches the kernel for a CUDA tensor -- or raises: there is no
fallback.  It takes q, k, v with any strides but a contiguous last dim
(the model hands it transposed views), pads nothing (the kernel masks
ragged T and D), allocates a contiguous output and counts launches in
:data:`launches`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelFamily
from .ref import attention_ref

__all__ = ["SOURCES", "FAMILY", "D_MAX", "launches", "flash_attention"]

SOURCES = {"flash_attention": "flash_attention.cu"}
D_MAX = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES,
    {"flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
     + [_L] * 12 + [_F, _I, _I, _P]})
launches = FAMILY.launches


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """K4 on q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D), D <= 256, fp32 or
    bf16 alike, scores scaled by ``scale``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if min(b, hq, tq, d, hkv, tk) < 1 or hq % hkv:
        raise ValueError(f"flash_attention needs non-empty operands and "
                         f"Hq % Hkv == 0, got Hq={hq} Hkv={hkv}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type != "cuda" or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention runs on CUDA fp32/bf16 tensors, "
                         f"got {q.device} {q.dtype}")
    for what, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{what} is {x.device} {x.dtype}, expected "
                             f"{q.device} {q.dtype}")
    for what, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{what} needs unit stride in its last dim")
    if d > D_MAX:
        raise ValueError(f"flash_attention supports D <= {D_MAX}, got {d}")
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    fn = FAMILY.fn("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, hq, hkv, tq, tk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], float(scale), int(causal),
                 0 if window is None else int(window), stream)
    FAMILY.launched("flash_attention", err)
    return out
