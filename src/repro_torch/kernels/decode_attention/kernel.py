"""K6 ``decode_attention``: the hand-written CUDA decode attention over a
KV cache in its stored dtype (fp32, bf16 or float8_e4m3fn), its binding
and wrapper.

Source ``csrc/decode_attention.cu`` (with its design note), built by the
port's shared builder (``repro_torch.kernels._build``) at first use.  The
wrapper takes the plain version (``ref.decode_attention_ref``) for CPU
tensors and launches the kernel for CUDA tensors -- or raises: there is no
fallback.  It splits the cache's slots over blocks so that about
:data:`BLOCKS_PER_SM` blocks an SM are in flight (at least
:data:`MIN_CHUNK` slots a block, in whole 32-slot tiles), allocates the
fp32 output and the
splits' scratch, and counts one launch a call in :data:`launches` (the
merge of the splits, where there are several, is part of the call).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import KernelFamily
from .ref import decode_attention_ref

__all__ = ["SOURCES", "FAMILY", "D_MAX", "GROUPS", "launches",
           "decode_attention", "splits"]

SOURCES = {"decode_attention": "decode_attention.cu"}
D_MAX = 256
GROUPS = (1, 2, 4, 5)          # the kernel's instances of Hq / Hkv
BLOCKS_PER_SM = 16
MIN_CHUNK = 64
TILE = 32                      # slots a warp scores at once
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES,
    {"decode_attention": [_I] + [_P] * 6 + [_I] * 9 + [_F, _P]})
launches = FAMILY.launches

_SMS: dict = {}                # device index -> streaming multiprocessors


def splits(n_bh: int, s: int, sms: int) -> tuple:
    """(chunk, splits) of the S slots for ``n_bh`` = B x Hkv blocks of
    slots on a card of ``sms`` SMs: enough splits for BLOCKS_PER_SM
    blocks an SM, each split a multiple of a warp's 32-slot tile and at
    least MIN_CHUNK slots (one split of S when S is at most that)."""
    if s <= MIN_CHUNK:
        return s, 1
    want = max(1, -(-BLOCKS_PER_SM * sms // n_bh))
    chunk = max(MIN_CHUNK, -(-s // want))
    chunk = -(-chunk // TILE) * TILE
    return chunk, -(-s // chunk)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           pos: int, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != 1 \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"decode_attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: q must be "
                         f"(B, Hq, 1, D) and k / v (B, Hkv, S, D)")
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if min(b, hq, d, hkv, s) < 1 or hq % hkv:
        raise ValueError(f"decode_attention needs non-empty operands and "
                         f"Hq % Hkv == 0, got Hq={hq} Hkv={hkv}")
    if int(pos) < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _check_cuda(q, k, v) -> None:
    if q.device.type != "cuda" or k.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_attention runs on CUDA with an fp32, bf16 "
                         f"or float8_e4m3fn cache, got {q.device} {k.dtype}")
    if k.device != q.device or v.device != q.device or v.dtype != k.dtype:
        raise ValueError(f"k {k.device} {k.dtype}, v {v.device} {v.dtype} "
                         f"for q on {q.device}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention needs contiguous k / v caches")
    g = q.shape[1] // k.shape[1]
    if q.shape[3] > D_MAX or g not in GROUPS:
        raise ValueError(f"decode_attention supports D <= {D_MAX} and Hq / "
                         f"Hkv in {GROUPS}, got D={q.shape[3]}, g={g}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, window: Optional[int] = None) -> torch.Tensor:
    """K6: q (B, Hq, 1, D), any float dtype, at absolute position ``pos``
    against the cache k / v (B, Hkv, S, D) (fp32, bf16 or float8_e4m3fn,
    contiguous), ``window`` None for a global layer.  Returns (B, Hq, 1, D)
    fp32: ``ref.decode_attention_ref``'s function."""
    _check(q, k, v, pos, window)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, window)
    _check_cuda(q, k, v)
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qf = q.float().contiguous()
    out = torch.empty((b, hq, 1, d), dtype=torch.float32, device=q.device)
    dev = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    chunk, n_split = splits(b * hkv, s, _SMS[dev])
    part_ml = part_acc = None
    if n_split > 1:
        part_ml = torch.empty((n_split, b * hq, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((n_split, b * hq, d), dtype=torch.float32,
                               device=q.device)
    fn = FAMILY.fn("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[k.dtype], qf.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 None if part_acc is None else part_acc.data_ptr(),
                 b, hkv, hq // hkv, d, s, int(pos),
                 0 if window is None else int(window), chunk, n_split,
                 float(d ** -0.5), stream)
    FAMILY.launched("decode_attention", err)
    return out
