"""K6 ``decode_attention``: the hand-written CUDA decode attention over a
KV cache in its stored dtype (fp32, bf16 or float8_e4m3fn), its binding
and wrapper.

Source ``csrc/decode_attention.cu`` (with its design note), built by the
port's shared builder (``repro_torch.kernels._build``) at first use.  The
wrapper takes the plain version (``ref.decode_attention_ref``) for CPU
tensors and launches the kernel for CUDA tensors -- or raises: there is no
fallback.  It picks the warps a CTA and the cluster size
(:func:`launch_shape`: the CTAs that split one (b, KV head)'s slots and
merge their states in one launch) from B x Hkv, S and the CTAs and
clusters of each size the card holds at once for the instance
(``decode_attention_limits``), allocates the fp32 output and counts one
launch a call in :data:`launches`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import KernelFamily
from .ref import decode_attention_ref

__all__ = ["SOURCES", "FAMILY", "D_MAX", "GROUPS", "launches",
           "decode_attention", "width", "tile", "cluster_size",
           "launch_shape", "plan", "spans"]

SOURCES = {"decode_attention": "decode_attention.cu"}
D_MAX = 256
GROUPS = (1, 2, 4, 5)          # the configs' Hq / Hkv (the kernel takes 1..8)
WARPS = (4, 8)                 # warps a CTA (WARPS_MIN, WARPS_MAX)
TILE_BYTES = 4096              # K bytes a warp's tile aims at
TILE_MIN, TILE_MAX = 8, 32     # slots a tile
CLUSTER_MAX = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES,
    {"decode_attention": [_I] + [_P] * 4 + [_I] * 9 + [_F, _P]})
launches = FAMILY.launches

_LIMITS: dict = {}             # (device, dtype code, width) -> {warps:
                               # {cluster size: clusters held at once}}


def width(d: int) -> int:
    """The instance's padded width DP for head dim ``d``: 32, 64, 128 or
    256."""
    for dp in (32, 64, 128, 256):
        if d <= dp:
            return dp
    raise ValueError(f"decode_attention supports D <= {D_MAX}, got {d}")


def tile(d: int, size: int) -> int:
    """Slots of a warp's tile for head dim ``d`` and a cache element of
    ``size`` bytes: TILE_BYTES of padded K rows, clamped to TILE_MIN ..
    TILE_MAX (``Geo::TS``)."""
    return max(TILE_MIN, min(TILE_MAX, TILE_BYTES // (width(d) * size)))


def cluster_size(n_bh: int, s: int, tile_slots: int, warps: int,
                 resident: dict) -> int:
    """CTAs C of ``warps`` warps that split each of the ``n_bh`` = B x Hkv
    caches of ``s`` slots: the largest C in 2, 4, 8, 16 with all n_bh
    clusters of C CTAs on the card at once (``resident[C]``, the clusters
    of that size the card holds) and every CTA holding at least ``warps``
    whole tiles (so no warp idles); 1 when 2 does not fit."""
    tiles = -(-s // tile_slots)
    c = 1
    while (2 * c <= CLUSTER_MAX and n_bh <= resident.get(2 * c, 0)
           and tiles // (2 * c) >= warps):
        c *= 2
    return c


def launch_shape(n_bh: int, s: int, tile_slots: int, resident: dict) -> tuple:
    """(warps, C) of the launch: for each W of WARPS whose grid of n_bh
    CTAs fits the card at once (``resident[W][1]``, the CTAs of W warps it
    holds), C by :func:`cluster_size`; the pair with the most warps in that
    one wave, the larger W on a tie; (4, 1) when no grid fits at once."""
    best = (0, WARPS[0], 1)
    for w in WARPS:
        held = resident.get(w, {})
        if n_bh > held.get(1, 0):
            continue
        c = cluster_size(n_bh, s, tile_slots, w, held)
        best = max(best, (n_bh * c * w, w, c))
    return best[1], best[2]


def spans(s: int, tile_slots: int, c: int) -> list:
    """The tile ranges [lo, hi) of the ``c`` CTAs of one cache of ``s``
    slots, as the kernel computes them: floor(r tiles / c)."""
    tiles = -(-s // tile_slots)
    return [(r * tiles // c, (r + 1) * tiles // c) for r in range(c)]


def _resident(device: torch.device, dtype: int, d: int) -> dict:
    """For each W of WARPS, the CTAs of W warps of the instance for (dtype,
    d) the card holds at once (at 1) and its clusters of 2, 4, 8 and 16
    such CTAs (``decode_attention_limits``)."""
    key = (device.index, dtype, width(d))
    if key not in _LIMITS:
        query = FAMILY.symbol("decode_attention", "decode_attention_limits",
                              [_I, _I, _I, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)])
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        out = {}
        for w in WARPS:
            ctas = ctypes.c_int(0)
            held = (ctypes.c_int * 4)()
            with torch.cuda.device(device):
                err = query(dtype, d, w, ctypes.byref(ctas), held)
            if err != 0:
                raise RuntimeError(f"decode_attention_limits: cudaError "
                                   f"{err}")
            out[w] = {1: ctas.value * sms,
                      **{2 << i: held[i] for i in range(4)}}
        if out[WARPS[0]][1] < 1:
            raise RuntimeError(f"decode_attention: the card holds no CTA of "
                               f"the instance for dtype {dtype}, D {d}")
        _LIMITS[key] = out
    return _LIMITS[key]


def plan(k: torch.Tensor) -> tuple:
    """(warps a CTA, cluster size) of K6's launch over the CUDA cache
    ``k`` (B, Hkv, S, D): :func:`launch_shape` with the card's limits."""
    b, hkv, s, d = k.shape
    dev = k.device if k.device.index is not None \
        else torch.device("cuda", torch.cuda.current_device())
    return launch_shape(b * hkv, s, tile(d, k.element_size()),
                        _resident(dev, _DTYPE_CODE[k.dtype], d))


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
    w, c = plan(k)
    fn = FAMILY.fn("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[k.dtype], qf.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, hkv, hq // hkv, d, s,
                 int(pos), 0 if window is None else int(window), c, w,
                 float(d ** -0.5), stream)
    FAMILY.launched("decode_attention", err)
    return out
