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

The partial form (``slots=(s0, s_all)``, C entry point
``decode_attention_partial``) takes a cache that holds slots s0 .. s0 + S
- 1 of a cache of ``s_all`` slots split over ranks by slot, and returns
beside the output normalised over those slots its log-sum-exp per (b,
query head): a rank's share, merged across ranks by
``models.layers.merge_partials``.  Its launches count under
``"decode_attention_partial"``.

On ``meta`` tensors (a plan: ``roofline.walk`` on the meta device) the
wrapper runs the card path's checks and returns empty outputs of the
card's shapes; it computes nothing.  :func:`work` is each call's FLOPs and
bytes, which the wrapper reports to a running walk on every device and
``chip_smoke.py``'s bounds read.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...roofline.walk import Work, launch
from .._build import KernelFamily
from .ref import decode_attention_ref

__all__ = ["SOURCES", "FAMILY", "D_MAX", "GROUPS", "launches",
           "decode_attention", "check_slots", "width", "tile", "cluster_size",
           "launch_shape", "plan", "spans", "live_slots", "work"]

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
PARTIAL = "decode_attention_partial"
FAMILY.launches[PARTIAL] = 0
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


def live_slots(s: int, pos: int, window: Optional[int] = None,
               slots: Optional[tuple] = None) -> int:
    """The valid slots of a cache of ``s`` slots at position ``pos`` (the
    kernel reads these and zero-fills the rest): slot i holds the latest
    position p <= pos with p = i (mod the whole cache's slots), valid where
    p >= 0 and, with ``window``, pos - p < window.  ``slots`` = (s0,
    s_all): the cache is slots s0 .. s0 + s - 1 of one of s_all."""
    s0, s_all = (0, s) if slots is None else (int(x) for x in slots)
    back = np.remainder(int(pos) - (s0 + np.arange(s, dtype=np.int64)),
                        s_all)
    valid = back <= int(pos)
    if window is not None:
        valid &= back < int(window)
    return int(valid.sum())


def work(b: int, hq: int, hkv: int, s: int, d: int, pos: int,
         window: Optional[int] = None, cache_dtype=torch.float32,
         slots: Optional[tuple] = None) -> Work:
    """One call's work: 4 FLOP per (query head, live slot, element) of QK
    and PV; the live slots' K / V read once in the cache's dtype, q read
    and the output written in fp32 (and, in the partial form, the
    log-sum-exp written)."""
    live = float(live_slots(s, pos, window, slots))
    size = torch.empty((), dtype=cache_dtype).element_size()
    nq = float(b) * hq * d
    return Work(4.0 * nq * live, 2.0 * size * b * hkv * live * d
                + 2.0 * 4 * nq + (4.0 * b * hq if slots is not None else 0.0))


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


def check_slots(slots, s: int) -> None:
    """``slots`` = (s0, s_all): a rank's first slot and the whole cache's
    slot count, for a cache block of ``s`` slots."""
    s0, s_all = (int(x) for x in slots)
    if s0 < 0 or s_all < s0 + s:
        raise ValueError(f"slots {s0} .. {s0 + s - 1} do not lie in a cache "
                         f"of {s_all} slots")


def _check_cuda(q, k, v) -> None:
    if q.device.type not in ("cuda", "meta") or k.dtype not in _DTYPE_CODE:
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
                     pos: int, window: Optional[int] = None,
                     slots: Optional[tuple] = None):
    """K6: q (B, Hq, 1, D), any float dtype, at absolute position ``pos``
    against the cache k / v (B, Hkv, S, D) (fp32, bf16 or float8_e4m3fn,
    contiguous), ``window`` None for a global layer.  Returns (B, Hq, 1, D)
    fp32: ``ref.decode_attention_ref``'s function.  With ``slots`` = (s0,
    s_all), k / v hold slots s0 .. s0 + S - 1 of a cache of s_all slots:
    returns (out, lse), the output over those slots and its log-sum-exp
    (B, Hq, 1) fp32 (-inf, with zeros, where none is valid)."""
    _check(q, k, v, pos, window)
    if slots is not None:
        check_slots(slots, k.shape[2])
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    # q widened to a contiguous fp32 copy for the launch
    copy = 0 if q.dtype == torch.float32 and q.is_contiguous() \
        else 4 * b * hq * d
    return launch(PARTIAL if slots is not None else "decode_attention",
                  lambda: work(b, hq, hkv, s, d, pos, window, k.dtype, slots),
                  lambda: _decode_attention(q, k, v, pos, window, slots),
                  lambda: copy)


def _decode_attention(q, k, v, pos, window, slots):
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, window, slots)
    _check_cuda(q, k, v)
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if q.device.type == "meta":
        out = torch.empty((b, hq, 1, d), dtype=torch.float32, device="meta")
        if slots is None:
            return out
        return out, torch.empty((b, hq, 1), dtype=torch.float32,
                                device="meta")
    qf = q.float().contiguous()
    out = torch.empty((b, hq, 1, d), dtype=torch.float32, device=q.device)
    w, c = plan(k)
    win = 0 if window is None else int(window)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if slots is None:
            err = FAMILY.fn("decode_attention")(
                _DTYPE_CODE[k.dtype], qf.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, hkv, hq // hkv, d, s,
                int(pos), win, c, w, float(d ** -0.5), stream)
        else:
            lse = torch.empty((b, hq, 1), dtype=torch.float32,
                              device=q.device)
            fn = FAMILY.symbol("decode_attention", PARTIAL,
                               [_I] + [_P] * 5 + [_I] * 11 + [_F, _P])
            err = fn(_DTYPE_CODE[k.dtype], qf.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, hkv,
                     hq // hkv, d, s, int(slots[0]), int(slots[1]),
                     int(pos), win, c, w, float(d ** -0.5), stream)
    if slots is None:
        FAMILY.launched("decode_attention", err)
        return out
    FAMILY.launched(PARTIAL, err)
    return out, lse
