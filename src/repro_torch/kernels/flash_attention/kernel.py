"""K4 ``flash_attention`` and K4b ``flash_attention_bwd``: the hand-written
CUDA flash attention and its gradient, their bindings and wrappers.

Sources ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
(each with its design note), built by the port's shared builder
(``repro_torch.kernels._build``) at first use.  The wrappers take the plain
versions (``ref.attention_fwd_ref``, ``ref.attention_bwd_ref``) for CPU
tensors and launch the kernels for CUDA tensors -- or raise: there is no
fallback.  They take q, k, v (and o, dO) with any strides but a contiguous
last dim (the model hands them transposed views), pad nothing (the kernels
mask ragged T and D), allocate contiguous outputs and count launches in
:data:`launches`.  K4 has three instances, chosen by :func:`instance` from
D alone before the launch (the source mirrors the choice and refuses
another): at D <= 64 and D <= 128 every product runs on the tensor cores
in 3xTF32 (fp32 accuracy), 128 query rows a block; at D <= 256 fp32 FMAs
on the CUDA cores.  K4b runs every product on the tensor cores in 3xTF32,
as a delta pre-pass, one launch of dK / dV and dQ blocks, and, when Hq >
Hkv, a sum of per-query-head fp32 partials that the wrapper allocates (2 x
B Hq Tk D floats); one count per call of its kernels.

On ``meta`` tensors (a plan: ``roofline.walk`` on the meta device) the
wrappers run the card path's checks and return empty outputs of the card's
shapes; they compute nothing.  :func:`work` is each call's FLOPs and
bytes, which the wrappers report to a running walk on every device and
``chip_smoke.py``'s bounds read.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ...roofline.walk import Work, launch
from .._build import KernelFamily
from .ref import attention_bwd_ref, attention_fwd_ref

__all__ = ["SOURCES", "FAMILY", "D_MAX", "INSTANCES", "launches",
           "instance", "flash_attention", "flash_attention_bwd",
           "live_pairs", "work"]

SOURCES = {"flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}
D_MAX = 256
# K4's instances (their codes in flash_attention.cu) and the largest D each
# takes; the tensor-core instances' query rows a block and keys a K / V tile
INSTANCES = ("tc64", "tc128", "simt256")
INSTANCE_D = {"tc64": 64, "tc128": 128, "simt256": D_MAX}
TC_BQ, TC_BKV = 128, 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES,
    {"flash_attention": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
     + [_L] * 12 + [_F, _I, _I, _P],
     "flash_attention_bwd": [_I] + [_P] * 12 + [_I] * 6 + [_L] * 15
     + [_F, _I, _I, _P]})
launches = FAMILY.launches


def instance(d: int) -> str:
    """The K4 instance that takes head width ``d`` (1 <= d <= D_MAX): the
    first of :data:`INSTANCES` whose width holds it."""
    if not 1 <= d <= D_MAX:
        raise ValueError(f"flash_attention supports 1 <= D <= {D_MAX}, got "
                         f"{d}")
    return next(name for name in INSTANCES if d <= INSTANCE_D[name])


@functools.lru_cache(maxsize=256)
def live_pairs(tq: int, tk: int, causal: bool = True,
               window=None) -> int:
    """The (query, key) pairs the mask keeps for one head: query i at
    position i against keys 0 .. tk - 1, causal (key <= query) and within
    ``window`` (query - key < window)."""
    i = np.arange(tq, dtype=np.int64)
    hi = np.minimum(i, tk - 1) if causal else np.full(tq, tk - 1)
    lo = np.maximum(0, i - int(window) + 1) if window is not None \
        else np.zeros(tq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(b: int, hq: int, hkv: int, tq: int, tk: int, d: int, *,
         causal: bool = True, window=None, dtype=torch.float32,
         with_lse: bool = False, bwd: bool = False) -> Work:
    """One call's work, live score pairs only.  K4: 2 D multiply-adds a
    live pair (QK and PV: 4 D FLOP); q, k and v read and the output (and
    L) written once.  K4b (``bwd``): S, dP, dV, dQ and dK, 5 D
    multiply-adds a live pair; q, k, v, o, dO and L read, dq, dk, dv and
    delta written once."""
    pairs = float(live_pairs(tq, tk, causal, window)) * b * hq
    size = torch.empty((), dtype=dtype).element_size()
    nq, nk = float(b) * hq * tq * d, float(b) * hkv * tk * d
    rows = float(b) * hq * tq
    if bwd:
        return Work(10.0 * pairs * d, size * (4 * nq + 4 * nk) + 8.0 * rows)
    return Work(4.0 * pairs * d, size * (2 * nq + 2 * nk)
                + (4.0 * rows if with_lse else 0.0))


def _check(q, k, v, window) -> None:
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


def _check_cuda(q, **others) -> None:
    """Raise unless the kernels take q and ``others`` (same device and
    dtype, unit last stride)."""
    if q.device.type not in ("cuda", "meta") or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention runs on CUDA fp32/bf16 tensors, "
                         f"got {q.device} {q.dtype}")
    for what, x in others.items():
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{what} is {x.device} {x.dtype}, expected "
                             f"{q.device} {q.dtype}")
    for what, x in (("q", q), *others.items()):
        if x.stride(3) != 1:
            raise ValueError(f"{what} needs unit stride in its last dim")
    if q.shape[3] > D_MAX:
        raise ValueError(f"flash_attention supports D <= {D_MAX}, got "
                         f"{q.shape[3]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    window: int | None = None, with_lse: bool = False):
    """K4 on q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D), D <= 256, fp32 or
    bf16 alike, scores scaled by ``scale``.  With ``with_lse`` returns
    (out, lse), lse the rows' fp32 (B, Hq, Tq) log-sum-exp (K4b's input);
    the output is the same bits either way."""
    _check(q, k, v, window)
    return launch("flash_attention", lambda: work(
        *q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
        causal=causal, window=window, dtype=q.dtype, with_lse=with_lse),
        lambda: _flash_attention(q, k, v, scale, causal, window, with_lse))


def _flash_attention(q, k, v, scale, causal, window, with_lse):
    if q.device.type == "cpu":
        out, lse = attention_fwd_ref(q, k, v, causal=causal, window=window,
                                     scale=scale)
        return (out, lse) if with_lse else out
    _check_cuda(q, k=k, v=v)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.device.type == "meta":
        return (out, lse) if with_lse else out
    fn = FAMILY.fn("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], INSTANCES.index(instance(d)),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, hq, hkv, tq, tk,
                 d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], float(scale), int(causal),
                 0 if window is None else int(window), stream)
    FAMILY.launched("flash_attention", err)
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: int | None = None) -> tuple:
    """K4b: (dq, dk, dv) of K4 for the output gradient ``do``, from K4's
    output ``o`` and ``lse`` (``flash_attention(..., with_lse=True)``);
    dq, dk, dv contiguous, in the inputs' dtype."""
    _check(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} for q "
                         f"{tuple(q.shape)}")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    # delta, and each query head's fp32 dK / dV where Hq > Hkv
    workspace = 4 * b * hq * tq + (8 * b * hq * tk * d if hq > hkv else 0)
    return launch("flash_attention_bwd", lambda: work(
        b, hq, hkv, tq, tk, d, causal=causal, window=window, dtype=q.dtype,
        bwd=True), lambda: _flash_attention_bwd(q, k, v, o, lse, do, scale,
                                                causal, window),
        lambda: workspace)


def _flash_attention_bwd(q, k, v, o, lse, do, scale, causal, window):
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window, scale=scale)
    _check_cuda(q, k=k, v=v, o=o, do=do)
    if lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous fp32 tensor on q's "
                         "device")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dq = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, tk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, hkv, tk, d), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        return dq, dk, dv
    delta = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    # each query head's fp32 dK / dV, summed over its group in head order
    part_k, part_v = (torch.empty((b, hq, tk, d), dtype=torch.float32,
                                  device=q.device) if hq > hkv else None
                      for _ in range(2))
    fn = FAMILY.fn("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), None if part_k is None else part_k.data_ptr(),
                 None if part_v is None else part_v.data_ptr(),
                 b, hq, hkv, tq, tk, d, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 *do.stride()[:3], float(scale), int(causal),
                 0 if window is None else int(window), stream)
    FAMILY.launched("flash_attention_bwd", err)
    return dq, dk, dv
