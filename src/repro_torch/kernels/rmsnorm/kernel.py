"""K3 ``rmsnorm`` and K3b ``rmsnorm_bwd``: the hand-written CUDA RMSNorm and
its gradient, their bindings and wrappers.

Sources ``csrc/rmsnorm.cu`` and ``csrc/rmsnorm_bwd.cu`` (each with its
design note), built by the port's shared builder
(``repro_torch.kernels._build``) at first use.  :func:`variant` picks,
from the row count, d, the dtype and the alignment and before the launch,
one of four variants: "warp" (a warp a row, d <= :data:`D_MAX`, rows enough
to fill the card) and "block" (a block of up to 32 warps a row, wider rows
or fewer) keep the row in registers and read device memory once; "loop"
(rows too wide for "block") and "scalar" (unaligned rows) make two strided
passes.  The wrapper takes the plain version (``ref.rmsnorm_ref``) for a
CPU tensor and launches the kernel for a CUDA tensor -- or raises: there
is no fallback.  Launches are counted in :data:`launches`, one per call
whatever the variant.  :func:`rmsnorm_rows_bwd` does the same for the gradient (K3b, one count
per call of its kernels; ``ref.rmsnorm_bwd_ref`` on the CPU), with
:func:`variant` given g too: its "warp" (a warp a row, d <= D_MAX) and
"block" (a row over up to :data:`BWD_BLOCK_WARPS` warps, wider rows)
variants keep the rows of x and g in registers, read each once and fold
the partial dscale into the same kernel; "loop" and "scalar" make two
strided passes and a partial pass.

Both take ``ss`` and ``n`` for a row split across ranks by columns (the
C entries ``rmsnorm_ext`` / ``rmsnorm_bwd_ext``, counted with the
others): ``x`` holds a block of each row's ``n`` columns and ``ss``
(rows,) fp32 each whole row's sum of squares, the ranks' partial sums
summed, so the mean square is ss / n.  The gradient then holds the
statistic and returns its gradient from the block's columns beside dx and
dscale, for the caller to sum across ranks.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelFamily
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["SOURCES", "FAMILY", "D_MAX", "launches", "rmsnorm_rows",
           "rmsnorm_rows_bwd", "variant"]

SOURCES = {"rmsnorm": "rmsnorm.cu", "rmsnorm_bwd": "rmsnorm_bwd.cu"}
D_MAX = 2048           # the largest d whose row a warp keeps in registers
VARIANTS = ("warp", "loop", "scalar", "block")   # their codes in rmsnorm.cu
BLOCK_NV = 8           # "block": the most 16-byte vectors a lane
BLOCK_WARPS = 32       # "block": the most warps a row
# K3's "warp" takes d <= D_MAX from WARP_ROWS rows on (a warp a row, 16
# warps an SM of the H100's 132); "block" takes fewer rows or wider ones,
# over enough warps a row that the grid has FILL_WARPS warps (64 an SM, the
# most an SM holds) where d allows
WARP_ROWS = 132 * 16
FILL_WARPS = 132 * 64
# K3b's "block": a row over the fewest vectors a lane (at most BLOCK_NV)
# that BWD_BLOCK_WARPS warps allow (512 threads: 128 registers a thread)
BWD_BLOCK_WARPS = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES,
    {"rmsnorm": [_I, _I, _I, _P, _L, _P, _P, _L, _I, _I, _F, _P],
     "rmsnorm_bwd": [_I, _I, _I, _P, _L, _P, _L, _P, _P, _P, _P, _P, _I, _I,
                     _I, _F, _P]})
launches = FAMILY.launches
_EXT_ARGS = {"rmsnorm_ext": [_I, _I, _I, _P, _L, _P, _P, _L, _I, _I, _F, _P,
                             _I, _P],
             "rmsnorm_bwd_ext": [_I, _I, _I, _P, _L, _P, _L, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _F, _P, _P, _I, _P]}


def variant(x: torch.Tensor, scale: torch.Tensor,
            *others: torch.Tensor) -> tuple:
    """The K3 (or, given g, K3b) variant for ``x`` (rows, d), ``scale`` and
    the ``others`` of x's shape, and its 16-byte vectors per lane.
    ``("scalar", 0)`` unless the rows of x and of the others and ``scale``
    are 16-byte aligned and d is a multiple of the vector width.  Aligned,
    K3b takes ``("warp", nv)`` for d <= D_MAX, else ``("block", nv)``: a
    block of ceil(vectors / (32 nv)) warps a row, nv the fewest vectors a
    lane that BWD_BLOCK_WARPS warps allow, ``("loop", 0)`` past BLOCK_NV.
    K3 takes ``("warp", nv)`` for d <= D_MAX at WARP_ROWS rows or more,
    ``("loop", 0)`` for rows wider than 32 x 32 x BLOCK_NV vectors, and
    ``("block", nv)`` otherwise: a block of ceil(vectors / (32 nv)) warps a
    row, nv as small as gives the grid FILL_WARPS warps, at most 32 warps,
    at least one vector a lane and at most BLOCK_NV.  (Outputs are fresh
    allocations, always aligned.)"""
    rows, d = x.shape
    size = x.element_size()
    epv = 16 // size
    aligned = (d % epv == 0 and scale.data_ptr() % 16 == 0
               and all(t.stride(0) * size % 16 == 0 and t.data_ptr() % 16 == 0
                       for t in (x, *others)))
    if not aligned:
        return "scalar", 0
    nvec = d // epv
    if others:
        if d <= D_MAX:
            return "warp", -(-nvec // 32)
        nv = -(-nvec // (32 * BWD_BLOCK_WARPS))
        return ("block", nv) if nv <= BLOCK_NV else ("loop", 0)
    if d <= D_MAX and rows >= WARP_ROWS:
        return "warp", -(-nvec // 32)
    fewest = -(-nvec // (32 * BLOCK_NV))
    if fewest > BLOCK_WARPS:
        return "loop", 0
    warps = max(fewest, min(BLOCK_WARPS, -(-nvec // 32),
                            -(-FILL_WARPS // rows)))
    return "block", -(-nvec // (32 * warps))


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise unless K3 / K3b take ``x`` (rows, d) and ``scale`` (d,) on
    CUDA."""
    if x.device.type != "cuda" or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm runs on CUDA fp32/bf16 tensors, got "
                         f"{x.device} {x.dtype}")
    if scale.device != x.device or scale.dtype != x.dtype \
            or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous {x.dtype} tensor on "
                         f"{x.device}")
    if x.stride(1) != 1:
        raise ValueError("x needs unit stride in its last dimension")


def _check_shapes(x: torch.Tensor, scale: torch.Tensor, ss=None,
                  n=None) -> None:
    if x.dim() != 2 or scale.shape != (x.shape[1],) or min(x.shape) < 1:
        raise ValueError(f"rmsnorm needs x (rows, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if ss is None:
        return
    if ss.shape != (x.shape[0],) or ss.dtype != torch.float32 \
            or ss.device != x.device or not ss.is_contiguous():
        raise ValueError(f"ss must be a contiguous fp32 ({x.shape[0]},) on "
                         f"{x.device}, got {tuple(ss.shape)} {ss.dtype}")
    if n is None or n < x.shape[1]:
        raise ValueError(f"n (the whole row's width) must be >= d = "
                         f"{x.shape[1]}, got {n}")


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                 ss=None, n=None) -> torch.Tensor:
    """K3 over the rows of ``x`` (rows, d) with ``scale`` (d,), fp32 or
    bf16 alike; any row count, any row stride, unit inner stride.  With
    ``ss`` / ``n``, a block of rows split by columns (the module
    docstring)."""
    _check_shapes(x, scale, ss, n)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, ss, n)
    _check(x, scale)
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    kind, nv = variant(x, scale)
    args = (_DTYPE_CODE[x.dtype], VARIANTS.index(kind), nv, x.data_ptr(),
            x.stride(0), scale.data_ptr(), out.data_ptr(), d, rows, d,
            float(eps))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ss is None:
            err = FAMILY.fn("rmsnorm")(*args, stream)
        else:
            err = FAMILY.symbol("rmsnorm", "rmsnorm_ext",
                                _EXT_ARGS["rmsnorm_ext"])(
                *args, ss.data_ptr(), int(n), stream)
    FAMILY.launched("rmsnorm", err)
    return out


_ROW_BLOCKS: dict = {}      # (device, dtype code, variant, nv, d) -> blocks
                            # an SM


def _bwd_chunks(rows: int, d: int, device: torch.device, kind: str,
                dtype: int, nv: int) -> int:
    """Row chunks of K3b's partial dscale, from the card's streaming
    multiprocessors (SMs).  "warp" and "block": the rows kernel's blocks,
    as many as the card holds at once (``rmsnorm_bwd_blocks_per_sm``, by
    registers and shared memory: one an SM at d = 1152 fp32), so one wave;
    "warp" gives each a contiguous chunk of at least 8 rows (a row a warp),
    "block" of at least one, and each writes a partial row of d floats.
    "loop" / "scalar": enough (column strip of 32, chunk) blocks of the
    partial pass to fill the card (~4 an SM), at least 8 rows each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if kind in ("warp", "block"):
        key = (device.index, dtype, kind, nv, d if kind == "block" else 0)
        if key not in _ROW_BLOCKS:
            out = ctypes.c_int(0)
            query = FAMILY.symbol("rmsnorm_bwd", "rmsnorm_bwd_blocks_per_sm",
                                  [_I, _I, _I, _I,
                                   ctypes.POINTER(ctypes.c_int)])
            with torch.cuda.device(device):
                err = query(dtype, VARIANTS.index(kind), nv, d,
                            ctypes.byref(out))
            if err != 0 or out.value < 1:
                raise RuntimeError(f"rmsnorm_bwd_blocks_per_sm: cudaError "
                                   f"{err}, {out.value} blocks")
            _ROW_BLOCKS[key] = out.value
        per = 8 if kind == "warp" else 1
        return max(1, min(-(-rows // per), _ROW_BLOCKS[key] * sms))
    strips = -(-d // 32)
    return max(1, min(-(-rows // 8), -(-4 * sms // strips), 65535))


def rmsnorm_rows_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6, ss=None, n=None) -> tuple:
    """K3b: the gradient of K3 over the rows of ``x`` (rows, d) for the
    output gradient ``g`` (rows, d).  Returns (dx, dscale), dx contiguous
    in x's dtype, dscale in scale's; with ``ss`` / ``n`` (the module
    docstring), (dx with the statistic held, dscale, dss (rows,) fp32)."""
    _check_shapes(x, scale, ss, n)
    if g.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: g {tuple(g.shape)} is not x's "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, scale, g, eps, ss, n)
    _check(x, scale)
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"g is {g.device} {g.dtype}, expected {x.device} "
                         f"{x.dtype}")
    if g.stride(1) != 1:
        g = g.contiguous()
    rows, d = x.shape
    kind, nv = variant(x, scale, g)
    chunks = _bwd_chunks(rows, d, x.device, kind, _DTYPE_CODE[x.dtype], nv)
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    dscale = torch.empty((d,), dtype=scale.dtype, device=x.device)
    rinv = None if kind in ("warp", "block") else torch.empty(
        (rows,), dtype=torch.float32, device=x.device)
    partial = torch.empty((chunks, d), dtype=torch.float32, device=x.device)
    args = (_DTYPE_CODE[x.dtype], VARIANTS.index(kind), nv, x.data_ptr(),
            x.stride(0), g.data_ptr(), g.stride(0), scale.data_ptr(),
            dx.data_ptr(), None if rinv is None else rinv.data_ptr(),
            partial.data_ptr(), dscale.data_ptr(), rows, d, chunks,
            float(eps))
    dss = None if ss is None else torch.empty(
        (rows,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ss is None:
            err = FAMILY.fn("rmsnorm_bwd")(*args, stream)
        else:
            err = FAMILY.symbol("rmsnorm_bwd", "rmsnorm_bwd_ext",
                                _EXT_ARGS["rmsnorm_bwd_ext"])(
                *args, ss.data_ptr(), dss.data_ptr(), int(n), stream)
    FAMILY.launched("rmsnorm_bwd", err)
    return (dx, dscale) if ss is None else (dx, dscale, dss)
