"""Hand-written CUDA kernels of the min-plus family: build, binding, wrappers.

Two kernels, sources in ``csrc/`` (each file carries its design note):

* ``minplus_acc`` (K1) -- ``out[b] = min(init[b], A[b] ⊗ B[b])``, fp32 or
  bf16.  Serves the batched and unbatched Pallas products and the three
  min-plus bodies (row panel, column panel, outer update) of the Pallas
  blocked Floyd-Warshall.  Its output tile (128 or 64) and its number of
  k chunks (split K) are chosen per shape on the host by :func:`variant`.
* ``fw_tile`` (K2) -- Floyd-Warshall closure of one T x T diagonal tile,
  T <= 256, by one thread-block cluster of :data:`FW_TILE_CLUSTER` CTAs
  that holds the tile in registers, reads the pivot rows through
  distributed shared memory and crosses one cluster barrier per
  :data:`FW_TILE_PIVOTS` pivots.

Both are built and bound by the port's shared builder
(``repro_torch.kernels._build``): one ``nvcc`` per source into
``build/kernels/``, loaded with ``ctypes`` at first use, never at import.

The wrappers take the plain version in ``ref.py`` for a CPU tensor, and
launch the kernel for a CUDA tensor -- or raise: there is no fallback.
They check device, dtype, shape and unit inner stride, allocate outputs
with ``torch.empty``, launch on the current stream without synchronising,
raise on a non-zero ``cudaGetLastError``, and count launches in
:data:`launches`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...roofline.walk import Work
from .._build import KernelFamily
from .ref import fw_tile_ref, minplus_acc_ref

__all__ = ["SOURCES", "build", "build_log", "launches", "reset_launches",
           "minplus_acc", "variant", "MINPLUS_VARIANTS", "MINPLUS_BK", "SMS",
           "fw_tile", "fw_tile_variant",
           "cluster_barrier_cycles", "FW_TILE_MAX", "FW_TILE_CLUSTER",
           "FW_TILE_PIVOTS", "FW_TILE_VARIANTS", "work", "fw_tile_work"]

SOURCES = {"minplus_acc": "minplus_acc.cu", "fw_tile": "fw_tile.cu"}
FW_TILE_MAX = 256
# The (cluster size, pivots per barrier) pairs fw_tile.cu is built for, and
# the pair K2 runs: the fastest on the H100 (PERF.md section 6).
FW_TILE_VARIANTS = tuple((c, p) for c in (2, 4, 8, 16) for p in (1, 2, 4)
                         if (c, p) != (2, 4))
FW_TILE_CLUSTER = 8
FW_TILE_PIVOTS = 4

# K1's (output tile, k chunks) pairs, minplus_acc.cu's slice of k, and the
# SMs of the card variant() fills (an H100 SXM).
MINPLUS_VARIANTS = tuple((t, s) for t in (128, 64) for s in (1, 2, 4, 8))
MINPLUS_BK = 16
SMS = 132

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FAMILY = KernelFamily(
    Path(__file__).resolve().with_name("csrc"), SOURCES, {
        "minplus_acc": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _L, _I, _L, _I, _L, _I, _L, _I, _P],
        "fw_tile": [_I, _I, _I, _P, _I, _P, _I, _I, _P],
    })
launches = FAMILY.launches
build_log = FAMILY.build_log       # name -> nvcc's register / spill report
build = FAMILY.build
reset_launches = FAMILY.reset_launches


def work(batch: int, m: int, k: int, n: int, init: bool = True,
         dtype=torch.float32) -> Work:
    """K1's work on (B, M, K) x (B, K, N): B M K N relaxations, each two
    instructions (add, min) at an FMA's rate, so four FLOP's worth; a and b
    read, ``init`` read where given and the output written once."""
    size = torch.empty((), dtype=dtype).element_size()
    relax = float(batch) * m * k * n
    return Work(4.0 * relax, size * (float(batch) * (m * k + k * n)
                                     + (2 if init else 1) * batch * m * n))


def fw_tile_work(t: int) -> Work:
    """K2's work on a T x T fp32 tile: T^3 relaxations (four FLOP's worth
    each), the tile read and written once."""
    return Work(4.0 * float(t) ** 3, 4.0 * 2 * t * t)


def _check_operand(what: str, x: torch.Tensor, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{what} has dtype {x.dtype}, expected {dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"{what} needs unit stride in its last dimension")


def _shares_storage(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _chunks(k: int, splits: int) -> int:
    """The k chunks a launch asked for ``splits`` makes: ceil(slices /
    splits) whole slices each, so that none is empty."""
    slices = _cdiv(k, MINPLUS_BK)
    return _cdiv(slices, _cdiv(slices, min(splits, slices)))


def variant(batch: int, m: int, k: int, n: int) -> tuple:
    """K1's (output tile, k chunks) for a (batch, m, k) x (batch, k, n)
    product: the 128 x 128 tile when it gives at least two blocks per SM
    (two fit an SM); else the 64 x 64 tile, with k cut into the fewest
    chunks (of at least two slices each, at most 8) that give a block per
    SM.  The rule follows the H100 sweep of every variant at the paths'
    shapes (PERF.md section 6).  The chunk count is that of the launch."""
    if batch * _cdiv(m, 128) * _cdiv(n, 128) >= 2 * SMS:
        return 128, 1
    blocks = batch * _cdiv(m, 64) * _cdiv(n, 64)
    splits = 1
    while blocks * splits < SMS and \
            2 * splits <= min(8, _cdiv(k, MINPLUS_BK) // 2):
        splits *= 2
    return 64, _chunks(k, splits)


def minplus_acc(a: torch.Tensor, b: torch.Tensor,
                init: torch.Tensor | None = None,
                out: torch.Tensor | None = None,
                choice: tuple | None = None) -> torch.Tensor:
    """K1: ``out[b] = min(init[b], a[b] ⊗ b[b])`` for (B, M, K) x (B, K, N).

    fp32 or bf16 (all operands alike).  ``init`` (B, M, N) may be omitted
    (+inf).  ``out`` must be contiguous and must not share storage with
    ``a`` or ``b`` -- the product is taken against frozen operands -- but
    may be ``init`` itself (an in-place update).  ``choice``: a (tile, k
    chunks) pair of :data:`MINPLUS_VARIANTS` in place of :func:`variant`'s
    choice (what ``chip_smoke.py`` times); every pair gives the same bits.

    With more than one k chunk a call launches two kernels, the chunks'
    product and their combine; :data:`launches` counts the call once, and
    ``chip_smoke.py`` times the two together.
    """
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"minplus_acc shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    bsz, m, k = a.shape
    n = b.shape[2]
    if min(bsz, m, k, n) < 1:
        raise ValueError(f"minplus_acc needs non-empty operands, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if init is not None and tuple(init.shape) != (bsz, m, n):
        raise ValueError(f"init has shape {tuple(init.shape)}, expected "
                         f"{(bsz, m, n)}")
    if out is not None:
        if tuple(out.shape) != (bsz, m, n) or not out.is_contiguous():
            raise ValueError("out must be a contiguous (B, M, N) tensor")
        if _shares_storage(out, a) or _shares_storage(out, b):
            raise ValueError("out must not alias a or b (frozen operands)")
    if choice is not None and tuple(choice) not in MINPLUS_VARIANTS:
        raise ValueError(f"minplus_acc is built for (tile, k chunks) in "
                         f"{MINPLUS_VARIANTS}, got {choice}")
    if a.device.type == "cpu":
        res = minplus_acc_ref(a, b, init)
        return res if out is None else out.copy_(res)
    if a.device.type != "cuda" or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"minplus_acc runs on CUDA fp32/bf16 tensors, got "
                         f"{a.device} {a.dtype}")
    for what, x in (("b", b), ("init", init), ("out", out)):
        if x is not None:
            _check_operand(what, x, a.dtype, a.device)
    _check_operand("a", a, a.dtype, a.device)
    if out is None:
        out = torch.empty((bsz, m, n), dtype=a.dtype, device=a.device)
    if choice is None:
        side, splits = variant(bsz, m, k, n)
    else:
        side, splits = choice[0], _chunks(k, choice[1])
    ws = torch.empty((splits, bsz, m, n), dtype=torch.float32,
                     device=a.device) if splits > 1 else None
    fn = FAMILY.fn("minplus_acc")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        ip = init.data_ptr() if init is not None else None
        si, ldi = (init.stride(0), init.stride(1)) if init is not None \
            else (0, n)
        err = fn(_DTYPE_CODE[a.dtype], side, splits, a.data_ptr(),
                 b.data_ptr(), ip, out.data_ptr(),
                 ws.data_ptr() if ws is not None else None, bsz, m, k, n,
                 a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                 si, ldi, out.stride(0), out.stride(1), stream)
    FAMILY.launched("minplus_acc", err)
    return out


def fw_tile(d: torch.Tensor) -> torch.Tensor:
    """K2: Floyd-Warshall closure of one (T, T) tile, T <= 256, fp32 or
    bf16, into a new contiguous tensor (``d`` is left as it was)."""
    return fw_tile_variant(d, FW_TILE_CLUSTER, FW_TILE_PIVOTS)


def fw_tile_variant(d: torch.Tensor, cluster: int,
                    pivots: int) -> torch.Tensor:
    """K2 as :func:`fw_tile`, on a cluster of ``cluster`` CTAs crossing one
    barrier per ``pivots`` pivots (a pair of :data:`FW_TILE_VARIANTS`):
    what ``chip_smoke.py`` times to choose :data:`FW_TILE_CLUSTER` and
    :data:`FW_TILE_PIVOTS`.  A cluster the card cannot schedule raises."""
    if d.dim() != 2 or d.shape[0] != d.shape[1] or d.shape[0] < 1:
        raise ValueError(f"fw_tile needs a square tile, got {tuple(d.shape)}")
    if (cluster, pivots) not in FW_TILE_VARIANTS:
        raise ValueError(f"fw_tile is built for (clusters, pivots per "
                         f"barrier) in {FW_TILE_VARIANTS}, got "
                         f"{(cluster, pivots)}")
    t = d.shape[0]
    if d.device.type == "cpu":
        return fw_tile_ref(d)
    if d.device.type != "cuda" or d.dtype not in _DTYPE_CODE:
        raise ValueError(f"fw_tile runs on CUDA fp32/bf16 tensors, got "
                         f"{d.device} {d.dtype}")
    if t > FW_TILE_MAX:
        raise ValueError(f"fw_tile supports T <= {FW_TILE_MAX}, got {t}")
    _check_operand("d", d, d.dtype, d.device)
    out = torch.empty((t, t), dtype=d.dtype, device=d.device)
    fn = FAMILY.fn("fw_tile")
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(_DTYPE_CODE[d.dtype], cluster, pivots, d.data_ptr(),
                 d.stride(0), out.data_ptr(), t, t, stream)
    FAMILY.launched("fw_tile", err)
    return out


def cluster_barrier_cycles(cluster: int, iters: int = 100_000,
                           remote: bool = False, device=None) -> tuple:
    """(SM cycles, ns) per cluster barrier of a ``cluster``-CTA cluster of
    K2's shape, from ``iters`` back-to-back barriers on the card (the
    barrier term of K2's chain floor).  ``remote``: each barrier is
    followed by K2's read of a pivot row from another CTA's shared memory.
    Not a kernel of any path: counts no launch."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    res = torch.zeros(3, dtype=torch.int64, device=dev)
    fn = FAMILY.symbol("fw_tile", "fw_tile_barrier_probe",
                       [_I, _I, _I, _P, _P])
    with torch.cuda.device(dev):
        err = fn(cluster, iters, int(remote), res.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cluster barrier probe ({cluster} CTAs) failed "
                           f"to launch: cudaError {err}")
    cycles, ns, _ = res.tolist()
    return cycles / iters, ns / iters
