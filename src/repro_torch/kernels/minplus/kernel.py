"""Hand-written CUDA kernels of the min-plus family: build, binding, wrappers.

Two kernels, sources in ``csrc/`` (each file carries its design note):

* ``minplus_acc`` (K1) -- ``out[b] = min(init[b], A[b] ⊗ B[b])``, fp32 or
  bf16.  Serves the batched and unbatched Pallas products and the three
  min-plus bodies (row panel, column panel, outer update) of the Pallas
  blocked Floyd-Warshall.
* ``fw_tile`` (K2) -- Floyd-Warshall closure of one T x T diagonal tile,
  T <= 256, in one thread block.

At first use each source is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface under
``build/kernels/`` of the checkout, named by the hash of its source, and
loaded with ``ctypes``.  Nothing is built or loaded at import.

The wrappers take the plain version in ``ref.py`` for a CPU tensor, and
launch the kernel for a CUDA tensor -- or raise: there is no fallback.
They check device, dtype, shape and unit inner stride, allocate outputs
with ``torch.empty``, launch on the current stream without synchronising,
raise on a non-zero ``cudaGetLastError``, and count launches in
:data:`launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .ref import fw_tile_ref, minplus_acc_ref

__all__ = ["SOURCES", "build", "build_log", "launches", "reset_launches",
           "minplus_acc", "fw_tile", "FW_TILE_MAX"]

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = {"minplus_acc": "minplus_acc.cu", "fw_tile": "fw_tile.cu"}
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FW_TILE_MAX = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "minplus_acc": [_I, _P, _P, _P, _P, _I, _I, _I, _I,
                    _L, _I, _L, _I, _L, _I, _L, _I, _P],
    "fw_tile": [_I, _P, _I, _P, _I, _I, _P],
}

launches = {name: 0 for name in SOURCES}
build_log: dict = {}     # name -> nvcc's output (register / spill report)
_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the min-plus CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> float:
    """Compile (when not already built) and load the named kernels, one
    ``nvcc`` process per source, all running at once.  Returns seconds."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in (names or SOURCES) if n not in _libs]
        procs = {}
        for name in todo:
            so = _target(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (so, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{out}")
            os.replace(tmp, so)
        for name in todo:
            lib = ctypes.CDLL(str(_target(name)))
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return time.perf_counter() - t0


def _fn(name: str):
    if name not in _libs:
        build([name])
    return getattr(_libs[name], name)


def _check_operand(what: str, x: torch.Tensor, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{what} has dtype {x.dtype}, expected {dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"{what} needs unit stride in its last dimension")


def _shares_storage(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    launches[name] += 1


def minplus_acc(a: torch.Tensor, b: torch.Tensor,
                init: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """K1: ``out[b] = min(init[b], a[b] ⊗ b[b])`` for (B, M, K) x (B, K, N).

    fp32 or bf16 (all operands alike).  ``init`` (B, M, N) may be omitted
    (+inf).  ``out`` must be contiguous and must not share storage with
    ``a`` or ``b`` -- the product is taken against frozen operands -- but
    may be ``init`` itself (an in-place update).
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
    fn = _fn("minplus_acc")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        ip = init.data_ptr() if init is not None else None
        si, ldi = (init.stride(0), init.stride(1)) if init is not None \
            else (0, n)
        err = fn(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(), ip,
                 out.data_ptr(), bsz, m, k, n,
                 a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                 si, ldi, out.stride(0), out.stride(1), stream)
    _launch("minplus_acc", err)
    return out


def fw_tile(d: torch.Tensor) -> torch.Tensor:
    """K2: Floyd-Warshall closure of one (T, T) tile, T <= 256, fp32 or
    bf16, into a new contiguous tensor (``d`` is left as it was)."""
    if d.dim() != 2 or d.shape[0] != d.shape[1] or d.shape[0] < 1:
        raise ValueError(f"fw_tile needs a square tile, got {tuple(d.shape)}")
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
    fn = _fn("fw_tile")
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(_DTYPE_CODE[d.dtype], d.data_ptr(), d.stride(0),
                 out.data_ptr(), t, t, stream)
    _launch("fw_tile", err)
    return out
