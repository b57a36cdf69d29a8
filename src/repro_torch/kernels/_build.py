"""One way to build and bind the port's hand-written CUDA kernels.

Every kernel family (``minplus``, ``rmsnorm``, ``flash_attention``,
``selective_scan``) keeps its sources in its own ``csrc/`` and describes
them with a :class:`KernelFamily`: the C entry point of each source (named
like the kernel), its ``ctypes`` argument types, a launch counter per
kernel and nvcc's report of each build.

At first use each source is compiled by its own ``nvcc`` process into a
shared library with a plain C interface under ``build/kernels/`` of the
checkout, named by the hash of its source and flags, and loaded with
``ctypes``.  :func:`build` starts one ``nvcc`` per missing source of every
family it is given, all at once, then waits for them.  Nothing is built or
loaded at import.

The C entry point of every kernel returns the launch's ``cudaError_t`` as
an int; :meth:`KernelFamily.launched` raises on a non-zero one and only
then counts the launch.
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

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "KernelFamily", "build"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return found


class KernelFamily:
    """The CUDA sources of one kernel package and their loaded libraries.

    ``sources`` maps each kernel's name (also the name of its C entry point)
    to its file in ``csrc``; ``argtypes`` maps it to the entry point's
    ``ctypes`` argument types.
    """

    def __init__(self, csrc: Path, sources: dict, argtypes: dict):
        self.csrc = Path(csrc)
        self.sources = dict(sources)
        self.argtypes = dict(argtypes)
        self.launches = {name: 0 for name in self.sources}
        self.build_log: dict = {}     # name -> nvcc's output (regs / spills)
        self._libs: dict = {}

    def reset_launches(self) -> None:
        for name in self.launches:
            self.launches[name] = 0

    def target(self, name: str) -> Path:
        src = self.csrc / self.sources[name]
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"

    def build(self, names=None) -> float:
        """Compile (when not already built) and load the named kernels of
        this family.  Returns seconds."""
        return build((self, names))

    def fn(self, name: str):
        """The loaded C entry point of kernel ``name`` (built on first use)."""
        if name not in self._libs:
            self.build([name])
        return getattr(self._libs[name], name)

    def symbol(self, name: str, symbol: str, argtypes: list):
        """Another C entry point ``symbol`` of kernel ``name``'s library
        (built on first use), with its ``ctypes`` argument types."""
        self.fn(name)
        fn = getattr(self._libs[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def launched(self, name: str, err: int) -> None:
        """Raise on a refused or failed launch; count a good one."""
        if err != 0:
            raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                               f"cudaError {err}")
        self.launches[name] += 1


def build(*families) -> float:
    """Compile and load every kernel of the given families, one ``nvcc``
    process per source that is not yet built, all running at once.

    Each argument is a :class:`KernelFamily` or a ``(family, names)`` pair
    (``names`` None = all of its kernels).  Returns seconds.
    """
    t0 = time.perf_counter()
    todo = []
    for item in families:
        fam, names = item if isinstance(item, tuple) else (item, None)
        todo += [(fam, n) for n in (names or fam.sources)]
    with _lock:
        todo = [(fam, n) for fam, n in todo if n not in fam._libs]
        procs = []
        for fam, name in todo:
            so = fam.target(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs.append((fam, name, so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(fam.csrc / fam.sources[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for fam, name, so, tmp, proc in procs:
            out, _ = proc.communicate()
            fam.build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {fam.sources[name]}:\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        for fam, name in todo:
            lib = ctypes.CDLL(str(fam.target(name)))
            fn = getattr(lib, name)
            fn.argtypes = fam.argtypes[name]
            fn.restype = ctypes.c_int
            fam._libs[name] = lib
    return time.perf_counter() - t0
