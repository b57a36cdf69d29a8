"""The tensor-core rate that ``mma.sync`` reaches on this card, the ceiling of
K4b (``flash_attention_bwd``), which runs every product as
``mma.sync.m16n8k8`` TF32 (three of them per fp32 product, 3xTF32).

    python tools/torch_mma_rate.py

Compiles a microbenchmark into ``build/mma_rate/`` with the port's nvcc
flags: each warp issues 8 independent chains of ``mma.sync`` on register
operands (no memory traffic), TF32 m16n8k8 and, for scale, bf16 m16n8k16.
Times it by CUDA events at 1, 2 and 4 blocks of 256 threads an SM and
prints the dense TFLOP/s of each, beside the card's name and power limit.
Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cuda_runtime.h>
template <int K>
__global__ void rate(float* out, int iters) {
  const unsigned a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const unsigned b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (K == 8)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(int k, float* out, int blocks, int iters) {
  if (k == 8) rate<8><<<blocks, 256>>>(out, iters);
  else rate<16><<<blocks, 256>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mma_rate: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc

    out_dir = os.path.join(ROOT, "build", "mma_rate")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, n)
                     for n in ("mma_rate.cu", "mma_rate.so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.mma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(4 * sms * 256, device="cuda")
    iters = 4096
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for k, name in ((8, "tf32 m16n8k8"), (16, "bf16 m16n8k16")):
        for per_sm in (1, 2, 4):
            blocks = per_sm * sms
            for _ in range(2):                      # warm-up, then timed
                torch.cuda.synchronize()
                start.record()
                err = lib.mma_rate(k, out.data_ptr(), blocks, iters)
                end.record()
                torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"mma_rate launch: cudaError {err}")
            ms = start.elapsed_time(end)
            flop = blocks * 8 * iters * 8 * 2 * 16 * 8 * k
            print(f"mma.sync {name}: {per_sm} block(s) of 256 an SM, "
                  f"{ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
