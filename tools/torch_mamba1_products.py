"""Each of a Mamba1 layer's seven products at falcon-mamba-7b's prefill shape,
timed, with the device kernels each launches named: which projection cuBLAS
runs as a SIMT SGEMM, and what it costs beside the others.

    python tools/torch_mamba1_products.py        # needs an NVIDIA GPU

B = 8, S = 1024 at full width; one layer's weights from a torch Generator
seeded 6 (``mamba.init_mamba1``), x unit normals; each product's operands
are formed as ``mamba1_apply`` forms them.  Prints, per product, its
operands' shapes and strides, its ms by CUDA events (``chip_smoke.time_ms``)
and the kernels ``torch.profiler`` saw it launch (up to three captures,
since one has come back empty), beside the card's name and power limit.
fp32 with TF32 off, as the port serves.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mamba1_products: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.models import mamba

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = get_arch("falcon-mamba-7b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    p = mamba.init_mamba1(gen, cfg, torch.float32, dev)
    x = torch.randn((cs.SSM["batch"], cs.SSM["prompt_len"], cfg.d_model),
                    generator=gen, device=dev)
    with torch.no_grad():
        xin = x @ p["wx"]
        xc = F.silu(mamba._causal_conv(xin, p["conv_w"], p["conv_b"],
                                       None)[0])
        products = (("x @ wx", x, p["wx"]), ("x @ wz", x, p["wz"]),
                    ("xc @ w_dt", xc, p["w_dt"]),
                    ("(xc @ w_dt) @ dt_w", xc @ p["w_dt"], p["dt_w"]),
                    ("xc @ w_b", xc, p["w_b"]), ("xc @ w_c", xc, p["w_c"]),
                    ("y @ out_proj", torch.randn_like(xin), p["out_proj"]))
        for label, lhs, w in products:
            ms = cs.time_ms(lambda: lhs @ w, reps=5)
            kernels = []
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        lhs @ w
                    torch.cuda.synchronize()
                kernels = sorted({e.key[:90] for e in prof.key_averages()
                                  if e.self_device_time_total > 0})
                if kernels:
                    break
            print(f"{label}: {tuple(lhs.shape)} strides {lhs.stride()} @ "
                  f"{tuple(w.shape)} strides {w.stride()}: {ms:.3f} ms; "
                  f"kernels "
                  f"{kernels or 'not seen by the profiler in 3 captures'} "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
