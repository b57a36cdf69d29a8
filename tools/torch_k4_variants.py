"""K4 ``flash_attention`` at D <= 128 and K3 ``rmsnorm`` beside their
yardsticks on the card: the tensor-core instances of K4 against an earlier
source and SDPA, and K3's variants against ``F.rms_norm``.

    python tools/torch_k4_variants.py                 # needs an NVIDIA GPU
    git show HEAD~1:src/repro_torch/kernels/flash_attention/csrc/\\
flash_attention.cu > build/k4_parent.cu
    python tools/torch_k4_variants.py --against build/k4_parent.cu \
        [--against OTHER.cu ...]
    python tools/torch_k4_variants.py --k3            # K3 only
    python tools/torch_k4_variants.py --k4            # K4 only

K4: the shipped ``kernels/flash_attention/csrc/flash_attention.cu`` and
each ``--against`` source of the same C entry point (an earlier K4, named
by its file; before its instances were chosen on the host its entry point
took no instance argument, which the tool reads off the source) are built
into ``build/k4_variants/`` (one ``nvcc`` each, all at once) and loaded
with ``ctypes``.  At the four served
shapes of the D <= 128
instances (moonshot, zamba2, musicgen, pixtral) and at gemma3-1b's D = 256
layer, with inputs from ``--seed``, every build must hold to
``attention_ref`` within 2e-5 (fp32); then each is timed with SDPA (CUDA
events, 20 launches behind a sleep kernel, two rounds in opposite orders,
the earlier sources first in the first round and last in the second), and
printed beside the fp32 CUDA-core bound, the 3xTF32 bound at the dense
TF32 rate and the same work at the ``mma.sync`` TF32 rate that
``tools/torch_mma_rate.py`` measured (314.8 TFLOP/s).  nvcc's registers
and spills of each tensor-core instance are printed.

K3: through the port's own build of ``rmsnorm.cu``, every variant that
fits each shape (``warp``, ``loop``, and ``block`` at each number of
16-byte vectors a lane, 1 to 8) is held to ``rmsnorm_ref`` (1e-6 x max(1,
|want|)) and timed in turns with ``F.rms_norm`` (50 launches, two rounds),
at the decode shapes (8, d) of the served models, the wide prefill shapes
and the row counts between, and the one ``kernel.variant`` picks is
marked.  Every line carries the card's name and power limit.  Imports
nothing of JAX; exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "flash_attention",
                   "csrc", "flash_attention.cu")
OUT = os.path.join(ROOT, "build", "k4_variants")
# the TF32 rate tools/torch_mma_rate.py measured (NVIDIA H100 80GB HBM3,
# 700 W, four blocks of 256 threads an SM)
MMA_TF32_FLOP_PER_S = 314.8e12
# (label, B, Hq, Hkv, T, D): the served prefill layers, all causal
K4_SHAPES = (("moonshot", 8, 16, 16, 1024, 128),
             ("zamba2", 8, 32, 32, 1024, 112),
             ("musicgen", 8, 32, 32, 1024, 64),
             ("pixtral", 8, 32, 8, 1280, 128),
             ("gemma3-1b", 8, 4, 1, 1024, 256))
K3_SHAPES = ((8, 1152), (32, 256), (8, 2048), (8, 3584), (8, 4096),
             (8, 5120), (8, 7168), (128, 2048), (512, 2048), (1024, 1152),
             (2048, 2048), (4096, 1152), (8192, 1152), (8192, 2048),
             (8192, 3584), (8192, 4096), (8192, 7168), (10240, 5120))
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the C entry point before the instance argument
OLD_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I] \
    + [_L] * 12 + [_F, _I, _I, _P]


def ptxas_of(out: str) -> list:
    """nvcc's ``-Xptxas -v`` registers and spills of each K4 kernel
    instance, named by its template arguments (kernel, dtype, D_MAX, the
    staging mode: 0 cp.async, 1 4-wide loads, 2 element by element)."""
    fn, lines = "", []
    for line in out.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_attention_(tc|kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d+)ELi(\d)E", line)
            fn = "" if m is None else (
                f"{'tc' if m[1] == 'tc' else 'simt'} "
                f"{'fp32' if m[2] == 'f' else 'bf16'} D_MAX {m[3]} mode "
                f"{m[4]}")
        elif fn and ("Used" in line or "spill stores" in line):
            lines.append(f"{fn}: {line.split('info    :')[-1].strip()}")
    return lines


def takes_instance(src: str) -> bool:
    """Whether the source's C entry point takes the instance argument."""
    with open(src) as f:
        return "int dtype, int instance" in f.read()


def build_k4(against: list) -> dict:
    """name -> (entry point, whether it takes the instance argument, nvcc's
    registers and spills) of the shipped source and each of ``against``."""
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.flash_attention.kernel import FAMILY

    os.makedirs(OUT, exist_ok=True)
    jobs = {os.path.splitext(os.path.basename(src))[0]: src
            for src in against}
    jobs["shipped"] = SRC
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o",
         os.path.join(OUT, f"flash_attention_{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in jobs.items()}
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(OUT, f"flash_attention_{name}.so"))
        fn = lib.flash_attention
        new = takes_instance(jobs[name])
        fn.argtypes = FAMILY.argtypes["flash_attention"] if new else \
            OLD_ARGTYPES
        fn.restype = ctypes.c_int
        built[name] = fn, new, ptxas_of(out)
    return built


def time_k4(built: dict, card: str, seed: int) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    for name, (_, _, regs) in built.items():
        for line in regs:
            print(f"K4 {name} {line} [{card}]", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    names = list(built)
    for label, b, hq, hkv, t, d in K4_SHAPES:
        def rand(h):
            return torch.from_numpy(rng.normal(0, 1, (b, h, t, d)).astype(
                np.float32)).to(dev)

        q, k, v = rand(hq), rand(hkv), rand(hkv)
        out = torch.empty_like(q)
        scale = d ** -0.5

        def run(name):
            fn, takes_instance, _ = built[name]
            head = (0, fa.INSTANCES.index(fa.instance(d))) \
                if takes_instance else (0,)
            err = fn(*head, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None, b, hq, hkv, t, t, d,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3], scale, 1, 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=hq != hkv)

        want = attention_ref(q, k, v)
        errs = {}
        for name in names:
            run(name)
            torch.cuda.synchronize()
            errs[name] = float((out - want).abs().max())
            if not errs[name] <= 2e-5:
                raise SystemExit(f"K4 {name} {label}: max |diff| "
                                 f"{errs[name]:.3g} to the plain version")
        sdpa_err = float((sdpa() - want).abs().max())
        del want
        times = {name: [] for name in [*names, "sdpa"]}
        for order in ([*names, "sdpa"], ["sdpa", *names[::-1]]):
            for name in order:
                fn = sdpa if name == "sdpa" else (lambda n=name: run(n))
                times[name].append(cs.time_ms(fn, reps=20))
        pairs = t * (t + 1) / 2 * b * hq
        nbytes = 4.0 * (2 * q.numel() + k.numel() + v.numel())
        fp32_ms, _ = cs.flop_bound(4.0 * pairs * d, nbytes)
        tc_ms, _ = cs.flop_bound(12.0 * pairs * d, nbytes,
                                 cs.TF32_FLOP_PER_S)
        mma_ms = 12.0 * pairs * d / MMA_TF32_FLOP_PER_S * 1e3
        shape = f"({b},{hq},{t},{d}) Hkv {hkv} fp32 causal"
        lib = sum(times["sdpa"]) / 2
        print(f"K4 {label} {shape}: SDPA {lib:.4f} ms ({times['sdpa'][0]:.4f}"
              f", {times['sdpa'][1]:.4f}; max |diff| {sdpa_err:.3g}); bounds"
              f" fp32 {fp32_ms:.4f} ms, 3xTF32 {tc_ms:.4f} ms, at the "
              f"mma.sync rate {mma_ms:.4f} ms [{card}]", flush=True)
        for name in names:
            ms = sum(times[name]) / 2
            inst = fa.instance(d) if built[name][1] else "no instance arg"
            runs = ", ".join(f"{x:.4f}" for x in times[name])
            print(f"K4 {label} {name} ({inst}): {ms:.4f} ms ({runs}), "
                  f"{ms / lib:.3f}x SDPA, {tc_ms / ms:.1%} of the 3xTF32 "
                  f"bound, {fp32_ms / ms:.1%} of the fp32 bound, max |diff| "
                  f"{errs[name]:.3g} [{card}]", flush=True)
        del q, k, v, out


def k3_candidates(rows: int, d: int) -> list:
    """(variant, nv) that fit an aligned fp32 (rows, d)."""
    from repro_torch.kernels.rmsnorm import kernel as rn

    nvec = d // 4
    out = [("warp", -(-nvec // 32))] if d <= rn.D_MAX else [("loop", 0)]
    for nv in range(1, rn.BLOCK_NV + 1):
        if -(-nvec // (32 * nv)) <= rn.BLOCK_WARPS \
                and (nv == 1 or -(-nvec // (32 * (nv - 1))) >
                     -(-nvec // (32 * nv))):
            out.append(("block", nv))
    return out


def time_k3(card: str, seed: int) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    fn = rn.FAMILY.fn("rmsnorm")
    for rows, d in K3_SHAPES:
        x = torch.from_numpy(rng.normal(0, 2, (rows, d)).astype(
            np.float32)).to(dev)
        s = torch.from_numpy(rng.normal(0, 0.1, (d,)).astype(
            np.float32)).to(dev)
        w = 1.0 + s
        out = torch.empty_like(x)
        want = rmsnorm_ref(x, s, 1e-6)
        cands = k3_candidates(rows, d)
        picked = rn.variant(x, s)

        def run(c):
            err = fn(0, rn.VARIANTS.index(c[0]), c[1], x.data_ptr(), d,
                     s.data_ptr(), out.data_ptr(), d, rows, d, 1e-6,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K3 {c}: cudaError {err}")

        for c in cands:
            run(c)
            torch.cuda.synchronize()
            bad = (out - want).abs() > 1e-6 * want.abs().clamp_min(1.0)
            if bool(bad.any()):
                raise SystemExit(f"K3 {c} ({rows}, {d}): max |diff| "
                                 f"{float((out - want).abs().max()):.3g}")
        lib = lambda: F.rms_norm(x, (d,), w, 1e-6)       # noqa: E731
        keys = [*cands, "F.rms_norm"]
        times = {c: [] for c in keys}
        for order in (keys, keys[::-1]):
            for c in order:
                f = lib if c == "F.rms_norm" else (lambda c=c: run(c))
                times[c].append(cs.time_ms(f, reps=50))
        b_ms, _ = cs.flop_bound(4.0 * x.numel(), 4.0 * (2 * x.numel() + d))
        lib_ms = sum(times["F.rms_norm"]) / 2
        cols = [f"F.rms_norm {lib_ms:.4f}"]
        for c in cands:
            ms = sum(times[c]) / 2
            tag = f"{c[0]}{c[1] if c[0] == 'block' else ''}"
            if c == picked:
                tag = f"*{tag}"
            cols.append(f"{tag} {ms:.4f} ({ms / lib_ms:.2f}x, "
                        f"{b_ms / ms:.0%})")
        print(f"K3 ({rows}, {d}) fp32 ms, bytes bound {b_ms:.5f}: "
              f"{'; '.join(cols)} [{card}]", flush=True)
        del x, out, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another K4 source to time beside the shipped "
                         "(repeatable)")
    ap.add_argument("--k3", action="store_true", help="time K3 only")
    ap.add_argument("--k4", action="store_true", help="time K4 only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k4_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if not args.k3:
        time_k4(build_k4(args.against), card, args.seed)
    if not args.k4:
        time_k3(card, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
