"""K6 ``decode_attention`` beside an earlier source, its own variants and
SDPA at every served decode shape, on cold caches; and K3b
``rmsnorm_bwd``'s variants beside autograd of ``F.rms_norm``.

    python tools/torch_k6_variants.py                 # needs an NVIDIA GPU
    git show HEAD~1:src/repro_torch/kernels/decode_attention/csrc/\\
decode_attention.cu > build/k6_parent.cu
    python tools/torch_k6_variants.py --against build/k6_parent.cu \\
        [--variants] [--clusters] [--k6 | --k3b]

K6: the shipped ``kernels/decode_attention/csrc/decode_attention.cu``,
with ``--variants`` the same source under other ``-D K6_*`` knobs
(``VARIANTS``: a ring of two stages instead of three), and each ``--against`` source (an earlier K6, whose C entry
point took split scratch instead of a cluster size: the tool reads which
off the source and splits as that K6's wrapper did) are built into
``build/k6_variants/`` (one ``nvcc`` each, all at once) and loaded with
``ctypes``.  At each served decode shape (``SHAPES``: pixtral-12b at S
1312 and 8192, musicgen-large, moonshot-v1-16b-a3b, zamba2-7b's shared
block, gemma3-1b's global and local layers, and two probes of a short
cache's fixed cost) and cache dtype (fp32, bf16,
float8_e4m3fn), with inputs from ``--seed``, every build must hold to
``decode_attention_ref`` within 1e-5 x max |want| and repeat bitwise; then
each is timed with SDPA on the cache widened to fp32 (CUDA events, 20
launches behind a sleep kernel, two rounds in opposite orders, the earlier
sources first in the first round and last in the second).  Every timed
call reads its cache cold: the calls walk copies of it, more than 64 MB in
all (the L2 holds 50 MB).  Each time is printed beside its bytes bound
(the live slots' rows of the cache read once in its dtype, q read and the
output written in fp32, at 3.35 TB/s).  ``--clusters`` also times the shipped build at every
(warps a CTA, cluster size) the card takes, the wrapper's pick marked, and
prints the CTAs and clusters the card holds at once.  nvcc's
registers and spills of each instance are printed.

K3b (``--k3b``, or by default after K6): through the port's own build of
``rmsnorm_bwd.cu``, "block" at each number of vectors a lane that fits,
"loop" and, at d <= 2048, "warp", held to ``rmsnorm_bwd_ref`` (dx 1e-5 x
max |want|) and timed in turns with autograd of ``F.rms_norm`` (50
launches, two rounds) at the SSM training widths (4096, 3584 / 4096 /
7168) and gemma3-1b's (4096, 1152) and (16384, 256); the one
``kernel.variant`` picks is marked.  Every line carries the card's name
and power limit.  Imports nothing of JAX; exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import re
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "decode_attention",
                   "csrc", "decode_attention.cu")
OUT = os.path.join(ROOT, "build", "k6_variants")
# name -> -D macros of the shipped source
VARIANTS = {"stages2": {"K6_STAGES": 2}}
# (label, B, Hq, Hkv, S, D, window, pos): every served decode shape
SHAPES = (("pixtral", 8, 32, 8, 1312, 128, None, 1311),
          ("pixtral-8k", 8, 32, 8, 8192, 128, None, 8191),
          ("musicgen", 8, 32, 32, 1312, 64, None, 1311),
          ("moonshot", 8, 16, 16, 1056, 128, None, 1055),
          ("zamba2", 8, 32, 32, 1056, 112, None, 1055),
          ("gemma3-global", 8, 4, 1, 1056, 256, None, 1055),
          ("gemma3-local", 8, 4, 1, 512, 256, 512, 1055),
          # probes of what a short cache costs, at pixtral's heads: one
          # tile a warp, and one live slot (every other tile skipped and
          # zero-filled without a read): launch, prologue and merge
          ("probe-1tile", 8, 32, 8, 512, 128, None, 511),
          ("probe-pos0", 8, 32, 8, 1312, 128, None, 0))
K3B_SHAPES = ((4096, 3584), (4096, 4096), (4096, 7168), (4096, 1152),
              (16384, 256))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry point before clusters: split scratch, chunk and splits
OLD_ARGTYPES = [_I] + [_P] * 6 + [_I] * 9 + [_F, _P]
COLD_BYTES = 64_000_000


def old_splits(n_bh: int, s: int, sms: int) -> tuple:
    """(chunk, splits) as the split-and-merge K6's wrapper chose them."""
    if s <= 64:
        return s, 1
    want = max(1, -(-16 * sms // n_bh))
    chunk = max(64, -(-s // want))
    chunk = -(-chunk // 32) * 32
    return chunk, -(-s // chunk)


def ptxas_of(out: str) -> list:
    """nvcc's ``-Xptxas -v`` registers, spills and shared memory of each K6
    kernel instance."""
    fn, lines = "", []
    for line in out.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"decode_attention_kernel\w*?I(f|13__nv_bfloat16|"
                          r"\w*Fp8\w*?)Li(\d+)E", line)
            fn = "" if m is None else (
                f"{ {'f': 'fp32', '13__nv_bfloat16': 'bf16'}.get(m[1], 'fp8')}"
                f" DP {m[2]}")
        elif fn and ("Used" in line or "spill stores" in line):
            lines.append(f"{fn}: {line.split('info    :')[-1].strip()}")
    return lines


def build_k6(against: list, variants: bool) -> dict:
    """name -> (entry point, limits query or None for an earlier K6,
    nvcc's report) of the shipped source, its variants and ``against``."""
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.decode_attention.kernel import FAMILY

    os.makedirs(OUT, exist_ok=True)
    jobs = {os.path.splitext(os.path.basename(src))[0]: (src, {})
            for src in against}
    jobs["shipped"] = (SRC, {})
    if variants:
        jobs.update({name: (SRC, macros) for name, macros in VARIANTS.items()})
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in macros.items()),
         "-o", os.path.join(OUT, f"k6_{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, macros) in jobs.items()}
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(OUT, f"k6_{name}.so"))
        fn = lib.decode_attention
        fn.restype = ctypes.c_int
        limits = None
        if hasattr(lib, "decode_attention_limits"):
            fn.argtypes = FAMILY.argtypes["decode_attention"]
            limits = lib.decode_attention_limits
            limits.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
            limits.restype = ctypes.c_int
        else:
            fn.argtypes = OLD_ARGTYPES
        built[name] = fn, limits, ptxas_of(out)
    return built


def time_k6(built: dict, card: str, seed: int, clusters: bool) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import to_cache_dtype

    for name, (_, _, regs) in built.items():
        for line in regs:
            print(f"K6 {name} {line} [{card}]", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(seed)
    stream = torch.cuda.current_stream().cuda_stream
    for label, b, hq, hkv, s, d, window, pos in SHAPES:
        q = torch.from_numpy(rng.normal(0, 1, (b, hq, 1, d)).astype(
            np.float32)).to(dev)
        kv = torch.from_numpy(rng.normal(0, 2, (2, b, hkv, s, d)).astype(
            np.float32)).to(dev)
        g, n_bh = hq // hkv, b * hkv
        for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            code = (torch.float32, torch.bfloat16,
                    torch.float8_e4m3fn).index(dt)
            k, v = (to_cache_dtype(x, dt) for x in kv)
            size = 2.0 * k.numel() * k.element_size() + 8.0 * q.numel()
            n_rot = max(2, -(-COLD_BYTES // int(size)) + 1)
            # the bound counts the live slots' rows only (the kernel reads
            # no other): min(S, pos + 1, window)
            n_live = min(s, pos + 1, window or s)
            nbytes = 2.0 * b * hkv * n_live * d * k.element_size() \
                + 8.0 * q.numel()
            copies = [(k, v)] + [(k.clone(), v.clone())
                                 for _ in range(n_rot - 1)]
            out = torch.empty_like(q)
            want = decode_attention_ref(q, k, v, pos, window)
            tile = da.tile(d, k.element_size())
            runs = {}
            for name, (fn, limits, _) in built.items():
                if limits is None:
                    chunk, n_split = old_splits(n_bh, s, sms)
                    ml = torch.empty((n_split, b * hq, 2), device=dev)
                    acc = torch.empty((n_split, b * hq, d), device=dev)
                    choices = [("", (ml.data_ptr(), acc.data_ptr(), b, hkv,
                                     g, d, s, pos, window or 0, chunk,
                                     n_split))]
                else:
                    resident = {}
                    for w in da.WARPS:
                        ctas, held = ctypes.c_int(0), (ctypes.c_int * 4)()
                        if limits(code, d, w, ctypes.byref(ctas), held):
                            raise SystemExit(f"K6 {name}: limits query "
                                             f"failed")
                        resident[w] = {1: ctas.value * sms,
                                       **{2 << i: held[i] for i in range(4)}}
                    pick = da.launch_shape(n_bh, s, tile, resident)
                    shapes = [pick]
                    if clusters and name == "shipped":
                        shapes = [(w, c) for w in da.WARPS
                                  for c in (1, 2, 4, 8, 16)
                                  if resident[w][c] > 0]
                        print(f"K6 {label} {str(dt)[6:]} {name}: CTAs (at "
                              f"1) and clusters the card holds at once, by "
                              f"warps a CTA {resident} [{card}]", flush=True)
                    choices = [(f" W{w} C{c}{'*' if (w, c) == pick else ''}",
                                (b, hkv, g, d, s, pos, window or 0, c, w))
                               for w, c in shapes]
                for tag, args in choices:
                    turn = itertools.cycle(copies)

                    def run(fn=fn, args=args, turn=turn):
                        kk, vv = next(turn)
                        err = fn(code, q.data_ptr(), kk.data_ptr(),
                                 vv.data_ptr(), out.data_ptr(), *args,
                                 float(d ** -0.5), stream)
                        if err:
                            raise RuntimeError(f"cudaError {err}")

                    for _ in range(n_rot):
                        run()
                    torch.cuda.synchronize()
                    first = out.clone()
                    for _ in range(n_rot):
                        run()
                    torch.cuda.synchronize()
                    err = float((out - want).abs().max())
                    if not err <= 1e-5 * float(want.abs().max()) \
                            or not torch.equal(first, out):
                        raise SystemExit(
                            f"K6 {name}{tag} {label} {dt}: max |diff| "
                            f"{err:.3g} to the plain version, or two calls "
                            f"differ")
                    runs[name + tag] = (run, err)
            lib_turn = itertools.cycle(copies)
            back = torch.remainder(pos % s - torch.arange(s, device=dev), s)
            live = ((back <= pos) & (back < (window or s)))[None, None, None]

            def sdpa():
                kk, vv = next(lib_turn)
                return F.scaled_dot_product_attention(
                    q, kk.float(), vv.float(), attn_mask=live,
                    enable_gqa=hq != hkv)

            names = list(runs)
            times = {n: [] for n in [*names, "sdpa"]}
            for order in ([*names, "sdpa"], ["sdpa", *names[::-1]]):
                for n in order:
                    f = sdpa if n == "sdpa" else runs[n][0]
                    times[n].append(cs.time_ms(f, reps=20))
            b_ms = nbytes / cs.BYTES_PER_S * 1e3
            lib = sum(times["sdpa"]) / 2
            shape = (f"q ({b},{hq},1,{d}), cache ({b},{hkv},{s},{d}) "
                     f"{str(dt)[6:]}, window {window}, pos {pos}, cold "
                     f"({n_rot} copies)")
            print(f"K6 {label} {shape}: bytes bound {b_ms:.5f} ms; SDPA on "
                  f"the widened cache {lib:.4f} ms [{card}]", flush=True)
            for n in names:
                ms = sum(times[n]) / 2
                rounds = ", ".join(f"{x:.4f}" for x in times[n])
                print(f"K6 {label} {str(dt)[6:]} {n}: {ms:.4f} ms ({rounds})"
                      f", {b_ms / ms:.1%} of the bound, {ms / lib:.3f}x SDPA,"
                      f" max |diff| {runs[n][1]:.3g} [{card}]", flush=True)
            del k, v, copies, out, want
        del q, kv


def time_k3b(card: str, seed: int) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    fn = rn.FAMILY.fn("rmsnorm_bwd")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, d in K3B_SHAPES:
        x, g = (torch.from_numpy(rng.normal(0, sd, (rows, d)).astype(
            np.float32)).to(dev) for sd in (2.0, 1.0))
        s = torch.from_numpy(rng.normal(0, 0.1, (d,)).astype(
            np.float32)).to(dev)
        want = rmsnorm_bwd_ref(x, s, g)
        nvec = d // 4
        cands = [("warp", -(-nvec // 32))] if d <= rn.D_MAX else \
            [("loop", 0)] + [("block", nv) for nv in range(1, rn.BLOCK_NV + 1)
                             if -(-nvec // (32 * nv)) <= rn.BWD_BLOCK_WARPS]
        picked = rn.variant(x, s, g)
        runs = {}
        for kind, nv in cands:
            chunks = rn._bwd_chunks(rows, d, dev, kind, 0, nv)
            dx = torch.empty_like(x)
            ds = torch.empty_like(s)
            rinv = torch.empty((rows,), device=dev)
            part = torch.empty((chunks, d), device=dev)

            def run(kind=kind, nv=nv, chunks=chunks, dx=dx, ds=ds,
                    rinv=rinv, part=part):
                err = fn(0, rn.VARIANTS.index(kind), nv, x.data_ptr(), d,
                         g.data_ptr(), d, s.data_ptr(), dx.data_ptr(),
                         rinv.data_ptr(), part.data_ptr(), ds.data_ptr(),
                         rows, d, chunks, 1e-6,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K3b {kind} {nv}: cudaError {err}")
                return dx, ds

            got = [t.clone() for t in run()]
            again = run()
            torch.cuda.synchronize()
            for a, w in zip(got, want):
                tol = 1e-5 * float(w.abs().max())
                if not float((a - w).abs().max()) <= tol:
                    raise SystemExit(f"K3b {kind}{nv} ({rows}, {d}): max "
                                     f"|diff| {float((a - w).abs().max())}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit(f"K3b {kind}{nv} ({rows}, {d}): two calls "
                                 f"differ")
            runs[(kind, nv)] = run
        xg = x.clone().requires_grad_()
        wg = (1.0 + s).requires_grad_()
        y = F.rms_norm(xg, (d,), wg, 1e-6)

        def lib():
            return torch.autograd.grad(y, (xg, wg), g, retain_graph=True)

        keys = [*runs, "autograd"]
        times = {c: [] for c in keys}
        for order in (keys, keys[::-1]):
            for c in order:
                f = lib if c == "autograd" else runs[c]
                times[c].append(cs.time_ms(f, reps=50))
        b_ms, _ = cs.flop_bound(10.0 * x.numel(),
                                4.0 * (3 * x.numel() + 2 * d))
        lib_ms = sum(times["autograd"]) / 2
        cols = [f"autograd of F.rms_norm {lib_ms:.4f}"]
        for c in runs:
            ms = sum(times[c]) / 2
            tag = f"{c[0]}{c[1] if c[0] == 'block' else ''}"
            if c == picked:
                tag = f"*{tag}"
            cols.append(f"{tag} {ms:.4f} ({ms / lib_ms:.2f}x, "
                        f"{b_ms / ms:.0%})")
        print(f"K3b ({rows}, {d}) fp32 ms, bytes bound {b_ms:.5f} ({sms} "
              f"SMs): {'; '.join(cols)} [{card}]", flush=True)
        del x, g, want, xg, y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another K6 source to time beside the shipped "
                         "(repeatable)")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the -D K6_* variants")
    ap.add_argument("--clusters", action="store_true",
                    help="time the shipped K6 at every cluster size")
    ap.add_argument("--k6", action="store_true", help="time K6 only")
    ap.add_argument("--k3b", action="store_true", help="time K3b only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k6_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if not args.k3b:
        time_k6(build_k6(args.against, args.variants), card, args.seed,
                args.clusters)
    if not args.k6:
        time_k3b(card, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
