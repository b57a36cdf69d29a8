"""Design variants of K5 ``selective_scan`` and of K5b
``selective_scan_bwd`` timed against each other on the card: what their
constants and choices cost.

    python tools/torch_k5_variants.py            # needs an NVIDIA GPU
    python tools/torch_k5_variants.py --variants shipped,lanes4
    python tools/torch_k5_variants.py --overread
    python tools/torch_k5_variants.py --bwd [--against OLD.cu]

Each variant is the shipped ``kernels/selective_scan/csrc/selective_scan.cu``
built with the ``-D`` macros listed in ``VARIANTS`` (its ``K5_*`` knobs)
into ``build/k5_variants/`` (one ``nvcc`` each, all at once) and loaded
with ``ctypes``.  Three of them are probes whose output is not the scan:
``no_math`` skips the per-step arithmetic (the copies, the barrier and the
stores remain), ``no_reload`` loads only the first ring stages and
recomputes on them (the arithmetic remains), and ``ffma_decay`` replaces
the MUFU exp with an FFMA.  The rest must agree with the plain versions
within 1e-5 x max |want|.

At falcon-mamba-7b's prefill layer (8, 1024, 8192, 16), at batch 1 and at
decode's (8, 1, 8192, 16), with the inputs of ``chip_smoke.scan_inputs``
and ``gate_inputs``, it prints each variant's ms scan-only and gated
(CUDA events, 20 launches behind a sleep kernel, two rounds in opposite
orders), its registers and spills, and its error against the plain
versions.

``--overread`` instead runs the probe ``K5_PROBE=4``, which copies every
lookahead tile whole, so that the last batch row reads TILE rows past the
end of dt, x and z, once per shape, gated: first with dt, x and z as views
of allocations TILE rows longer, then as tensors of their own size, the
full prefill shape last (a fault ends the CUDA context).  It prints which
launch faulted.

``--bwd`` does the same for K5b: ``selective_scan_bwd.cu`` built with the
``-D K5B_*`` macros of ``BWD_VARIANTS`` into ``build/k5_variants/``:
lanes a channel, channels a block, synchronous staging (a one-stage
ring), and probes whose outputs are not gradients (``no_sums`` skips
the warp sums of dB / dC, ``no_math`` the per-state arithmetic,
``no_stores`` computes ddt, dx and dz but stores none, ``no_reload``
copies the first two tiles only and reruns the rest on them).  At falcon-mamba-7b's
training layer (4, 1024, 8192, 16), gated, with ``chip_smoke``'s inputs,
it prints each variant's registers, spills, shared memory and warps an
SM, its error against ``selective_scan_bwd_ref`` (the variants that are
not probes must hold every gradient to 1e-5 x max |want|) and its ms
(CUDA events, 10 launches behind a sleep kernel, two rounds in opposite
orders) beside the bound of ``chip_smoke.scan_bwd_bound``.  ``--against``
adds another source of the same C entry point (an earlier version of the
kernel, built as it is) as variant ``against``, timed first in the first
round and last in the second.  Every line carries the card's name and
power limit.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "selective_scan",
                   "csrc", "selective_scan.cu")
BWD_SRC = os.path.join(os.path.dirname(SRC), "selective_scan_bwd.cu")
OUT = os.path.join(ROOT, "build", "k5_variants")
VARIANTS = {
    "shipped": {},
    "lanes4": {"LANES": 4, "OCC": 1024},
    "lanes1": {"LANES": 1, "CH": 128, "OCC": 512},
    "occ1024": {"OCC": 1024},
    "occ896": {"OCC": 896},
    "tile32": {"TILE": 32},
    "stages3": {"STAGES": 3},
    "expf_decay": {"IEEE_DECAY": 1},
    "ieee_gate": {"IEEE_GATE": 1},
    "no_math": {"PROBE": 1},
    "no_reload": {"PROBE": 2},
    "ffma_decay": {"PROBE": 3},
}
NOT_THE_SCAN = ("no_math", "no_reload", "ffma_decay")
SHAPES = {"prefill": (8, 1024, 8192, 16), "batch1": (1, 1024, 8192, 16),
          "decode": (8, 1, 8192, 16)}
OVERREAD = {"PROBE": 4}
BWD_VARIANTS = {
    "shipped": {},
    "lanes8": {"LANES": 8, "CH": 32, "OCC": 768},
    "lanes8_ch64": {"LANES": 8, "CH": 64, "OCC": 512},
    "ch64": {"CH": 64},
    "ch64_occ768": {"CH": 64, "OCC": 768},
    "sync": {"STAGES": 1},
    "no_sums": {"PROBE": 1},
    "no_math": {"PROBE": 2},
    "no_stores": {"PROBE": 3},
    "no_reload": {"PROBE": 4},
}
NOT_THE_BWD = ("no_sums", "no_math", "no_stores", "no_reload")
BWD_SHAPE = (4, 1024, 8192, 16)
OVERREAD_SHAPES = ((2, 1024, 8192, 16), (8, 256, 8192, 16),
                   (8, 1024, 2048, 16), (8, 1024, 8192, 16))


def build(variants: dict, kernel: str = "selective_scan",
          prefix: str = "K5", sources: dict = None) -> dict:
    """Compile each variant (name -> its ``prefix``_* macros) of
    ``kernel``'s source (or the file ``sources`` names for it); returns
    name -> (the loaded library, its entry point, nvcc's registers and
    spills)."""
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.selective_scan.kernel import FAMILY

    src = SRC if kernel == "selective_scan" else BWD_SRC
    os.makedirs(OUT, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS,
         *(f"-D{prefix}_{k}={v}" for k, v in macros.items()),
         "-o", os.path.join(OUT, f"{kernel}_{name}.so"),
         (sources or {}).get(name, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in variants.items()}
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{kernel}_{name}.so"))
        fn = getattr(lib, kernel)
        fn.argtypes = FAMILY.argtypes[kernel]
        fn.restype = ctypes.c_int
        built[name] = lib, fn, ptxas_of(out)
    return built


def ptxas_of(out: str, marker: str = "ILi16ELb1E") -> str:
    """nvcc's ``-Xptxas -v`` lines for the instance whose mangled name
    holds ``marker`` (N = 16, gated), and the most spill bytes of any."""
    fn, mine, spills = "", [], 0
    for line in out.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spills = max(spills, int(line.split("bytes spill stores")[0]
                                     .split(",")[-1]))
            if marker in fn:
                mine.append(line.strip())
        elif "Used" in line and marker in fn:
            mine.append(line.split("info    :")[-1].strip())
    return "; ".join(mine) + f"; most spill stores of any instance: {spills} B"


def launch(fn, ins: tuple, gate, out: tuple) -> int:
    """One launch of a built variant on the current stream; its error."""
    import torch

    b, s, d = ins[0].shape
    return fn(*(t.data_ptr() for t in ins),
              *((t.data_ptr() for t in gate) if gate else (None, None)),
              out[0].data_ptr(), out[1].data_ptr(), None, b, s, d,
              ins[2].shape[2], torch.cuda.current_stream().cuda_stream)


def time_variants(names: list, card: str) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_gated_ref, selective_scan_ref)

    built = {name: v[1:] for name, v in build(
        {name: VARIANTS[name] for name in names}).items()}
    for name in names:
        print(f"{name}: {built[name][1]} [{card}]", flush=True)
    dev = torch.device("cuda")
    for label, shape in SHAPES.items():
        ins = cs.scan_inputs(shape, 4, dev)
        gate = cs.gate_inputs(ins, 4)
        out = (torch.empty_like(ins[0]), torch.empty_like(ins[5]))

        def run(name, gated):
            err = launch(built[name][0], ins, gate if gated else None, out)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        wants = {False: selective_scan_ref(*ins),
                 True: selective_scan_gated_ref(*ins, *gate)}
        errs = {}
        for name in names:
            for gated in (False, True):
                run(name, gated)
                torch.cuda.synchronize()
                errs[name, gated] = max(
                    float((g - w).abs().max() / w.abs().max())
                    for g, w in zip(out, wants[gated]))
                if name not in NOT_THE_SCAN and errs[name, gated] > 1e-5:
                    raise SystemExit(f"{name} {label} gated={gated}: error "
                                     f"{errs[name, gated]:.3g} x max |want|")
        times = {(n, g): [] for n in names for g in (False, True)}
        for order in (names, names[::-1]):
            for name in order:
                for gated in (False, True):
                    times[name, gated].append(
                        cs.time_ms(lambda: run(name, gated), reps=20))
        for name in names:
            cols = []
            for gated in (False, True):
                t = times[name, gated]
                cols.append(f"{'gated' if gated else 'scan'} "
                            f"{sum(t) / len(t):.4f} ms ({t[0]:.4f}, "
                            f"{t[1]:.4f}), err {errs[name, gated]:.2e}")
            print(f"{label} {shape} {name}: {'; '.join(cols)} [{card}]",
                  flush=True)


def overread(card: str) -> None:
    import torch

    import chip_smoke as cs

    _, fn, regs = build({"overread": OVERREAD})["overread"]
    print(f"overread: {regs} [{card}]", flush=True)
    tile = 16
    dev = torch.device("cuda")
    for slack in (True, False):
        for shape in OVERREAD_SHAPES:
            b, s, d, _ = shape
            ins = list(cs.scan_inputs(shape, 4, dev))
            gate = list(cs.gate_inputs(ins, 4))
            if slack:              # dt, x, z followed by TILE rows of theirs
                for seq, k in ((ins, 0), (ins, 1), (gate, 1)):
                    room = torch.zeros(b * s * d + tile * d, device=dev)
                    room[:b * s * d] = seq[k].reshape(-1)
                    seq[k] = room[:b * s * d].view(b, s, d)
            out = (torch.empty((b, s, d), device=dev),
                   torch.empty_like(ins[5]))
            torch.cuda.synchronize()
            try:
                err = launch(fn, tuple(ins), tuple(gate), out)
                torch.cuda.synchronize()
                what = f"launch rc {err}, ran"
            except Exception as e:          # the context is lost after this
                print(f"overread {shape} slack={slack}: FAULT "
                      f"{str(e).splitlines()[0]} [{card}]", flush=True)
                return
            print(f"overread {shape} slack={slack}: {what} [{card}]",
                  flush=True)
            del ins, gate, out


def bwd_info(lib) -> str:
    """Registers, spills, shared memory and warps an SM of a K5b build at
    N = 16, gated (``kernel.bwd_occupancy``; an earlier source without
    its query reports nothing)."""
    from repro_torch.kernels.selective_scan.kernel import bwd_occupancy

    if not hasattr(lib, "selective_scan_bwd_info"):
        return "no occupancy query"
    o = bwd_occupancy(BWD_SHAPE[3], True, lib=lib)
    return (f"{o['registers']} registers, {o['local_bytes']} B local, "
            f"{o['smem_bytes']} B shared a block of {o['threads']}, "
            f"{o['blocks_per_sm']} blocks = {o['warps_per_sm']} warps an SM, "
            f"{o['channels']} channels a block")


def time_bwd(names: list, card: str, against: str = None) -> None:
    """K5b's variants at falcon's training layer, gated (``--bwd``)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.selective_scan import kernel as ss
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref

    variants = {name: BWD_VARIANTS[name] for name in names}
    if against:
        variants = {"against": {}, **variants}
        names = ["against", *names]
    built = build(variants, "selective_scan_bwd", "K5B",
                  {"against": against} if against else None)
    chans = {name: macros.get("CH", ss.BWD_CH)
             for name, macros in variants.items()}
    chans["against"] = 64            # K5b's first design: 64 a block
    for name in names:
        print(f"bwd {name}: {built[name][2]}; {bwd_info(built[name][0])} "
              f"[{card}]", flush=True)
    dev = torch.device("cuda")
    b, s, d, n = BWD_SHAPE
    ins = cs.scan_inputs(BWD_SHAPE, 12, dev)
    gate = cs.gate_inputs(ins, 12)
    gen = torch.Generator(device=dev).manual_seed(13)
    dout = torch.randn(ins[0].shape, generator=gen, device=dev)
    _, _, hs = ss.selective_scan(*ins, *gate, states=True)
    want = selective_scan_bwd_ref(*ins, dout, None, *gate)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = {}
    for name in names:
        blocks = -(-d // chans[name])
        outs[name] = (blocks, new(b, s, d), new(b, s, d), new(b, s, d),
                      new(b, s, blocks, n), new(b, s, blocks, n),
                      new(b, d, n), new(b, d), new(b, d, n))

    def run(name):
        blocks, *o = outs[name]
        err = built[name][1](
            *(t.data_ptr() for t in (*ins[:5], hs, gate[0], gate[1], dout)),
            None, *(t.data_ptr() for t in o), b, s, d, n, blocks,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")

    errs = {}
    for name in names:
        run(name)
        torch.cuda.synchronize()
        _, ddt, dx, dz, dbp, dcp, dap, ddp, dh0 = outs[name]
        got = (ddt, dx, dbp.sum(2), dcp.sum(2), dap.sum(0), dh0, ddp.sum(0),
               dz)
        errs[name] = max(float((g - w).abs().max() / w.abs().max())
                         for g, w in zip(got, want))
        if name not in NOT_THE_BWD and not errs[name] <= 1e-5:
            raise SystemExit(f"bwd {name}: error {errs[name]:.3g} x max "
                             f"|want|")
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(cs.time_ms(lambda: run(name), reps=10))
    for name in names:
        t = times[name]
        bnd = cs.scan_bwd_bound(BWD_SHAPE, chans[name])
        ms = sum(t) / len(t)
        print(f"bwd {BWD_SHAPE} gated {name}: {ms:.4f} ms ({t[0]:.4f}, "
              f"{t[1]:.4f}), {bnd['bound_ms'] / ms:.1%} of the "
              f"{bnd['bound_ms']:.4f} ms bound, err {errs[name]:.2e} "
              f"[{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma-separated names (default: all of the mode)")
    ap.add_argument("--overread", action="store_true",
                    help="run the overread probe instead of the timing")
    ap.add_argument("--bwd", action="store_true",
                    help="time K5b's variants instead of K5's")
    ap.add_argument("--against", default=None,
                    help="with --bwd: another K5b source to time beside")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k5_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    table = BWD_VARIANTS if args.bwd else VARIANTS
    names = args.variants.split(",") if args.variants else list(table)
    if args.overread:
        overread(card)
    elif args.bwd:
        time_bwd(names, card, args.against)
    else:
        time_variants(names, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
