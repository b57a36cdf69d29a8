"""Design variants of K5 ``selective_scan`` timed against each other on the
card: what its constants and choices cost.

    python tools/torch_k5_variants.py            # needs an NVIDIA GPU
    python tools/torch_k5_variants.py --variants shipped,lanes4
    python tools/torch_k5_variants.py --overread

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
launch faulted.  Every line carries the card's name and power limit.
Exits 1 without a CUDA device.
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
OVERREAD_SHAPES = ((2, 1024, 8192, 16), (8, 256, 8192, 16),
                   (8, 1024, 2048, 16), (8, 1024, 8192, 16))


def build(variants: dict) -> dict:
    """Compile each variant (name -> its K5_* macros); returns name ->
    (the loaded entry point, nvcc's registers and spills)."""
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.selective_scan.kernel import FAMILY

    os.makedirs(OUT, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS,
         *(f"-DK5_{k}={v}" for k, v in macros.items()),
         "-o", os.path.join(OUT, f"{name}.so"), SRC],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in variants.items()}
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).selective_scan
        fn.argtypes = FAMILY.argtypes["selective_scan"]
        fn.restype = ctypes.c_int
        built[name] = fn, ptxas_summary(out)
    return built


def ptxas_summary(out: str) -> str:
    """The registers and any spills of nvcc's ``-Xptxas -v`` report."""
    return "; ".join(sorted({
        line.split("info    :")[-1].strip() for line in out.splitlines()
        if "Used" in line or ("spill" in line
                              and " 0 bytes spill stores" not in line)}))


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

    built = build({name: VARIANTS[name] for name in names})
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

    fn, regs = build({"overread": OVERREAD})["overread"]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--overread", action="store_true",
                    help="run the overread probe instead of the timing")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k5_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.overread:
        overread(card)
    else:
        time_variants(args.variants.split(","), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
