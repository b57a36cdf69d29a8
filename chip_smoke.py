"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each against its plain-torch twin on the card (bitwise), drives the
main path -- ``overlay.build("dgro")`` at N=4096 and ``selection.adapt``
at N=256 -- with the kernels' launch counters reset before and read after
each, checks the diameters against scipy's Dijkstra, times the kernels at
the main path's shapes, and prints one JSON object per line for the
kernels and, last, the device.  Exits non-zero, printing no result, when
there is no CUDA device, when the port cannot be imported, or when any
phase fails.  Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores is
# 67 TFLOP/s counting an FMA as two, so 33.5e12 instructions/s; HBM3 at
# 3.35 TB/s.  A relaxation is two instructions (add, min).
INSTR_PER_S = 33.5e12
BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(relaxations: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of the instruction and byte
    floors for the same work on the whole card."""
    ops_ms = 2.0 * relaxations / INSTR_PER_S * 1e3
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn`` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_equal(what: str, got, want) -> float:
    """Fail unless ``got`` and ``want`` are bit-equal; returns max |diff|."""
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    err = float((g - w).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel != twin, max |diff| {err}")
    log(f"  {what}: bitwise equal")
    return err


def tile_input(rng, t: int) -> np.ndarray:
    """A dense symmetric latency tile with a zero diagonal: every pivot
    relaxes every element."""
    m = rng.uniform(1.0, 100.0, (t, t)).astype(np.float32)
    m = np.triu(m, 1) + np.triu(m, 1).T
    np.fill_diagonal(m, 0.0)
    return m


def phase_kernels(rng, errs: dict) -> None:
    """Every kernel against its twin on the card, bitwise."""
    import torch

    from repro_torch.core.diameter import adjacency_from_rings
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel, ops, ref

    dev = torch.device("cuda")

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    k1 = []
    for dt in (torch.float32, torch.bfloat16):
        for (bsz, m, k, n) in ((1, 13, 17, 29), (3, 13, 17, 29),
                               (1, 5, 130, 7)):
            a = cuda(rng.uniform(0, 10, (bsz, m, k)).astype(np.float32)).to(dt)
            b = cuda(rng.uniform(0, 10, (bsz, k, n)).astype(np.float32)).to(dt)
            c = cuda(rng.uniform(0, 10, (bsz, m, n)).astype(np.float32)).to(dt)
            tag = f"K1 {bsz}x{m}x{k}x{n} {str(dt)[6:]}"
            k1.append(check_equal(tag, kernel.minplus_acc(a, b),
                                  ref.minplus_acc_ref(a, b)))
            k1.append(check_equal(tag + " +init",
                                  kernel.minplus_acc(a, b, c),
                                  ref.minplus_acc_ref(a, b, c)))
    for (m, k, n) in ((13, 17, 29), (5, 130, 7)):
        a = cuda(rng.uniform(0, 10, (m, k)).astype(np.float32))
        b = cuda(rng.uniform(0, 10, (k, n)).astype(np.float32))
        k1.append(check_equal(f"ops.minplus {m}x{k}x{n}", ops.minplus(a, b),
                              ref.minplus_ref(a, b)))
    # one squaring step of batcheval at B=8, N=256
    w = make_latency("fabric", 256, seed=1)
    d = cuda(np.stack([adjacency_from_rings(
        w, [rng.permutation(256) for _ in range(3)]) for _ in range(8)]))
    k1.append(check_equal("K1 squaring step B=8 N=256",
                          ops.minplus_batched(d, d),
                          ref.minplus_batched_ref(d, d)))
    k2 = []
    for t in (256, 152, 8):
        for dt in (torch.float32, torch.bfloat16):
            x = cuda(tile_input(rng, t)).to(dt)
            k2.append(check_equal(f"K2 T={t} {str(dt)[6:]}",
                                  kernel.fw_tile(x), ref.fw_tile_ref(x)))
    # whole tiled APSPs: N=1000 pads to 1024; N=4096 is the build's grid
    # (16 x 16 tiles of T=256), every K1 / K2 launch at the build's shapes
    for n, dist, k_rings in ((1000, "bitnode", 4), (4096, "fabric", 12)):
        w = make_latency(dist, n, seed=2)
        adj = cuda(adjacency_from_rings(
            w, [rng.permutation(n) for _ in range(k_rings)]))
        tile = ops.default_tile(n)
        padded = ops._pad_to(adj, tile, ops.INF)
        for sym in (False, True):
            got = ops.apsp_tiled(adj, symmetric=sym)
            want = ref.apsp_tiled_ref(padded, tile, symmetric=sym)[:n, :n]
            err = check_equal(f"apsp_tiled N={n} T={tile} symmetric={sym}",
                              got, want)
            k1.append(err)
            k2.append(err)
    errs["minplus_acc"] = max(k1)
    errs["fw_tile"] = max(k2)


def phase_build(counts: dict) -> None:
    """Main path at large N: ``overlay.build("dgro")`` at N=4096 scores its
    candidates with the tiled method (K2 + K1)."""
    from repro_torch import overlay
    from repro_torch.core.diameter import diameter_scipy
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel

    w = make_latency("fabric", 4096, seed=0)
    kernel.reset_launches()
    t0 = time.perf_counter()
    ov = overlay.build("dgro", w, seed=0)
    wall = time.perf_counter() - t0
    counts["build"] = dict(kernel.launches)
    log(f"  build('dgro') N=4096 fabric: {wall:.2f} s wall, "
        f"{ov.num_rings} rings, launches {counts['build']}")
    if min(counts["build"].values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {counts['build']}")
    got = ov.diameter()
    t0 = time.perf_counter()
    want = diameter_scipy(ov.adjacency)
    log(f"  diameter {got!r} vs scipy Dijkstra {want!r} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not np.isclose(got, want, rtol=1e-5, atol=0.0):
        raise AssertionError(f"diameter {got} != scipy {want} (rtol 1e-5)")


def phase_adapt(counts: dict) -> None:
    """Ring selection at small N: ``selection.adapt`` on a Chord overlay at
    N=256 scores its candidates by min-plus squaring (K1)."""
    from repro_torch import overlay
    from repro_torch.core import selection
    from repro_torch.core.diameter import diameter_scipy
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel

    base = overlay.build("chord", make_latency("bitnode", 256, seed=0),
                         seed=0)
    kernel.reset_launches()
    t0 = time.perf_counter()
    new, kind, rho = selection.adapt(base, seed=0)
    wall = time.perf_counter() - t0
    counts["adapt"] = dict(kernel.launches)
    before, after = base.diameter(), new.diameter()
    log(f"  adapt(chord) N=256 bitnode: rho {rho!r}, added a {kind} ring, "
        f"diameter {before!r} -> {after!r}, {wall:.2f} s wall, "
        f"launches {counts['adapt']}")
    if counts["adapt"]["minplus_acc"] < 1:
        raise AssertionError(f"adapt scored no candidate through K1: "
                             f"{counts['adapt']}")
    for label, ov, got in (("before", base, before), ("after", new, after)):
        want = diameter_scipy(ov.adjacency)
        if not np.isclose(got, want, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{label}: diameter {got} != scipy {want}")


def phase_fig20(rng) -> None:
    """fig20's cell: 64 random 12-ring genomes at N=4096, streamed."""
    import torch

    from repro_torch.core import batcheval
    from repro_torch.core.diameter import adjacency_from_rings, diameter_scipy
    from repro_torch.core.topology import make_latency

    n, b, k = 4096, 64, 12
    w = make_latency("uniform", n, seed=n)
    genomes = np.stack([[rng.permutation(n) for _ in range(k)]
                        for _ in range(b)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = batcheval.diameters_of_rings(w, genomes)
    wall = time.perf_counter() - t0
    rep = batcheval.last_eval_report()
    log(f"  B={b} N={n} K={k}: {b / wall:.3f} diameters/s ({wall:.2f} s), "
        f"method {rep['method']}, chunk {rep['chunk']}, "
        f"{rep['device_calls']} device calls; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B vs modeled workingset "
        f"{rep['workingset_bytes']} B")
    if out.shape != (b,) or not np.all(np.isfinite(out)):
        raise AssertionError(f"bad diameters: {out}")
    want = diameter_scipy(adjacency_from_rings(w, list(genomes[0])))
    if not np.isclose(out[0], want, rtol=1e-5, atol=0.0):
        raise AssertionError(f"genome 0: diameter {out[0]} != scipy {want}")


def profiled(label: str, fn) -> None:
    """Run ``fn`` once under ``torch.profiler`` (device activity only) and
    print its wall time, the device time of its kernels and copies, their
    share of the wall (the device's busy share), and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    dev_s = sum(r[2] for r in rows) / 1e6
    if not rows:
        log(f"  {label}: {wall:.3f} s wall; the profiler saw no device "
            f"time (busy share not measured)")
        return
    log(f"  {label}: {wall:.3f} s wall, {dev_s:.4f} s device time, busy "
        f"share {dev_s / wall:.4f}")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:4]:
        log(f"    {us / 1e3:.3f} ms in {count} x {key[:70]}")


def phase_profile(rng) -> None:
    """Where the time goes: the build, the adapt and a slice of the fig20
    cell again, under the profiler (outside the counted main-path runs)."""
    from repro_torch import overlay
    from repro_torch.core import batcheval, selection
    from repro_torch.core.topology import make_latency

    w = make_latency("fabric", 4096, seed=0)
    profiled("build('dgro') N=4096", lambda: overlay.build("dgro", w, seed=0))
    base = overlay.build("chord", make_latency("bitnode", 256, seed=0),
                         seed=0)
    profiled("adapt(chord) N=256", lambda: selection.adapt(base, seed=0))
    w20 = make_latency("uniform", 4096, seed=4096)
    genomes = np.stack([[rng.permutation(4096) for _ in range(12)]
                        for _ in range(16)])
    profiled("fig20 cell, 16 of the 64 genomes",
             lambda: batcheval.diameters_of_rings(w20, genomes))


def phase_timing(rng, counts: dict, errs: dict) -> list:
    """Each kernel at the main path's shapes: ms per launch by CUDA events,
    its twin's ms, and the bound; the timed launches are held bitwise
    against the twin too.  Returns the kernels line's entries."""
    import torch

    from repro_torch.core.diameter import adjacency_from_rings
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel, ops, ref

    dev = torch.device("cuda")
    launches = {name: sum(c[name] for c in counts.values())
                for name in kernel.SOURCES}
    # the operands of one outer update of the tiled APSP at N=4096, T=256
    n, t = 4096, ops.default_tile(4096)
    w = make_latency("fabric", n, seed=0)
    d = torch.from_numpy(adjacency_from_rings(
        w, [rng.permutation(n) for _ in range(12)])).to(dev)
    diag = kernel.fw_tile(d[:t, :t])
    rowp = kernel.minplus_acc(diag[None], d[None, :t, :],
                              init=d[None, :t, :])
    colp = rowp.transpose(1, 2).contiguous()
    outer = torch.empty_like(d)[None]
    ms = time_ms(lambda: kernel.minplus_acc(colp, rowp, init=d[None],
                                            out=outer), reps=20)
    plain = time_ms(lambda: ref.minplus_acc_ref(colp, rowp, d[None]),
                    reps=2, warmup=1)
    # the timed launches against their twins: diagonal tile, row panel,
    # outer update out of place and in place (init = out = d, as the
    # tiled schedule runs it)
    inplace = d[None].clone()
    kernel.minplus_acc(colp, rowp, init=inplace, out=inplace)
    want = ref.minplus_acc_ref(colp, rowp, d[None])
    errs["fw_tile"] = max(errs["fw_tile"], check_equal(
        f"K2 diagonal tile T={t} of N={n}", diag, ref.fw_tile_ref(d[:t, :t])))
    errs["minplus_acc"] = max(errs["minplus_acc"], check_equal(
        f"K1 row panel (1,{t},{t})x(1,{t},{n}) +init", rowp,
        ref.minplus_acc_ref(diag[None], d[None, :t, :], d[None, :t, :])),
        check_equal(f"K1 outer update (1,{n},{t})x(1,{t},{n}) +init",
                    outer, want),
        check_equal(f"K1 outer update (1,{n},{t})x(1,{t},{n}) in place",
                    inplace, want))

    # one squaring step of adapt's candidate scoring at N=256 (B=4)
    sq = torch.from_numpy(np.stack([adjacency_from_rings(
        make_latency("bitnode", 256, seed=0),
        [rng.permutation(256) for _ in range(8)]) for _ in range(4)])).to(dev)
    sq_ms = time_ms(lambda: kernel.minplus_acc(sq, sq), reps=50)
    errs["minplus_acc"] = max(errs["minplus_acc"], check_equal(
        "K1 squaring step B=4 N=256", kernel.minplus_acc(sq, sq),
        ref.minplus_acc_ref(sq, sq)))
    sq_plain = time_ms(lambda: ref.minplus_acc_ref(sq, sq), reps=3)
    sq_b, sq_by = bound(4.0 * 256 ** 3, 4.0 * 3 * 4 * 256 ** 2)
    log(f"  K1 squaring step B=4 N=256: {sq_ms:.4f} ms (twin "
        f"{sq_plain:.3f} ms, bound {sq_b:.5f} ms by {sq_by})")

    relax = float(n) * n * t
    nbytes = 4.0 * (2 * n * t + 2 * n * n)
    b_ms, b_by = bound(relax, nbytes)
    entries = [{
        "name": "minplus_acc", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus_acc.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:97",
        "also_replaces": ["src/repro/kernels/minplus/kernel.py:249",
                          "src/repro/kernels/minplus/kernel.py:188"],
        "shape": f"outer update (1,{n},{t})x(1,{t},{n}) fp32 +init",
        "launches": launches["minplus_acc"],
        "max_abs_err": errs["minplus_acc"], "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}]
    log(f"  K1 outer update N={n} T={t}: {ms:.4f} ms (twin {plain:.2f} ms, "
        f"bound {b_ms:.4f} ms by {b_by})")

    x = torch.from_numpy(tile_input(rng, t)).to(dev)
    k2_ms = time_ms(lambda: kernel.fw_tile(x), reps=20)
    k2_plain = time_ms(lambda: ref.fw_tile_ref(x), reps=2, warmup=1)
    errs["fw_tile"] = max(errs["fw_tile"], check_equal(
        f"K2 T={t} timed input", kernel.fw_tile(x), ref.fw_tile_ref(x)))
    k2_b, k2_by = bound(float(t) ** 3, 4.0 * 2 * t * t)
    entries.append({
        "name": "fw_tile", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/fw_tile.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:188",
        "shape": f"diagonal tile ({t},{t}) fp32",
        "launches": launches["fw_tile"], "max_abs_err": errs["fw_tile"],
        "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_b,
        "bound_by": k2_by, "library_ms": None})
    log(f"  K2 T={t}: {k2_ms:.4f} ms (twin {k2_plain:.2f} ms, bound "
        f"{k2_b:.5f} ms by {k2_by})")
    return entries


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.minplus import kernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    secs = kernel.build()
    log(f"kernel build: {secs:.1f} s")
    for name, out in kernel.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  nvcc {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    errs: dict = {}
    counts: dict = {}
    log("phase: kernels vs twins on the card")
    phase_kernels(rng, errs)
    log("phase: main path, overlay.build('dgro') at N=4096")
    phase_build(counts)
    log("phase: ring selection, selection.adapt at N=256")
    phase_adapt(counts)
    log("phase: fig20 cell, diameters_of_rings B=64 N=4096")
    phase_fig20(rng)
    log("phase: device time by profiler")
    phase_profile(rng)
    log("phase: kernel timing at the main path's shapes")
    entries = phase_timing(rng, counts, errs)

    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
