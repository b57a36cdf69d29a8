"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
(one ``nvcc`` per source, all at once) and holds each against its
plain-torch twin on the card: the min-plus kernels K1/K2 bitwise, RMSNorm
K3 and flash attention K4, their gradients K3b and K4b, Mamba1's
selective scan K5 and its gradient K5b, and decode attention K6 over an
fp32, bf16 or fp8 cache (and its partial form over a rank's slots),
within stated tolerances.  Then it
drives the port's two paths, each with the kernels' launch counters reset
just before and read just after:

* DGRO -- ``overlay.build("dgro")`` at N=4096 and ``selection.adapt`` at
  N=256 (diameters against scipy's Dijkstra), and fig20's scoring cell;
* the deep-Q constructor -- ``overlay.build("dgro-dqn")`` at N=200 (the
  paper's largest training size) with 1 training epoch instead of the
  builder's 60, its rings rolled out again on the CPU, one more epoch
  timed with host syncs counted;
* partitioned construction -- ``overlay.build("parallel")`` at N=4096 with
  M=1 and M=32 partitions (nearest and DQN segments, scored stitch), the
  K2/K1 launches held to the tiled schedule's count;
* the churn engine -- ``dynamics.ChurnEngine`` replaying a poisson_churn
  trace at n0=4,000 (rebuilds and adapt scoring through K2 + K1) and a
  regional failure at n0=1,024 with SWIM confirmation, each end state
  held to scipy and the stale state to its lower bound, the K1/K2
  launches held to the APSPs the engine asked for; then
  ``batcheval.apsp_rowshard`` (K1 with a batch of one) of the live block,
  maintenance throughput at N=4,096, the batched replica stream, the card
  against the CPU port bitwise event by event at n0=96, and the obs
  registry's reading and overhead;
* routing, hierarchies and the service -- (r) ``routing.route_pairs``
  over the build's overlay at N=4096 (P=4,096 pairs of every workload,
  both policies) bitwise against the CPU port and the host loop, and
  fig19's router-vs-host ratio at N=256; (p) the churn engine's routing
  probe, card against CPU at n0=96 and on replay (b); (h) fig21 at
  N=10^5: ``build_hier`` on a synthetic-geo world, its eccentricity
  bound, a ``HierChurnEngine`` streaming 200 events with a split and a
  merge (K1 launches held to its cluster APSPs), ``route_pairs_hier``,
  the card's build at N=16,384 equal to the CPU's, the exact bound at
  N=512 against scipy; (s) ``tools/torch_service_smoke.py`` against
  ``python -m repro_torch.service`` on the card, flat at n0=1,024 and
  hierarchical at n0=10,000;
* the multi-device DGRO path (d) -- 4 ranks spawned once on this one card
  (``torch.distributed`` over gloo, CUDA tensors staged through pinned
  host buffers): (d-a) ``diameters_sharded`` of fig20's genomes and (d-b)
  ``apsp_rowshard`` of the build's overlay, bitwise their one-process
  results, (d-c) ``parallel_ring_shmap`` bitwise the host's Alg. 4, (d-d)
  the int8 ring all-reduce of an embedding-sized leaf within its
  quantization bound and equal on every rank, (d-e) pod-compressed
  training of gemma3-1b cut to 4 layers, the ranks' parameters equal
  after every step and K3 / K4 / K3b / K4b launched as the layers imply,
  (d-f) tensor and expert parallel training of moonshot-v1-16b-a3b at
  full width cut to 2 layers over mesh (data 1, model 4), step 1 held to
  the one-device step (routing flips only at near ties), (d-g) serving
  over the same mesh, held to the one-device port served on the card:
  gemma3-1b at full width and depth (its caches split over slots, K6's
  partial form on every decode layer), zamba2-7b cut to 6 layers and
  falcon-mamba-7b cut to 4 (tensor-parallel Mamba2 / Mamba1), each with a
  train step;
* LM serving -- ``launch.serve.generate`` on gemma3-1b at full width
  (8 requests of 1024-token prompts, 32 new tokens, greedy), with the K3 /
  K4 / K6 launch counts the config implies (decode attends over the cache
  through K6 on every served model) and the prefill logits held against
  the plain versions run on the card;
* LM training -- ``train.train_step`` on gemma3-1b at full width (global
  batch 4 x 1024 tokens, remat, AdamW with warmup-cosine over 8 steps):
  the kernel path's loss and gradients against the plain path's on the
  card, remat against none, two backward passes bitwise, the loss after 8
  steps below step 0's, an async checkpoint at step 4 restored into a fresh
  state and replayed bit for bit, the K3 / K3b / K4 / K4b launches of a
  step held to the layer pattern, and a chunked-CE step's loss;
* MoE serving (m) -- moonshot-v1-16b-a3b at full width with 24 of its 48
  layers: (m-a) one MoE layer (T = 8,192) on the card against the CPU
  port, (m-b) ``launch.serve.generate`` as for gemma3-1b, with its K3 / K4
  launches and peak memory, (m-c) every layer's kernel-path input through
  the kernels and the plain versions (routing flips allowed only at near
  ties of the router; the whole prefill's logits are printed, and held to
  1e-4 only where no token's dispatch differs, since one flip moves its
  token by O(1) in every later layer), (m-f) a profile of the prefill with
  4 decode steps and of 4 decode steps alone, (m-d) ``train_step`` through
  the dispatch at depth 2: kernels against plain (loss, grad norm, and
  every leaf where no routing flip parts the paths), two passes and remat
  bitwise;
* SSM serving (f), (z) -- falcon-mamba-7b (64 Mamba1 layers, K5) and
  zamba2-7b (81 Mamba2 layers and 13 calls of a shared attention block,
  K4 at D = 112) at full width and depth: (x-a) one layer on the card
  against the CPU port (and K5, scan-only and gated, against its plain
  versions at the prefill's shape and gated at S = 1), (x-b)
  ``launch.serve.generate`` with its K3 / K4 / K5 launches and peak
  memory, (x-c) the prefill's logits through the kernels against
  the plain versions, (x-d) decode against the train-mode forward, (x-f)
  profiles of the prefill with 4 decode steps and of 4 decode steps alone;
* SSM training (f-t), (z-t) -- ``train_step`` on falcon-mamba-7b (4 of
  64 layers: K5 with its saved states, K5b) and zamba2-7b (6 of 81: one
  layer pattern and one shared attention call, K4 with L and K4b at D =
  112) at full width, global batch 4 x 1024, remat: the kernels' loss and
  gradients against the plain path's on the card, two passes and remat
  bitwise, the launches of a step held to the layer pattern, step wall,
  tok/s, peak memory and a profile of one step;
* frontend serving (v), (u) -- pixtral-12b (40 layers, d 5120, 256 random
  patch embeddings prepended to each 1024-token prompt by the vision stub)
  on an fp32 and an fp8 KV cache, and musicgen-large (48 layers, D = 64,
  GELU) on an fp32 cache, at full width and depth: (x-a) one layer's
  prefill and decode steps on the card against the CPU port, (x-b)
  ``generate`` with its K3 / K4 / K6 launches and peak memory, (x-c) the
  prefill's logits through the kernels against the plain versions, and for
  pixtral (v-8) the fp8 cache bytes the card wrote against the CPU cast of
  the fp32 cache, K6 on that fp8 cache against its twin, (v-d) decode on
  the fp8 cache within the reference's bound of the fp32 cache's, and
  (v-f) profiles of the prefill with 4 decode steps and of 4 decode steps
  alone.

It times every kernel at its path's shapes (K2 in every cluster size and
pivots per barrier it is built for, beside a probe of the cluster
barrier), and prints one JSON object per line for the kernels and, last,
the device.  Exits non-zero, printing no
result, when there is no CUDA device, when the port cannot be imported, or
when any phase fails.  Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores is
# 67 TFLOP/s counting an FMA as two, so 33.5e12 instructions/s; dense TF32
# on the tensor cores 494.7 TFLOP/s; HBM3 at 3.35 TB/s.  A relaxation is
# two instructions (add, min).
FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 494.7e12
BYTES_PER_S = 3.35e12


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` at once; a phase's first line also says how far into
    the run it starts."""
    if msg.startswith("phase:"):
        msg = f"{msg} [{time.perf_counter() - _T0:.1f} s in]"
    print(msg, flush=True)


def flop_bound(flops: float, nbytes: float,
               rate: float = FLOP_PER_S) -> tuple:
    """(bound_ms, bound_by): the larger of the operation floor at ``rate``
    (fp32 on the CUDA cores by default; an FMA counts as two) and the byte
    floor for the same work on the whole card."""
    ops_ms = flops / rate * 1e3
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def bound(relaxations: float, nbytes: float) -> tuple:
    """``flop_bound`` for min-plus work: a relaxation is two instructions
    (add, min), each at an FMA's rate, so four FLOP's worth."""
    return flop_bound(4.0 * relaxations, nbytes)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn`` by CUDA events.  A sleep kernel
    (~50 ms) is queued ahead of the timed calls, so the host has enqueued
    them before the card reaches them: the events time back-to-back device
    work, not the rate at which the host launches small kernels."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def families() -> tuple:
    """Every kernel family of the port."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.minplus import kernel as mp
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.kernels.selective_scan import kernel as ss

    return mp.FAMILY, rn.FAMILY, fa.FAMILY, ss.FAMILY, da.FAMILY


def reset_all_launches() -> None:
    """Every kernel's launch count to 0 (before a path is driven)."""
    for fam in families():
        fam.reset_launches()


def lm_launches() -> dict:
    """The LM paths' launch counts: K3, K3b, K4, K4b, K5, K5b and K6."""
    _, rn, fa, ss, da = families()
    return {**rn.launches, **fa.launches, **ss.launches, **da.launches}


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
    for t in (256, 200, 152, 33, 8, 1):
        for dt in (torch.float32, torch.bfloat16):
            x = cuda(tile_input(rng, t)).to(dt)
            k2.append(check_equal(f"K2 T={t} {str(dt)[6:]}",
                                  kernel.fw_tile(x), ref.fw_tile_ref(x)))
    for c, p in kernel.FW_TILE_VARIANTS:
        for t in (255, 200):
            x = cuda(rng.uniform(1.0, 100.0, (t, t)).astype(np.float32))
            k2.append(check_equal(
                f"K2 T={t} asymmetric, cluster of {c}, {p} pivots a barrier",
                kernel.fw_tile_variant(x, c, p), ref.fw_tile_ref(x)))
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


def phase_build(counts: dict):
    """Main path at large N: ``overlay.build("dgro")`` at N=4096 scores its
    candidates with the tiled method (K2 + K1).  Returns the overlay (phase
    routing routes over it) and scipy's diameter of it."""
    from repro_torch import overlay
    from repro_torch.core.diameter import diameter_scipy
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel

    w = make_latency("fabric", 4096, seed=0)
    reset_all_launches()
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
    return ov, want


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
    reset_all_launches()
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


def phase_fig20(rng) -> tuple:
    """fig20's cell: 64 random 12-ring genomes at N=4096, streamed.
    Returns (w, genomes, diameters) for phase (d)."""
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
    return w, genomes, out


DQN = dict(n=200, dist="fabric", epochs=1, n_starts=10)


def phase_dqn(counts: dict) -> None:
    """The deep-Q constructor: ``overlay.build("dgro-dqn")`` at N=200
    (K = 8 rings, T = 1,600 steps an epoch, 10 starts), 1 training epoch.
    Launch counts run from the build through the diameter recomputed by
    batcheval (min-plus squaring: K1).  The trained parameters are rolled
    out again on the card (same rings), every greedy decision is replayed
    on the CPU (same Q values to fp32 rounding), and one more epoch is
    timed with host syncs counted."""
    import warnings

    import torch

    from repro_torch import overlay
    from repro_torch.core import qlearning, rollout
    from repro_torch.core.construction import default_num_rings
    from repro_torch.core.diameter import diameter_scipy
    from repro_torch.core.embedding import init_qparams
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel
    from repro_torch.train.optimizer import adamw_init

    n = DQN["n"]
    w = make_latency(DQN["dist"], n, seed=0)
    cfg = overlay.DGRODQNConfig(epochs=DQN["epochs"],
                                n_starts=DQN["n_starts"])
    trained = []
    train_dqn = qlearning.train_dqn

    def keep(*args, **kwargs):
        trained.append(train_dqn(*args, **kwargs))
        return trained[-1]

    qlearning.train_dqn = keep
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    try:
        ov = overlay.build("dgro-dqn", w, cfg, seed=0)
    finally:
        qlearning.train_dqn = train_dqn
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cached = ov.diameter()
    ov._cache.clear()
    recomputed = ov.diameter()
    counts["dgro-dqn"] = dict(kernel.launches)
    params, tlog = trained[0]
    k = default_num_rings(n)
    log(f"  build('dgro-dqn') N={n} {DQN['dist']}: {k} rings, "
        f"{cfg.epochs} epochs (the builder's default is 60), {wall:.2f} s "
        f"wall, of which train_dqn {tlog.seconds:.2f} s ({cfg.epochs} epochs "
        f"and their eval rollouts, {tlog.steps_per_sec:.1f} env steps/s); "
        f"max_memory_allocated {peak} B; launches {counts['dgro-dqn']}")
    want_k1 = int(np.ceil(np.log2(n - 1)))
    if counts["dgro-dqn"] != {"minplus_acc": want_k1, "fw_tile": 0}:
        raise AssertionError(f"dgro-dqn launches {counts['dgro-dqn']}: "
                             f"expected {want_k1} K1 squarings")
    if ov.num_rings != k or any(sorted(r) != list(range(n))
                                for r in ov.rings):
        raise AssertionError("dgro-dqn rings are not K permutations")
    want = diameter_scipy(ov.adjacency)
    log(f"  diameter: cached {cached!r}, recomputed by batcheval "
        f"{recomputed!r}, scipy Dijkstra {want!r}")
    for label, got in (("cached", cached), ("recomputed", recomputed)):
        if not np.isclose(got, want, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{label} diameter {got} != scipy {want}")

    seed = int(np.random.default_rng(0).integers(2**31))
    dcfg = qlearning.DQNConfig(n=n, k_rings=k, epochs=cfg.epochs,
                               eps_decay=max(cfg.epochs // 2, 1),
                               dist=cfg.dist, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = qlearning.dgro_overlay(params, dcfg, w, n_starts=cfg.n_starts,
                                   seed=seed)
    rollout_s = time.perf_counter() - t0
    log(f"  {cfg.n_starts}-start rollout ({k * n} steps, batch of "
        f"{cfg.n_starts}): {rollout_s:.3f} s on the card; its rings equal "
        f"the build's: {again.to_json() == ov.to_json()}")
    if again.to_json() != ov.to_json():
        raise AssertionError("the trained parameters rolled out again give "
                             "other rings")
    check_greedy_on_cpu(params, w, ov.rings, dcfg.n_rounds)

    # one more epoch, as train_dqn's first: timed, host syncs counted
    slots = rollout.graph_slots(dcfg.buffer_capacity, 1, k, n)
    buf = rollout.init_buffer(dcfg.buffer_capacity, n, slots)
    p0 = init_qparams(torch.Generator().manual_seed(seed), dcfg.p, dcfg.h)
    opt = adamw_init(p0.tensors())
    plan = rollout.make_plan(np.random.default_rng(seed), 1, k, n,
                             dcfg.updates_per_step, dcfg.batch_size)
    ws = torch.as_tensor(make_latency(dcfg.dist, n, seed=seed * 77_000)[None],
                         device="cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            out = rollout.train_epoch(
                p0, opt, buf, ws, np.zeros(1, np.int64), plan.starts,
                plan.eps_u, plan.choice_u, plan.sample_u, 1.0, dcfg.gamma,
                dcfg.lr, dcfg.alpha, k_rings=k, n_rounds=dcfg.n_rounds,
                batch_size=dcfg.batch_size,
                updates_per_step=dcfg.updates_per_step)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    where: dict = {}
    for x in seen:
        if "synchroniz" in str(x.message):
            at = f"{os.path.relpath(x.filename, ROOT)}:{x.lineno}"
            where[at] = where.get(at, 0) + 1
    syncs = sum(where.values())
    losses = out[4].cpu().numpy()
    log(f"  one training epoch (eps 1.0, {k * n} steps, "
        f"{int(np.isfinite(losses).sum())} TD updates of batch "
        f"{dcfg.batch_size}): {epoch_s:.3f} s, {k * n / epoch_s:.1f} env "
        f"steps/s, {syncs} host syncs (set_sync_debug_mode warn) at "
        f"{where}, buffer {buf.size} transitions")
    if syncs > k * n // 100:        # one a step would be 1,600
        raise AssertionError(f"{syncs} host syncs in one epoch: the step "
                             f"loop waits for the card")


def greedy_states(rings, n: int, chunk: int = 128):
    """Every greedy (non-closing) step of building ``rings`` in order, as
    the rollout engine meets it, in chunks: (adjacency (B, N, N) f32,
    current node (B,), visited (B, N) bool, the node taken (B,))."""
    batch = []
    base = np.zeros((n, n), np.float32)
    for perm in rings:
        adj, visited = base.copy(), np.zeros(n, bool)
        visited[perm[0]] = True
        for j in range(n - 1):
            batch.append((adj.copy(), perm[j], visited.copy(), perm[j + 1]))
            adj[perm[j], perm[j + 1]] = adj[perm[j + 1], perm[j]] = 1.0
            visited[perm[j + 1]] = True
            if len(batch) == chunk:
                yield [np.stack(x) for x in zip(*batch)]
                batch = []
        adj[perm[-1], perm[0]] = adj[perm[0], perm[-1]] = 1.0
        base = adj
    if batch:
        yield [np.stack(x) for x in zip(*batch)]


def check_greedy_on_cpu(params, w, rings, n_rounds: int) -> None:
    """Replay every greedy decision of the card's winning rings on the CPU.

    Each node the card took must be a CPU argmax to 1e-5 x max |Q|.  (A
    rollout made anew on the CPU can part from the card's: the two best of
    ~200 Q values often lie within an ulp or two, and cuBLAS and the CPU's
    BLAS sum in other orders.)  And the card's Q values must be as exact as
    the CPU's fp32 ones: against the same states evaluated in float64 on
    the CPU, the card's largest error is at most 4x the CPU's (+ 1e-6) x
    max |Q|.  The same states with TF32 on are reported for scale."""
    import torch

    from repro_torch.core.embedding import QParams, q_values_batch

    n = w.shape[0]
    cpu = params.on("cpu")
    f64 = QParams(**{k: v.detach().double() for k, v in cpu.tensors().items()})
    err = {"cpu": 0.0, "card": 0.0, "card_tf32": 0.0}
    worst_margin = 0.0
    steps = ties = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for adj, v, visited, took in greedy_states(rings, n):
            b = adj.shape[0]
            w_b = torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(w, (b, n, n))))
            adj_t, v_t = torch.from_numpy(adj), torch.from_numpy(v)
            q64 = q_values_batch(f64, w_b.double(), adj_t.double(), v_t,
                                 n_rounds)
            q = {"cpu": q_values_batch(cpu, w_b, adj_t, v_t, n_rounds)}
            args = [x.cuda() for x in (w_b, adj_t, v_t)]
            q["card"] = q_values_batch(params, *args, n_rounds).cpu()
            torch.backends.cuda.matmul.allow_tf32 = True
            q["card_tf32"] = q_values_batch(params, *args, n_rounds).cpu()
            torch.backends.cuda.matmul.allow_tf32 = False
            mask = torch.from_numpy(visited)
            scale = q64.abs().masked_fill(mask, 0.0).amax(1).clamp_min(1.0)
            for key, qk in q.items():
                e = (qk.double() - q64).abs().masked_fill(mask, 0.0).amax(1)
                err[key] = max(err[key], float((e / scale).max()))
            q_c = q["cpu"].masked_fill(mask, float("-inf"))
            took_t = torch.from_numpy(took)
            margin = q_c.amax(1) - q_c.gather(1, took_t[:, None])[:, 0]
            worst_margin = max(worst_margin, float((margin / scale).max()))
            ties += int((q_c.argmax(1) != took_t).sum())
            steps += b
    log(f"  greedy decisions replayed on the CPU: {steps} states in "
        f"{time.perf_counter() - t0:.1f} s; each pick of the card is a CPU "
        f"argmax within {worst_margin:.3g} x max |Q| (tolerance 1e-5), "
        f"{ties} of them at near ties where the CPU's argmax is another "
        f"node; largest error against float64, x max |Q|: CPU fp32 "
        f"{err['cpu']:.3g}, card fp32 {err['card']:.3g}, card with TF32 on "
        f"{err['card_tf32']:.3g}")
    if worst_margin > 1e-5:
        raise AssertionError(f"a pick of the card is {worst_margin} x max "
                             f"|Q| below the CPU's best")
    if err["card"] > 4 * err["cpu"] + 1e-6:
        raise AssertionError(f"the card's Q values are less exact than the "
                             f"CPU's fp32 ones: {err}")


PARALLEL = dict(n=4096, dist="fabric", m=32, dqn_epochs=10)


def phase_parallel(counts: dict) -> None:
    """Partitioned construction (Alg. 4) at N=4096: M=1 and M=32 with
    nearest segments, M=32 with DQN segments (10 training epochs at the
    block size 128, of the builder's default 40, to keep the script
    inside its time limit), all with the scored stitch.
    Each build's K2 / K1 launches must be the tiled schedule's: 16 stitch
    candidates x ceil(N / T) diagonal steps x (1 K2, 2 K1); M=1 has one
    segment and scores nothing."""
    import torch

    from repro_torch import overlay
    from repro_torch.core import batcheval
    from repro_torch.core.diameter import diameter_scipy
    from repro_torch.core.parallel import parallel_ring_host
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel, ops

    n, m = PARALLEL["n"], PARALLEL["m"]
    w = make_latency(PARALLEL["dist"], n, seed=0)
    steps = -(-n // ops.default_tile(n))
    diameters = {}
    rings = {}
    for label, cfg in (
            ("M=1 nearest", overlay.ParallelConfig(m=1)),
            (f"M={m} nearest", overlay.ParallelConfig(m=m)),
            (f"M={m} dqn", overlay.ParallelConfig(
                m=m, constructor="dqn",
                dqn_epochs=PARALLEL["dqn_epochs"]))):
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ov = overlay.build("parallel", w, cfg, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernel.launches)
        counts[f"parallel {label}"] = got
        apsps = 0
        if cfg.m > 1:
            rep = batcheval.last_eval_report()
            apsps = rep["b"] if rep["b"] <= rep["chunk"] else \
                rep["device_calls"] * rep["chunk"]
            if rep["b"] != 16 or rep["method"] != "tiled":
                raise AssertionError(f"{label}: stitch scored {rep}")
        want = {"minplus_acc": 2 * steps * apsps, "fw_tile": steps * apsps}
        d = ov.diameter()
        d_scipy = diameter_scipy(ov.adjacency)
        diameters[label] = d
        rings[label] = ov.rings[0]
        log(f"  build('parallel') {label}, N={n}: {wall:.3f} s wall, "
            f"diameter {d!r} (scipy {d_scipy!r}), launches {got} "
            f"(expected {want})")
        if got != want:
            raise AssertionError(f"{label}: launches {got} != {want}")
        if not np.isclose(d, d_scipy, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{label}: diameter {d} != scipy {d_scipy}")
    log(f"  claim 3: M={m} / M=1 diameter "
        f"{diameters[f'M={m} nearest'] / diameters['M=1 nearest']:.4f} "
        f"(nearest), {diameters[f'M={m} dqn'] / diameters['M=1 nearest']:.4f}"
        f" (dqn)")
    seed = int(np.random.default_rng(0).integers(2**31))
    host = parallel_ring_host(w, m, seed=seed, stitch="scored")
    if not np.array_equal(host, rings[f"M={m} nearest"]):
        raise AssertionError("M=32 nearest ring != parallel_ring_host's")
    log(f"  M={m} nearest ring equals parallel_ring_host's (numpy segments)")


CHURN = dict(n0=4000, dist="bitnode", horizon=15_000.0, rate=2e-3,
             k_rings=2, adapt_every=8, threshold=8, fail_n0=1024,
             maint_n=4096, maint_ops=80, maint_full_ops=16,
             maint_threshold=16, replicas=16, stream_c=1024, stream_t=64,
             parity_n0=96, overhead_events=8)


class ApspLedger:
    """Every APSP the churn path asks ``batcheval.batched_apsp`` for, tagged
    by what asked (the policy's initial build, ``IncrementalDistances.
    rebuild``, ``selection.adapt``, ``ChurnEngine.probe_stretch``), and
    every adapt decision with the device it ran on.  A context manager:
    the wrappers are installed on entry and removed on exit, and they only
    record."""

    def __enter__(self):
        from repro_torch.core import batcheval, selection
        from repro_torch.dynamics.engine import ChurnEngine
        from repro_torch.dynamics.incremental import IncrementalDistances

        self.calls = []         # (tag, matrices, n, method, tile)
        self.adapts = []        # (device, kind, rho, seconds)
        self.tag = "build"
        ledger = self
        apsp, rebuild, adapt, probe = (
            batcheval.batched_apsp, IncrementalDistances.rebuild,
            selection.adapt, ChurnEngine.probe_stretch)

        def batched_apsp(adjs, **kw):
            method = kw.get("method") or batcheval._auto_method(
                bool(kw.get("use_kernel")), adjs.shape[-1], adjs.device)
            ledger.calls.append((ledger.tag, int(adjs.shape[0]),
                                 int(adjs.shape[-1]), method,
                                 kw.get("tile")))
            return apsp(adjs, **kw)

        def tagged(tag, fn):
            def call(*args, **kw):
                prev, ledger.tag = ledger.tag, tag
                try:
                    return fn(*args, **kw)
                finally:
                    ledger.tag = prev
            return call

        def adapt_logged(*args, **kw):
            t0 = time.perf_counter()
            out = tagged("adapt", adapt)(*args, **kw)
            ledger.adapts.append((batcheval.eval_device().type, out[1],
                                  out[2], time.perf_counter() - t0))
            return out

        self._undo = [(batcheval, "batched_apsp", apsp),
                      (IncrementalDistances, "rebuild", rebuild),
                      (selection, "adapt", adapt),
                      (ChurnEngine, "probe_stretch", probe)]
        batcheval.batched_apsp = batched_apsp
        IncrementalDistances.rebuild = tagged("rebuild", rebuild)
        selection.adapt = adapt_logged
        ChurnEngine.probe_stretch = tagged("probe", probe)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._undo:
            setattr(obj, name, fn)
        return False

    def apsps(self, tag=None) -> int:
        return sum(c[1] for c in self.calls if tag in (None, c[0]))

    def expected_launches(self) -> dict:
        """K1 / K2 launches of the recorded APSPs: a tiled APSP of N nodes
        runs ceil(N / T) diagonal steps of one K2 and two K1 (row panel,
        outer update; the column panel is the row panel's transpose); a
        squaring APSP runs ceil(log2(N - 1)) batched K1 products."""
        from repro_torch.kernels.minplus import ops

        k1 = k2 = 0
        for _, b, n, method, tile in self.calls:
            if method == "tiled":
                steps = -(-n // (tile or ops.default_tile(n)))
                k1, k2 = k1 + 2 * b * steps, k2 + b * steps
            elif method == "squaring":
                k1 += max(1, int(np.ceil(np.log2(max(n - 1, 2)))))
        return {"minplus_acc": k1, "fw_tile": k2}


def live_truth(adj: np.ndarray):
    """scipy Dijkstra of an overlay (float64, inf where unreachable) and its
    largest-component diameter, the paper's rule as ``diameter_scipy``
    applies it."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components, dijkstra

    from repro_torch.core.diameter import is_edge

    a = np.asarray(adj, np.float64)
    sp = csr_matrix(np.where(is_edge(a), a, 0.0))
    dist = dijkstra(sp, directed=False)
    _, labels = connected_components(sp, directed=False)
    keep = labels == np.bincount(labels).argmax()
    return dist, float(dist[np.ix_(keep, keep)].max())


def hold_to_truth(what: str, got: np.ndarray, truth: np.ndarray) -> float:
    """Fail unless ``got`` has ``truth``'s reachability and agrees with it
    within rtol 1e-4 / atol 1e-3 (the reference's own tolerance,
    ``tests/test_dynamics.py``); returns max |diff| over reachable pairs."""
    from repro_torch.core.diameter import INF

    reach = np.isfinite(truth)
    if not np.array_equal(got < float(INF) / 2, reach):
        raise AssertionError(f"{what}: reachability differs from Dijkstra")
    g = got.astype(np.float64)[reach]
    if not np.allclose(g, truth[reach], rtol=1e-4, atol=1e-3):
        raise AssertionError(f"{what}: distances off Dijkstra by up to "
                             f"{np.abs(g - truth[reach]).max()}")
    return float(np.abs(g - truth[reach]).max())


def count_syncs(seen) -> tuple:
    """(total, {file:line: count}) of the host syncs torch warned about."""
    where: dict = {}
    for x in seen:
        if "synchroniz" in str(x.message):
            at = f"{os.path.relpath(x.filename, ROOT)}:{x.lineno}"
            where[at] = where.get(at, 0) + 1
    return sum(where.values()), where


def replay(label: str, trace, counts: dict, **engine_kw):
    """One counted run of the churn path: ``ChurnEngine`` construction (the
    policy's initial build and the first APSP) and ``run(record=True)``,
    launches reset before and read after.  The replay's host syncs are
    counted (``set_sync_debug_mode``), the distances just before the final
    refresh are kept on the device, and the end state is held to scipy:
    stale distances at most the truth (the lower-bound contract), exact
    ones equal to it within the reference's tolerance.  Returns the
    engine, the run's result, the truth, whether the final refresh rebuilt
    and the replay's events/s."""
    import warnings

    import torch

    from repro_torch.dynamics import ChurnEngine, DGROPolicy
    from repro_torch.kernels.minplus import kernel

    kinds = {k: sum(e.kind == k for e in trace.events)
             for k in sorted({e.kind for e in trace.events})}
    log(f"  {label}: {trace.name} n0={trace.n0} capacity={trace.capacity} "
        f"{trace.dist}, {len(trace.events)} trace events {kinds}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with ApspLedger() as ledger:
        t0 = time.perf_counter()
        eng = ChurnEngine(trace, DGROPolicy(k_rings=CHURN["k_rings"],
                                            adapt_every=CHURN["adapt_every"]),
                          rebuild_threshold=CHURN["threshold"], **engine_kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        ledger.tag = "replay"
        stale = {}
        refresh = eng.inc.refresh

        def keep_stale():
            stale.setdefault("d", eng.inc._dist.clone())
            stale.setdefault("pending", eng.inc.pending_deletions)
            refresh()

        eng.inc.refresh = keep_stale
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                res = eng.run(record=True)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        wall = time.perf_counter() - t0
    got = dict(kernel.launches)
    counts[f"churn {label}"] = got
    peak = torch.cuda.max_memory_allocated()
    syncs, where = count_syncs(seen)
    st = res.stats
    final_rebuild = int(stale["pending"] > 0)
    want = ledger.expected_launches()
    n_ev = eng.events_processed
    log(f"  {label}: engine set up in {setup_s:.2f} s (initial dgro build + "
        f"first APSP); replay of {n_ev} events in {wall:.3f} s, "
        f"{n_ev / wall:.2f} events/s; stats {st}; "
        f"{len(res.samples)} samples; host syncs {syncs} "
        f"({syncs / n_ev:.2f} an event) at {where}; max_memory_allocated "
        f"{peak} B")
    adapt_kinds = {k: sum(a[1] == k for a in ledger.adapts)
                   for k in sorted({a[1] for a in ledger.adapts})}
    rhos = [round(a[2], 4) for a in ledger.adapts]
    adapt_s = sum(a[3] for a in ledger.adapts)
    log(f"  {label}: APSPs build {ledger.apsps('build')}, rebuild "
        f"{ledger.apsps('rebuild')} (1 initial + {st['rebuilds']} churn + "
        f"{final_rebuild} final refresh), adapt {ledger.apsps('adapt')} "
        f"({len(ledger.adapts)} adapt calls: {adapt_kinds}, rho {rhos}; "
        f"{adapt_s:.3f} s of the replay's wall in them), probe "
        f"{ledger.apsps('probe')}, other {ledger.apsps('replay')}; methods "
        f"{sorted({(c[3], c[2]) for c in ledger.calls})}; launches {got} "
        f"(expected {want})")
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")
    if min(got.values()) < 1:
        raise AssertionError(f"{label}: the path skipped a kernel: {got}")
    if ledger.apsps("rebuild") != 1 + st["rebuilds"] + final_rebuild:
        raise AssertionError(f"{label}: rebuild APSPs "
                             f"{ledger.apsps('rebuild')} != stats")
    if ledger.apsps("replay"):
        raise AssertionError(f"{label}: APSPs outside rebuild / adapt")
    if st.get("adaptations", 0) != sum(a[1] != "keep"
                                       for a in ledger.adapts):
        raise AssertionError(f"{label}: adaptations {st} vs {adapt_kinds}")

    live = eng.live_ids()
    t0 = time.perf_counter()
    truth, d_true = live_truth(eng.inc.adj[np.ix_(live, live)])
    scipy_s = time.perf_counter() - t0
    reach = np.isfinite(truth)
    old = stale["d"].cpu().numpy()[np.ix_(live, live)].astype(np.float64)
    over = old[reach] - (truth[reach] * (1 + 1e-4) + 1e-3)
    log(f"  {label}: before the final refresh ({stale['pending']} deletions "
        f"pending) every live distance is at most Dijkstra's (largest "
        f"excess {over.max():.3g}, below truth by up to "
        f"{(truth[reach] - old[reach]).max():.3g})")
    if (over > 0).any():
        raise AssertionError(f"{label}: a stale distance exceeds the truth "
                             f"by {over.max()}: the lower bound is broken")
    err = hold_to_truth(f"{label} live distances after refresh",
                        eng.inc.live_distances(), truth)
    log(f"  {label}: after it, diameter(exact=True) {res.final_diameter!r} "
        f"vs scipy {d_true!r}; live distances vs Dijkstra max |diff| "
        f"{err:.3g} ({scipy_s:.1f} s of scipy)")
    if not np.isclose(res.final_diameter, d_true, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"{label}: final diameter {res.final_diameter}"
                             f" != scipy {d_true}")
    if not all(np.isfinite(s.diameter) for s in res.samples):
        raise AssertionError(f"{label}: a sampled diameter is not finite")
    return eng, res, truth, final_rebuild, n_ev / wall


def phase_churn(counts: dict) -> float:
    """The churn engine on the card (``repro_torch.dynamics``):

    (a) a poisson_churn trace at n0=4,000 on bitnode latency (the size of a
        real P2P fleet) against DGRO (2 rings, adapt every 8 changes),
        rebuild threshold 8 -- rebuilds tiled (K2 + K1) over a capacity
        that pads to the tile grid, adapt scoring 4 candidates at N~4,000;
        then the live block's APSP once more by ``apsp_rowshard`` (B2);
    (b) regional_failure at n0=1,024 on FABRIC (one site crashes) with SWIM
        confirmation (``detect_failures``);
    (c) fig16's maintenance throughput at N=4,096: incremental against
        full rebuilds on one op stream;
    (d) the batched replica stream, bitwise against per-step calls;
    (e) the card against the CPU port at n0=96, bitwise after every event;
    (f) the obs registry's reading of (a) and its overhead.
    Returns (b)'s events/s (phase probe runs (b) again with the probe)."""
    import torch

    from repro_torch.core import batcheval
    from repro_torch.dynamics import scenarios
    from repro_torch.kernels.minplus import kernel
    from repro_torch.obs import REGISTRY, parse_prometheus

    c = CHURN
    before = parse_prometheus(REGISTRY.render_prometheus())
    trace = scenarios.poisson_churn(
        n0=c["n0"], dist=c["dist"], seed=0, horizon=c["horizon"],
        join_rate=c["rate"], leave_rate=c["rate"])
    eng, res, truth, final_rebuild, _ = replay("(a) replay", trace, counts)
    after = parse_prometheus(REGISTRY.render_prometheus())
    check_obs(trace, res, final_rebuild, before, after)

    truth = forced_adapt(eng, counts)
    live = eng.live_ids()
    reset_all_launches()
    t0 = time.perf_counter()
    d = batcheval.apsp_rowshard(eng.inc.adj[np.ix_(live, live)])
    wall = time.perf_counter() - t0
    got = dict(kernel.launches)
    counts["churn apsp_rowshard"] = got
    want = max(1, int(np.ceil(np.log2(len(live) - 1))))
    err = hold_to_truth("apsp_rowshard of the live block", d, truth)
    log(f"  (a) apsp_rowshard (B2: K1 with a batch of one) of the live "
        f"block N={len(live)}: {wall:.3f} s, launches {got} (expected "
        f"{want} K1 squarings), vs Dijkstra max |diff| {err:.3g}")
    if got != {"minplus_acc": want, "fw_tile": 0}:
        raise AssertionError(f"apsp_rowshard launches {got}")
    del eng, res, truth, d

    fail = scenarios.regional_failure(n0=c["fail_n0"], dist="fabric", seed=0)
    eng, res, _, _, rate_b = replay("(b) regional failure", fail, counts,
                                    detect_failures=True)
    victims = sorted({e.node for e in fail.events})
    if eng.alive[victims].any() or eng.inc.n_live != fail.n0 - len(victims):
        raise AssertionError("(b): a crashed site's node is still live")
    del eng, res

    churn_maintenance()
    churn_stream()
    churn_card_vs_cpu()
    churn_obs_overhead(trace)
    return rate_b


def forced_adapt(eng, counts: dict) -> np.ndarray:
    """(a') One adapt of the engine's own DGRO policy over the live fleet
    of (a), through ``DGROPolicy.maybe_adapt``, with ``selection.adapt``'s
    eps set to 0.5: a keep band of width 0, so the rule must add a ring.
    Its 4 candidates are scored at N~4,000 (K2 + K1) and the winner's new
    edges land in the maintained state as relaxations -- the path an adapt
    takes when rho leaves the keep band, which replay (a) may not reach.
    Its launches are counted, then it is held to scipy; returns the new
    live Dijkstra matrix.  It runs without the profiler, which added ~18 s
    to it (``PERF.md`` §5 keeps its last profile)."""
    import functools

    import torch

    from repro_torch.core import selection
    from repro_torch.kernels.minplus import kernel

    pol = eng.policy
    live = eng.live_ids()
    t0 = time.perf_counter()
    selection.measure_latency_stats(eng.w[np.ix_(live, live)],
                                    eng.inc.adj[np.ix_(live, live)], seed=0)
    log(f"  (a') host: Alg. 3's latency sampling "
        f"(selection.measure_latency_stats), which every adapt call runs "
        f"first, takes {time.perf_counter() - t0:.3f} s over the "
        f"{len(live)} live nodes")
    relax0 = eng.inc.stats["relaxations"]
    with ApspLedger() as ledger:
        selection.adapt = functools.partial(selection.adapt, eps=0.5)
        pol._changes_since_adapt = pol.adapt_every - 1
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pol.maybe_adapt(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = dict(kernel.launches)
    counts["churn (a') forced adapt"] = got
    want = ledger.expected_launches()
    kind, rho = ledger.adapts[-1][1:3]
    added = eng.inc.stats["relaxations"] - relax0
    log(f"  (a') forced adapt: added a {kind} ring (rho {rho:.4f}) as "
        f"{added} relaxations, {ledger.apsps('adapt')} candidates scored "
        f"({sorted({(c[3], c[2]) for c in ledger.calls})}), {wall:.3f} s; "
        f"launches {got} (expected {want})")
    if got != want or ledger.apsps("adapt") < 4 or added < 1:
        raise AssertionError(f"(a'): launches {got} != {want}, or no ring "
                             f"was scored and added")
    live = eng.live_ids()
    truth, d_true = live_truth(eng.inc.adj[np.ix_(live, live)])
    err = hold_to_truth("(a') live distances after the adapt",
                        eng.inc.live_distances(), truth)
    d = eng.inc.diameter(exact=True)
    log(f"  (a') after it: diameter {d!r} vs scipy {d_true!r}, live "
        f"distances vs Dijkstra max |diff| {err:.3g}")
    if not np.isclose(d, d_true, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"(a'): diameter {d} != scipy {d_true}")
    return truth


def check_obs(trace, res, final_rebuild: int, before: dict,
              after: dict) -> None:
    """(f) What the obs registry saw of replay (a), against the engine's own
    counts: one ``repro_engine_events_total`` per trace event by kind, one
    ``repro_jit_*_seconds{fn="incremental.*"}`` observation per relax,
    join, tombstone and rebuild, and the engine calls of
    ``repro_apsp_seconds`` by method and phase."""
    def delta(series: str) -> dict:
        new, old = after.get(series, {}), before.get(series, {})
        return {k: v - old.get(k, 0.0) for k, v in new.items()
                if v != old.get(k, 0.0)}

    def by(label: str, d: dict) -> dict:
        out: dict = {}
        for key, v in d.items():
            name = dict(key).get(label)
            out[name] = out.get(name, 0) + int(v)
        return out

    apsp = {",".join(v for _, v in key): int(n)
            for key, n in delta("repro_apsp_seconds_count").items()}
    events = by("kind", delta("repro_engine_events_total"))
    spans: dict = {}
    for series in ("repro_jit_compile_seconds_count",
                   "repro_jit_execute_seconds_count"):
        for fn, v in by("fn", delta(series)).items():
            spans[fn] = spans.get(fn, 0) + v
    st = res.stats
    want_spans = {"incremental.relax": st["relaxations"] - st["joins"],
                  "incremental.join": st["joins"],
                  "incremental.tombstone": st["leaves"],
                  "incremental.rebuild": 1 + st["rebuilds"] + final_rebuild}
    want_events = {}
    for e in trace.events:
        want_events[e.kind] = want_events.get(e.kind, 0) + 1
    log(f"  (f) obs over (a): repro_apsp_seconds calls by method,phase "
        f"{apsp}; repro_engine_events_total by kind {events} (trace "
        f"{want_events}); repro_jit_*_seconds counts "
        f"{ {k: v for k, v in spans.items() if k.startswith('incremental')} }"
        f" (from stats {want_spans})")
    if events != want_events:
        raise AssertionError(f"engine event counter {events} != trace "
                             f"{want_events}")
    got_spans = {k: spans.get(k, 0) for k in want_spans}
    if got_spans != want_spans:
        raise AssertionError(f"incremental spans {got_spans} != stats "
                             f"{want_spans}")
    if not apsp:
        raise AssertionError("repro_apsp_seconds saw no engine call")


def churn_ops(n_live: int, capacity: int, n_ops: int, seed: int) -> list:
    """fig16's op stream (70% edge inserts, 15% joins, 15% leaves) with its
    own membership bookkeeping; a copy of ``benchmarks/fig16_churn.py``'s
    ``_make_ops``, which imports jax."""
    rng = np.random.default_rng(seed)
    live = list(range(n_live))
    dead = list(range(n_live, capacity))
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.70 or len(live) < 8:
            u, v = rng.choice(live, size=2, replace=False)
            ops.append(("add", int(u), int(v)))
        elif r < 0.85 and dead:
            u = dead.pop(0)
            nbrs = [int(x) for x in rng.choice(live, size=3, replace=False)]
            ops.append(("join", u, tuple(nbrs)))
            live.append(u)
        else:
            u = live.pop(int(rng.integers(len(live))))
            dead.append(u)
            ops.append(("leave", u, ()))
    return ops


def two_ring_state(w: np.ndarray, n_live: int, seed: int):
    """fig16's initial overlay: two random rings over the first ``n_live``
    slots (adjacency, alive mask)."""
    from repro_torch.core.diameter import adjacency_from_edges, ring_edges

    rng = np.random.default_rng(seed)
    alive = np.zeros(w.shape[0], bool)
    alive[:n_live] = True
    edges = np.concatenate([ring_edges(rng.permutation(n_live))
                            for _ in range(2)])
    return adjacency_from_edges(w, edges), alive


def apply_ops(inc, ops) -> float:
    """Apply ``ops`` to ``inc``; seconds until the card has done them."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for op in ops:
        if op[0] == "add":
            inc.add_edge(op[1], op[2])
        elif op[0] == "join":
            inc.join(op[1], list(op[2]))
        else:
            inc.leave(op[1])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def churn_maintenance() -> None:
    """(c) fig16's part A at N=4,096 instead of 128: one seeded op stream
    applied incrementally (all ops) and with a full rebuild after every
    mutation (its first ops only); events/s of each and their ratio
    (reported; the reference gates >= 5x at N=128).  The two end states
    after the same ops agree within rtol 1e-4 / atol 1e-3 after refresh."""
    from repro_torch.core.topology import make_latency
    from repro_torch.dynamics import IncrementalDistances

    c = CHURN
    n, n_ops, n_full = c["maint_n"], c["maint_ops"], c["maint_full_ops"]
    cap = n + max(8, n_ops // 5)
    w = make_latency("bitnode", cap, seed=7)
    adj, alive = two_ring_state(w, n, 0)
    ops = churn_ops(n, cap, n_ops, 1)
    mix = {k: sum(op[0] == k for op in ops) for k in ("add", "join", "leave")}

    def fresh(mode):
        return IncrementalDistances(w, adj, alive, mode=mode,
                                    rebuild_threshold=c["maint_threshold"])

    apply_ops(fresh("incremental"), ops[:4])      # first calls at this shape
    apply_ops(fresh("full"), ops[:2])
    inc = fresh("incremental")
    t_inc = apply_ops(inc, ops)
    full = fresh("full")
    t_full = apply_ops(full, ops[:n_full])
    r_inc, r_full = n_ops / t_inc, n_full / t_full
    log(f"  (c) maintenance N={n} capacity {cap}, {n_ops} ops {mix}, "
        f"threshold {c['maint_threshold']}: incremental {t_inc:.3f} s "
        f"({r_inc:.1f} events/s, stats {inc.stats}); full rebuild after "
        f"each of the first {n_full} ops {t_full:.3f} s ({r_full:.2f} "
        f"events/s); ratio {r_inc / r_full:.1f}x (the reference gates >= 5x "
        f"at N=128; reported here)")
    part = fresh("incremental")
    apply_ops(part, ops[:n_full])
    part.refresh()
    if not np.array_equal(part.alive, full.alive):
        raise AssertionError("(c): incremental and full disagree on alive")
    from repro_torch.core.diameter import INF
    a, b = part.live_distances(), full.live_distances()
    reach = b < float(INF) / 2
    if not np.array_equal(a < float(INF) / 2, reach) or not np.allclose(
            a[reach], b[reach], rtol=1e-4, atol=1e-3):
        raise AssertionError("(c): incremental and full end states differ")
    log(f"  (c) after the same {n_full} ops and a refresh, incremental and "
        f"full agree: max |diff| {np.abs(a[reach] - b[reach]).max():.3g}")


def churn_stream() -> None:
    """(d) ``relax_edge_stream_batched``: B replicas of a C-slot state
    through T steps, bitwise against T calls of ``relax_edges_batched``;
    ms a step by CUDA events (device) and by the wall clock (host)."""
    import torch

    from repro_torch.core.topology import make_latency
    from repro_torch.dynamics import IncrementalDistances
    from repro_torch.dynamics import incremental as incr

    c = CHURN
    b, cap, t_steps = c["replicas"], c["stream_c"], c["stream_t"]
    w = make_latency("bitnode", cap, seed=7)
    adj, alive = two_ring_state(w, cap, 0)
    dist0 = IncrementalDistances(w, adj, alive)._dist
    dists = dist0[None].repeat(b, 1, 1)
    rng = np.random.default_rng(2)
    live = np.flatnonzero(alive)
    iu = rng.integers(0, len(live), size=(t_steps, b))
    off = rng.integers(1, len(live), size=(t_steps, b))
    us, vs = live[iu], live[(iu + off) % len(live)]
    dev = dists.device
    us_t, vs_t = (torch.from_numpy(x).to(dev) for x in (us, vs))
    ws_t = torch.from_numpy(w[us, vs].astype(np.float32)).to(dev)
    got = incr.relax_edge_stream_batched(dists, us_t, vs_t, ws_t)
    want = dists
    for t in range(t_steps):
        want = incr.relax_edges_batched(want, us_t[t], vs_t[t], ws_t[t])
    check_equal(f"(d) stream B={b} C={cap} T={t_steps} vs {t_steps} "
                f"relax_edges_batched calls", got, want)
    dev_ms = time_ms(lambda: incr.relax_edge_stream_batched(
        dists, us_t, vs_t, ws_t), reps=3, warmup=1) / t_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    incr.relax_edge_stream_batched(dists, us_t, vs_t, ws_t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / t_steps
    nbytes = 4.0 * b * cap * cap
    log(f"  (d) stream: {dev_ms:.4f} ms a step on the device, {wall_ms:.4f} "
        f"ms a step by the wall clock ({b / wall_ms * 1e3:.0f} relaxations/s"
        f"); a step reads and writes the {nbytes / 1e6:.1f} MB stack "
        f"(at least {2 * nbytes / BYTES_PER_S * 1e3:.4f} ms)")


def churn_card_vs_cpu() -> None:
    """(e) One poisson_churn trace at n0=96 under DGRO, replayed event by
    event on the card and on the CPU port.  The CPU side runs the card's
    APSP method (``squaring``: K1 on the card, its plain twin on the CPU,
    bitwise equal); the relax, join and tombstone are elementwise fp32 in
    the same order.  The maintained distances, adjacency, alive mask and
    stats must be bitwise equal after every event, and every adapt
    decision identical; the first event where they part is printed."""
    import torch

    from repro_torch.core import batcheval
    from repro_torch.dynamics import ChurnEngine, DGROPolicy, scenarios

    trace = scenarios.poisson_churn(n0=CHURN["parity_n0"], seed=0)
    on_cpu = dict(device="cpu", method="squaring")
    with ApspLedger() as ledger:
        card = ChurnEngine(trace, DGROPolicy(), seed=0)
        with batcheval.eval_options(**on_cpu):
            cpu = ChurnEngine(trace, DGROPolicy(), seed=0)

        def same(tag):
            parts = {
                "distances": torch.equal(card.inc._dist.cpu(),
                                         cpu.inc._dist),
                "adjacency": np.array_equal(card.inc.adj, cpu.inc.adj),
                "alive": np.array_equal(card.alive, cpu.alive),
                "stats": card.inc.stats == cpu.inc.stats,
                "adaptations": (card.policy.adaptations
                                == cpu.policy.adaptations)}
            if not all(parts.values()):
                d = (card.inc._dist.cpu() - cpu.inc._dist).abs().max()
                log(f"  (e) card and CPU part at {tag}: {parts}, max |diff| "
                    f"{float(d)}")
                raise AssertionError(f"(e): card and CPU part at {tag}")

        same("the initial state")
        events = sorted(trace.events, key=lambda e: e.time)
        for i, e in enumerate(events):
            card.process(e)
            with batcheval.eval_options(**on_cpu):
                cpu.process(e)
            same(f"event {i} ({e.kind} node {e.node} at t={e.time:.1f})")
        d_card = card.inc.diameter(exact=True)
        with batcheval.eval_options(**on_cpu):
            d_cpu = cpu.inc.diameter(exact=True)
    decisions = {dev: [(k, r) for d, k, r, _ in ledger.adapts if d == dev]
                 for dev in ("cuda", "cpu")}
    log(f"  (e) card vs CPU at n0={trace.n0}, capacity {trace.capacity}: "
        f"{len(events)} events, bitwise equal distances, adjacency, alive "
        f"and stats after each; {len(decisions['cuda'])} adapt decisions "
        f"{[k for k, _ in decisions['cuda']]}; exact diameters {d_card!r} / "
        f"{d_cpu!r}; stats {card.inc.stats}")
    if decisions["cuda"] != decisions["cpu"] or d_card != d_cpu:
        raise AssertionError(f"(e): adapt decisions or diameters differ: "
                             f"{decisions}, {d_card} vs {d_cpu}")


def churn_obs_overhead(trace) -> None:
    """(f) The instrumented overhead: the first events of replay (a) on
    copies of one fresh engine, with the registry disabled and enabled in
    the order off, on, on, off; the wall of each until the card is done."""
    import copy

    import torch

    from repro_torch.dynamics import ChurnEngine, DGROPolicy
    from repro_torch.obs import REGISTRY

    c = CHURN
    base = ChurnEngine(trace, DGROPolicy(k_rings=c["k_rings"],
                                         adapt_every=c["adapt_every"]),
                       rebuild_threshold=c["threshold"])
    events = sorted(trace.events, key=lambda e: e.time)[:c["overhead_events"]]
    walls = {False: [], True: []}
    try:
        for enabled in (False, True, True, False):
            eng = copy.deepcopy(base)
            REGISTRY.set_enabled(enabled)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for e in events:
                eng.process(e)
            torch.cuda.synchronize()
            walls[enabled].append(time.perf_counter() - t0)
    finally:
        REGISTRY.set_enabled(True)
    off, on = np.mean(walls[False]), np.mean(walls[True])
    log(f"  (f) obs overhead over the first {len(events)} events of (a): "
        f"disabled {walls[False]} s, enabled {walls[True]} s; enabled / "
        f"disabled {on / off:.4f} (the reference gates 5% at its fig18; "
        f"reported here)")
    eng = copy.deepcopy(base)

    def first_events():
        for e in events:
            eng.process(e)

    profiled(f"churn replay (a), first {len(events)} events", first_events)


ROUTE = dict(pairs=4096, host_pairs=512, gate_n=256, gate_pairs=1024,
             gate_budget=64)


def same_route(what: str, got, want, rows=None) -> None:
    """Fail unless two RouteResults agree bitwise on every per-pair field
    (on ``got``'s first ``rows`` pairs when ``want`` routed only those)."""
    for f in ("hops", "latency", "success", "failed", "optimum", "stretch"):
        a, b = getattr(got, f), getattr(want, f)
        a = a if rows is None else a[:rows]
        if not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            raise AssertionError(f"{what}: {f} differs")


def phase_routing(ov, counts: dict) -> None:
    """(r) Greedy routing over phase build's overlay at N=4096: P=4,096
    pairs of every workload under both policies on the card, each held
    bitwise against the CPU port's ``route_pairs`` on all pairs and the
    numpy host loop on the first 512; pairs/s, hops, host syncs per call
    and the wall.  Then fig19's shape: the router against the host loop
    at N=256, P=1,024 (the reference gates >= 5x; reported here)."""
    import warnings

    import torch

    from repro_torch import overlay, routing
    from repro_torch.core import batcheval
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel

    n, p, hp = ov.n, ROUTE["pairs"], ROUTE["host_pairs"]
    dist = ov.distances()            # the build's exact APSP (tiled, cached)
    dist_dev = torch.from_numpy(dist).cuda()
    adj, ring = ov.adjacency, np.asarray(ov.rings[0])
    warm = routing.sample_pairs(n, 64, "uniform", seed=99)
    for policy in routing.POLICIES:  # CUDA's lazy set-up, outside the timing
        routing.route_pairs(adj, dist_dev, warm, policy=policy, ring=ring)
    reset_all_launches()
    for kind in routing.WORKLOADS:
        pairs = routing.sample_pairs(n, p, kind, seed=0)
        for policy in routing.POLICIES:
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    res = routing.route_pairs(adj, dist_dev, pairs,
                                              policy=policy, ring=ring)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                wall = time.perf_counter() - t0
            syncs, where = count_syncs(seen)
            with batcheval.eval_options(device="cpu"):
                cpu = routing.route_pairs(adj, dist, pairs, policy=policy,
                                          ring=ring)
            host = routing.route_pairs_host(adj, dist, pairs[:hp],
                                            policy=policy, ring=ring)
            what = f"(r) {kind} {policy}"
            same_route(f"{what} card vs CPU", res, cpu)
            same_route(f"{what} card vs host loop", res, host, rows=hp)
            ok = res.success
            stretch = res.stretch[ok]
            log(f"  {what}: {p} pairs in {wall * 1e3:.1f} ms, "
                f"{p / wall:.0f} pairs/s; success {ok.mean():.4f}, "
                f"dead ends {int(res.failed.sum())}; hops p50 "
                f"{np.percentile(res.hops[ok], 50):.0f} max "
                f"{int(res.hops.max())}; stretch mean {stretch.mean():.4f} "
                f"max {stretch.max():.4f}; host syncs {syncs} at {where}; "
                f"bitwise equal to the CPU's route_pairs ({p} pairs) and the"
                f" host loop (first {hp})")
    counts["routing"] = dict(kernel.launches)

    # fig19's gate shape: Chord on bitnode, N=256, P=1,024, budget 64
    g = ROUTE["gate_n"]
    gov = overlay.build("chord", make_latency("bitnode", g, seed=0), seed=0)
    gdist = gov.distances()
    gpairs = routing.sample_pairs(g, ROUTE["gate_pairs"], "uniform", seed=1)
    kw = dict(policy="latency", ring=np.asarray(gov.rings[0]),
              hop_budget=ROUTE["gate_budget"])
    dev = routing.route_pairs(gov.adjacency, gdist, gpairs, **kw)
    t_dev = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        routing.route_pairs(gov.adjacency, gdist, gpairs, **kw)
        t_dev = min(t_dev, time.perf_counter() - t0)
    t0 = time.perf_counter()
    host = routing.route_pairs_host(gov.adjacency, gdist, gpairs, **kw)
    t_host = time.perf_counter() - t0
    same_route("(r) fig19 shape", dev, host)
    log(f"  (r) fig19 shape (Chord, bitnode, N={g}, P={len(gpairs)}, latency,"
        f" budget {ROUTE['gate_budget']}): card router {t_dev * 1e3:.2f} ms "
        f"(best of 3, distances uploaded each call), host loop "
        f"{t_host * 1e3:.1f} ms, ratio {t_host / t_dev:.2f}x (the reference "
        f"gates >= 5x; reported); bitwise equal")
    profiled(f"route_pairs N={n}, P={p}, uniform, latency",
             lambda: routing.route_pairs(
                 adj, dist_dev, routing.sample_pairs(n, p, "uniform",
                                                     seed=0),
                 policy="latency"))


def phase_probe(counts: dict, rate_b: float) -> None:
    """(p) The churn engine's routing probe: replay (e) (poisson_churn
    n0=96 under DGRO) with ``route_probe=2`` on the card and on the CPU
    port (the card's APSP method), every sample's diameter and stretch
    bitwise equal; then replay (b) (regional failure n0=1,024) once more
    with ``route_probe=8, route_pairs=256``, its events/s beside (b)'s."""
    from repro_torch.core import batcheval
    from repro_torch.dynamics import ChurnEngine, DGROPolicy, scenarios
    from repro_torch.kernels.minplus import kernel

    trace = scenarios.poisson_churn(n0=CHURN["parity_n0"], seed=0)
    reset_all_launches()
    card = ChurnEngine(trace, DGROPolicy(), seed=0, route_probe=2).run()
    launches = counts["probe (e')"] = dict(kernel.launches)
    with batcheval.eval_options(device="cpu", method="squaring"):
        cpu = ChurnEngine(trace, DGROPolicy(), seed=0, route_probe=2).run()
    a = np.array([(s.diameter, s.stretch) for s in card.samples])
    b = np.array([(s.diameter, s.stretch) for s in cpu.samples])
    probed = int(np.isfinite(a[:, 1]).sum())
    log(f"  (e') probe at n0={trace.n0}, route_probe=2: {len(a)} samples, "
        f"{probed} probed, mean stretch {card.mean_stretch!r} (CPU "
        f"{cpu.mean_stretch!r}); launches {launches}")
    if probed < 4 or not np.array_equal(a, b, equal_nan=True):
        raise AssertionError("(e'): the card's samples differ from the CPU's")
    log("  (e') every sample's diameter and stretch bitwise equal to the "
        "CPU's")
    fail = scenarios.regional_failure(n0=CHURN["fail_n0"], dist="fabric",
                                      seed=0)
    eng, res, _, _, rate = replay("(b') regional failure + probe", fail,
                                  counts, detect_failures=True,
                                  route_probe=8, route_pairs=256)
    stretch = [s.stretch for s in res.samples if np.isfinite(s.stretch)]
    log(f"  (b') {len(stretch)} probes of 256 pairs, stretch "
        f"{min(stretch):.4f}..{max(stretch):.4f}; {rate:.2f} events/s "
        f"against (b)'s {rate_b:.2f} without the probe")
    if not stretch or min(stretch) < 1 - 1e-4:
        raise AssertionError(f"(b'): probe stretch {stretch}")


HIER = dict(n=100_000, events=200, route_pairs=4096, equal_n=16_384,
            exact_n=512)


def hier_events(n: int, capacity: int, n_events: int, seed: int) -> list:
    """A churn stream over a fleet of ``n`` live nodes in ``capacity``
    slots: leaves of random live nodes alternating with joins of random
    free slots (the slow N=10^5 smoke's stream of ``tests/test_hier.py``,
    every event effective), then fig21's two reorganizations: split
    cluster 0, merge cluster 2 into 1."""
    from repro_torch.dynamics.scenarios import Event

    rng = np.random.default_rng(seed)
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    events, t = [], 0.0
    for i in range(n_events):
        t += 1.0
        pool = np.flatnonzero(alive if i % 2 == 0 else ~alive)
        u = int(pool[rng.integers(pool.size)])
        alive[u] = i % 2 == 1
        events.append(Event(time=t, kind="join" if alive[u] else "leave",
                            node=u))
    events.append(Event(time=t + 1.0, kind="cluster_split", node=0))
    events.append(Event(time=t + 2.0, kind="cluster_merge", node=1, peer=2))
    return events


def phase_hier(counts: dict) -> None:
    """(h) fig21 part A on the card: ``build_hier`` over a synthetic-geo
    world of N=10^5 (lazy latency blocks, never the 40 GB matrix; the
    clusters' nearest rings in chunks on the card, the head ring's DGRO
    scored by K1), its ``diameter_bound("ecc")``; a ``HierChurnEngine`` at
    capacity N+8 streaming 200 churn events plus a split and a merge, its
    K1 launches held to the cluster APSPs it asked for; ``route_pairs_hier``
    over 4,096 uniform pairs.  Then the card against the CPU port:
    ``build_hier`` at N=16,384 equal (``.equals`` and ``to_json`` byte for
    byte), and fig21 part B at N=512: ``diameter_bound("exact")`` equal to
    scipy's diameter of ``materialize()``."""
    import torch

    from repro_torch import routing
    from repro_torch.core import batcheval
    from repro_torch.core.diameter import diameter_scipy
    from repro_torch.core.topology import make_latency
    from repro_torch.dynamics.scenarios import Trace
    from repro_torch.hier import (DenseLatency, HierChurnEngine, HierConfig,
                                  build_hier, core, route_pairs_hier,
                                  synthetic_geo)
    from repro_torch.kernels.minplus import kernel

    n = HIER["n"]
    chunks = []
    batched = core.nearest_rings_batched

    def counted(blocks, starts):
        chunks.append(tuple(blocks.shape))
        return batched(blocks, starts)

    lat = synthetic_geo(n, seed=0)
    core.nearest_rings_batched = counted
    reset_all_launches()
    try:
        with ApspLedger() as ledger:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hov = build_hier(lat, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        core.nearest_rings_batched = batched
    got = counts["hier build"] = dict(kernel.launches)
    sizes = hov.cluster_sizes()
    log(f"  (h) build_hier N={n} synthetic-geo: {wall:.2f} s wall, "
        f"{hov.n_clusters} clusters of {sizes.min()}..{sizes.max()} nodes, "
        f"{len(chunks)} nearest-ring chunks {chunks}; the head ring's "
        f"build: {ledger.apsps()} APSPs, launches {got} (expected "
        f"{ledger.expected_launches()})")
    if got != ledger.expected_launches() or got["minplus_acc"] < 1:
        raise AssertionError(f"(h) build launches {got}")
    t0 = time.perf_counter()
    d, stamp = hov.diameter_bound("ecc")
    log(f"  (h) diameter_bound('ecc') {d!r} ({stamp}), "
        f"{time.perf_counter() - t0:.2f} s of scipy Dijkstra")
    if stamp != "upper" or not np.isfinite(d) or d <= 0:
        raise AssertionError(f"(h) diameter bound {d} {stamp}")

    pairs = routing.sample_pairs(n, HIER["route_pairs"], "uniform", seed=0)
    reset_all_launches()
    with ApspLedger() as ledger:
        ledger.tag = "route"
        t0 = time.perf_counter()
        res = route_pairs_hier(hov, pairs)
        wall = time.perf_counter() - t0
    got = counts["hier route"] = dict(kernel.launches)
    ok = res.success
    log(f"  (h) route_pairs_hier {len(pairs)} uniform pairs: {wall:.2f} s "
        f"wall ({len(pairs) / wall:.0f} pairs/s), success {ok.mean():.4f}, "
        f"hops p50 {np.percentile(res.hops[ok], 50):.0f} (local "
        f"{np.percentile(res.hops_local[ok], 50):.0f}, head "
        f"{np.percentile(res.hops_head[ok], 50):.0f}), stretch mean "
        f"{res.stretch[ok].mean():.4f}; {ledger.apsps()} APSPs of the "
        f"touched clusters, launches {got} (expected "
        f"{ledger.expected_launches()})")
    if got != ledger.expected_launches():
        raise AssertionError(f"(h) hier route launches {got}")
    if ok.mean() < 0.99 or (res.stretch[ok] < 1 - 1e-4).any():
        raise AssertionError(f"(h) hier routing success {ok.mean()}")
    # a slice under the profiler: its trace of the whole batch (~300,000
    # device ops) takes the profiler minutes to reduce, 512 pairs (~155,000)
    # about half a minute
    profiled(f"route_pairs_hier N={n}, P=128 of them (cluster APSPs "
             f"cached)", lambda: route_pairs_hier(hov, pairs[:128]))
    del hov, res

    cap = n + 8
    events = hier_events(n, cap, HIER["events"], seed=0)
    trace = Trace(n0=n, capacity=cap, dist="bitnode", seed=0, events=events,
                  name="fig21-scale")
    lat = synthetic_geo(cap, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with ApspLedger() as ledger:
        ledger.tag = "boot"
        t0 = time.perf_counter()
        eng = HierChurnEngine(trace, lat=lat, seed=0)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        boot = counts["hier engine boot"] = dict(kernel.launches)
        boot_want = ledger.expected_launches()
        n_boot = ledger.apsps()
        ledger.calls.clear()
        ledger.tag = "events"
        reset_all_launches()
        t0 = time.perf_counter()
        for e in events:
            eng.process(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = counts["hier engine"] = dict(kernel.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"  (h) HierChurnEngine at capacity {cap}: boot {boot_s:.2f} s "
        f"({eng.n_clusters} clusters + the head graph: {n_boot} APSPs, "
        f"launches {boot}, expected {boot_want})")
    rebuilds = ledger.apsps("rebuild")
    log(f"  (h) {len(events)} events ({HIER['events']} joins/leaves, a split,"
        f" a merge) in {wall:.3f} s, {len(events) / wall:.2f} events/s; "
        f"stats {eng.stats()}; {rebuilds} APSPs of rebuilt states, launches"
        f" {got} (expected {ledger.expected_launches()}, "
        f"{got['minplus_acc'] / max(rebuilds, 1):.2f} K1 a rebuild); "
        f"max_memory_allocated {peak} B")
    if boot != boot_want or got != ledger.expected_launches():
        raise AssertionError(f"(h) engine launches {boot}, {got}")
    if eng.reorg_stats["splits"] != 1 or eng.reorg_stats["merges"] != 1:
        raise AssertionError(f"(h) reorgs {eng.reorg_stats}")
    t0 = time.perf_counter()
    d = eng.diameter()
    log(f"  (h) maintained diameter {d!r} ({time.perf_counter() - t0:.2f} "
        f"s), {eng.pending_deletions} deletions pending")
    if not np.isfinite(d) or d <= 0:
        raise AssertionError(f"(h) maintained diameter {d}")
    del eng

    m = HIER["equal_n"]
    lat = synthetic_geo(m, seed=0)
    t0 = time.perf_counter()
    card = build_hier(lat, seed=0)
    t_card = time.perf_counter() - t0
    with batcheval.eval_options(device="cpu", method="squaring"):
        t0 = time.perf_counter()
        cpu = build_hier(lat, seed=0)
        t_cpu = time.perf_counter() - t0
    same = card.equals(cpu) and card.to_json() == cpu.to_json()
    log(f"  (h) build_hier N={m}: card {t_card:.2f} s, CPU port "
        f"{t_cpu:.2f} s (squaring); {card.n_clusters} clusters; .equals "
        f"and to_json byte-identical: {same}")
    if not same:
        raise AssertionError(f"(h) the card's build at N={m} != the CPU's")

    k = HIER["exact_n"]
    w = make_latency("bitnode", k, seed=2)
    small = build_hier(DenseLatency(w), HierConfig(k_local=12), seed=0)
    d, stamp = small.diameter_bound("exact")
    want = diameter_scipy(small.materialize().adjacency)
    log(f"  (h) fig21 part B, N={k} bitnode: diameter_bound('exact') {d!r} "
        f"({stamp}) vs scipy's diameter of materialize() {want!r}")
    if stamp != "exact" or not np.isclose(d, want, rtol=1e-5, atol=0.0):
        raise AssertionError(f"(h) exact bound {d} != scipy {want}")


SERVICE = (("dgro", 1024, 200), ("dgro-hier", 10_000, 200))


def phase_service() -> None:
    """(s) The control-plane daemon on the card: the port's service smoke
    (``tools/torch_service_smoke.py``) against ``python -m
    repro_torch.service`` twice -- flat DGRO at n0=1,024 and ``dgro-hier``
    at n0=10,000, 200 poisson events each.  The smoke asserts every
    endpoint, the metrics counters against what it streamed and a clean
    exit; its last line carries the numbers printed here.  A smoke that
    outlives 400 s gets SIGABRT with its daemon (its own process group),
    so that Python's faulthandler prints every thread's stack, then
    SIGKILL, and what both printed is logged."""
    for policy, n0, n_events in SERVICE:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "torch_service_smoke.py"),
             "--policy", policy, "--n0", str(n0), "--events", str(n_events),
             "--device", "cuda"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, start_new_session=True,
            env={**os.environ, "PYTHONFAULTHANDLER": "1"})
        try:
            stdout, stderr = proc.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGABRT)
            time.sleep(5)
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            stdout, stderr = proc.communicate()
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            log(stdout[-3000:])
            log(stderr[-6000:])
            raise AssertionError(f"(s) {policy}: smoke exited "
                                 f"{proc.returncode} after {wall:.1f} s")
        lines = stdout.strip().splitlines()
        r = json.loads(lines[-1])
        log(f"  (s) {lines[-2]}")
        log(f"  (s) {policy} n0={n0} capacity {r['capacity']}: daemon up in "
            f"{r['boot_s']:.2f} s; {r['events']} events in "
            f"{r['ingest_s']:.3f} s ({r['events_per_s']:.1f} events/s over "
            f"HTTP); route query p50 {r['route_ms_p50']:.2f} ms, max "
            f"{r['route_ms_max']:.2f} ms over {r['route_queries']} "
            f"({r['route_delivered']} delivered); exact diameter "
            f"{r['diameter_exact']!r}; reopt cycles {r['reopt_cycles']}; "
            f"clusters {r['clusters']}; {wall:.1f} s in all")
        if "error" in r["reopt_cycles"]:
            raise AssertionError(f"(s) {policy}: a reopt cycle failed: "
                                 f"{r['reopt_cycles']}")


# phase (d): every rank on the card, gemma3-1b at full width
DIST = dict(ranks=4, timeout=600, n=4096, emb=(262_144, 1_152),
            small=1_000_003, layers=4, seq=1024, steps=2, lr=3e-3,
            ce_chunk=256)
# (d-f): moonshot at full width cut to 2 of 48 layers, mesh (data 1, model 4)
DIST_TP = dict(arch="moonshot-v1-16b-a3b", layers=2, batch=2, seq=1024,
               steps=2, lr=3e-3, ce_chunk=256, mesh=(1, 4))
# (d-g): serving over mesh (data 1, model 4), every part held to the
# one-device port on the card: (d-g1) gemma3-1b at full width and depth
# (its one KV head: every cache split over slots, K6's partial form on
# every decode layer); (d-g2) zamba2-7b at full width cut to 6 of 81
# layers (one shared-attention call) and (d-g3) falcon-mamba-7b at full
# width cut to 4 of 64, each served and trained one step (remat)
# logit_tol: max |diff| / max |logit| of a row, the CPU parity tests'
# bound (tests/test_torch_tp_serve.py), which a merge or slot-ownership
# fault at 1e-5 would pass no more than there
DIST_SERVE = dict(
    mesh=(1, 4), logit_tol=1e-5, tie=1e-5,
    parts=(dict(tag="g1", arch="gemma3-1b", layers=None, batch=8,
                prompt_len=1000, max_len=1024, steps=16),
           dict(tag="g2", arch="zamba2-7b", layers=6, batch=4,
                prompt_len=512, max_len=528, steps=8, train=(2, 512)),
           dict(tag="g3", arch="falcon-mamba-7b", layers=4, batch=4,
                prompt_len=512, max_len=528, steps=8, train=(2, 1024))))


def _digest(t) -> str:
    """sha256 of a tensor's or an array's bytes (bitwise comparisons
    across processes)."""
    import hashlib

    import torch

    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _tree_digest(tree) -> str:
    """A fingerprint of a tree's bits computed on its device: for each
    leaf, in slices of 2^24 elements, the wrapping int64 sums of the
    32-bit words and of each word times (1 + its place in the slice).  Any
    one differing word changes the second sum by a nonzero product below
    2^56; the sums of every leaf are hashed together."""
    import hashlib

    import torch

    from repro_torch.train.optimizer import tree_leaves

    h = hashlib.sha256()
    place = None
    for leaf in tree_leaves(tree):
        words = leaf.detach().contiguous().reshape(-1).view(torch.int32)
        sums = []
        for lo in range(0, words.numel(), 1 << 24):
            w = words[lo:lo + (1 << 24)].to(torch.int64)
            if place is None or place.device != w.device:
                place = torch.arange(1, (1 << 24) + 1, device=w.device)
            sums.append(torch.stack([w.sum(), (w * place[:w.numel()]).sum()]))
        h.update(torch.stack(sums).cpu().numpy().tobytes())
    return h.hexdigest()


def _counted(out: dict, key: str, fn):
    """Run ``fn`` on this rank with every launch count and the transport's
    counters reset just before; keep its wall, K1 / K2 launches and
    traffic under ``out[key]``.  Returns ``fn``'s result."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.kernels.minplus import kernel as mp

    reset_all_launches()
    D.TRAFFIC.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    out[key] = {"wall": time.perf_counter() - t0,
                "launches": {**mp.launches, **lm_launches()},
                "traffic": dict(vars(D.TRAFFIC))}
    return res


def _ring_chunk_check(got, parts, first: int, scale: float) -> tuple:
    """One ring chunk: ``got`` (flat) against ``scale`` x the fp64 sum of
    the ranks' ``parts`` of it (ring order; the chunk starts at rank
    ``first``), within ``scale`` x ``chunk_error_bound`` plus 2^-22 of the
    value (the fp32 multiply by ``scale``).  Returns (within, worst
    |diff| / bound, max |diff|)."""
    import torch

    from repro_torch.train.collectives import chunk_error_bound

    exact = torch.zeros(got.numel(), dtype=torch.float64, device=got.device)
    for p in parts:
        exact += p.to(torch.float64)
    exact *= scale
    bound = chunk_error_bound(parts, first) * scale + exact.abs() * 2.0 ** -22
    diff = (got.to(torch.float64) - exact).abs()
    return (bool((diff <= bound).all()), float((diff / bound).max()),
            float(diff.max()))


def _fold(checks) -> dict:
    return {"d_within": all(c[0] for c in checks),
            "d_worst": max(c[1] for c in checks),
            "d_err": max(c[2] for c in checks)}


def dist_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of phase (d): every check's numbers, as plain values."""
    import dataclasses

    import torch

    from repro_torch import distributed as D
    from repro_torch.configs import get_arch
    from repro_torch.core import batcheval, parallel
    from repro_torch.core.diameter import largest_cc_diameter
    from repro_torch.core.topology import make_latency
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import collectives as C
    from repro_torch.train import pod_compress as PC
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             tree_leaves, warmup_cosine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    torch.cuda.set_per_process_memory_fraction(0.9 / world)
    out: dict = {}
    line = Mesh(np.arange(world), ("batch",))
    n = spec["n"]

    marks = out["marks"] = [("start", time.time())]
    # (d-a) sharded scoring of fig20's genomes
    src = batcheval.RingBlockSource(make_latency("uniform", n, seed=n),
                                    np.load(spec["genomes"]))
    out["a_diam"] = _counted(out, "a",
                             lambda: batcheval.diameters_sharded(
                                 src, mesh=line, device=dev))
    out["a_report"] = batcheval.last_eval_report()

    marks.append(("(d-a)", time.time()))
    # (d-b) row-sharded APSP of the build's overlay
    adj = np.load(spec["adj"])
    rows = _counted(out, "b", lambda: batcheval.apsp_rowshard(
        adj, mesh=Mesh(np.arange(world), ("rows",)), device=dev))
    out["b_digest"] = _digest(rows)
    out["b_diam"] = float(largest_cc_diameter(torch.from_numpy(rows)[None]))
    del rows, adj

    marks.append(("(d-b)", time.time()))
    # (d-c) partitioned construction, one partition a rank
    w = make_latency("fabric", n, seed=0)
    with batcheval.eval_options(device=dev):
        out["c_ring"] = _counted(
            out, "c", lambda: parallel.parallel_ring_shmap(
                w, Mesh(np.arange(world), ("partitions",)), seed=0))

    marks.append(("(d-c)", time.time()))
    # (d-d) the int8 ring all-reduce
    ring = Mesh(np.arange(world), ("data",)).group("data")

    def leaf(r: int):
        g = torch.Generator(device=dev).manual_seed(1000 + r)
        return torch.randn(spec["emb"], generator=g, device=dev) * 1e-2

    x = leaf(rank)
    y = _counted(out, "d", lambda: C.ring_allreduce(x, ring))
    out["d_digest"] = _digest(y)
    if rank == 0:     # the fp64 sum and the bound, from every rank's seed
        xs = [leaf(r).reshape(-1) for r in range(world)]
        out.update(_fold([_ring_chunk_check(y.reshape(-1)[lo:hi],
                                            [x[lo:hi] for x in xs], c, 1.0)
                          for c, lo, hi in C.ring_chunks(x.numel(), world)]))
        del xs
    del x, y
    xs_cpu = torch.randn(spec["small"],
                         generator=torch.Generator().manual_seed(2000 + rank))
    y_card = _counted(out, "d_small", lambda: C.ring_allreduce(
        xs_cpu.to(dev), ring))
    y_cpu = C.ring_allreduce(xs_cpu, ring)
    out["d_small_equal"] = bool(torch.equal(y_card.cpu(), y_cpu))
    torch.cuda.empty_cache()     # give the cache back: 4 ranks share a card

    marks.append(("(d-d) and its check", time.time()))
    # (d-e) pod-compressed training of gemma3-1b cut to 4 layers
    cfg = get_arch("gemma3-1b")
    cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    lr, steps = spec["lr"], spec["steps"]
    tc = TT.TrainConfig(optimizer=AdamWConfig(
        lr=lr, weight_decay=0.1,
        schedule=warmup_cosine(lr, warmup=max(steps // 20, 5),
                               total=steps)), remat=True,
        ce_chunk=spec["ce_chunk"])
    mesh = Mesh(np.asarray(spec["pod_order"]).reshape(world, 1, 1),
                ("pod", "data", "model"))
    step = PC.pod_compressed_train_step(cfg, tc, mesh)
    pods = mesh.group("pod")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                  global_batch=world,
                                  mean_doc_len=spec["seq"] / 2))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                PC.shard_batch(data.batch(i), mesh).items()}
               for i in range(steps)]
    params = TT.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev).params
    out["e_params"] = sum(p.numel() for p in tree_leaves(params))
    marks.append(("(d-e) set-up", time.time()))
    # step 1's reduced gradient against the exact fp32 mean, within the
    # ring's bound: every rank's gradients gathered a ring chunk at a time
    _, _, grads = TT.loss_and_grads(cfg, tc, params, batches[0])
    reduced = C.compressed_grad_mean(grads, pods)
    inv = float(np.float32(1.0) / np.float32(world))
    checks = []
    for gl, rl in zip(tree_leaves(grads), tree_leaves(reduced)):
        flat, red = gl.reshape(-1), rl.reshape(-1)
        for c, lo, hi in C.ring_chunks(flat.numel(), world):
            parts = D.all_gather(flat[lo:hi][None], pods)
            if rank == 0:
                checks.append(_ring_chunk_check(red[lo:hi], list(parts), c,
                                                inv))
            del parts
    if rank == 0:
        out["e_grad"] = _fold(checks)
    del grads, reduced
    marks.append(("(d-e) gradient check", time.time()))
    state = TT.TrainState(params, adamw_init(params))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["e_steps"] = []
    for i in range(steps):
        state, met = _counted(out, "e_step",
                              lambda: step(state, batches[i]))
        rec = out.pop("e_step")
        rec.update(loss=float(met["loss"]), gnorm=float(met["grad_norm"]),
                   digest=_tree_digest(state.params))
        out["e_steps"].append(rec)
    marks.append(("(d-e) steps and digests", time.time()))
    out["e_peak"] = torch.cuda.max_memory_allocated()
    out["e_expected"] = expected_train_launches(cfg)
    del state, batches, params, step, met
    torch.cuda.empty_cache()
    tp_rank(rank, world, spec, out, dev)
    marks.append(("(d-f) tensor / expert parallel steps", time.time()))
    torch.cuda.empty_cache()
    for part in DIST_SERVE["parts"]:
        serve_tp_rank(rank, world, part, spec, out, dev)
        torch.cuda.empty_cache()
        marks.append((f"(d-{part['tag']}) {part['arch']} over the mesh",
                      time.time()))
    return out


def tp_train_setup(dev):
    """(d-f)'s config, train config and global batch (the port's Markov
    data, seeded), on ``dev``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import upload
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import AdamWConfig, warmup_cosine

    f = DIST_TP
    cfg = dataclasses.replace(get_arch(f["arch"]), n_layers=f["layers"])
    tc = TT.TrainConfig(optimizer=AdamWConfig(
        lr=f["lr"], weight_decay=0.1,
        schedule=warmup_cosine(f["lr"], warmup=5, total=f["steps"])),
        remat=True, ce_chunk=f["ce_chunk"])
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=f["seq"],
                                  global_batch=f["batch"],
                                  mean_doc_len=f["seq"] / 2))
    batches = [{k: upload(v, dev) for k, v in data.batch(i).items()}
               for i in range(f["steps"])]
    return cfg, tc, batches


def tp_reference(work: str, dev) -> dict:
    """(d-f)'s yardstick, in the parent before the ranks start: the
    one-device port's step-1 loss, grad norm and gradient at the same seed
    on the card.  The gradient leaves go to ``work`` as .npy files (each
    rank reads its blocks of them), the router probabilities of the two
    MoE layers beside them; the card's memory is given back."""
    import torch

    from repro_torch.models.convert import flatten
    from repro_torch.models.model import init_params
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import global_norm

    cfg, tc, batches = tp_train_setup(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    with router_probs() as seen:
        loss, met, grads = TT.loss_and_grads(cfg, tc, params, batches[0])
    gnorm = float(global_norm(grads))
    step_s = time.perf_counter() - t0
    os.makedirs(work, exist_ok=True)
    np.save(os.path.join(work, "probs.npy"),
            torch.stack(seen[:cfg.n_layers]).cpu().numpy())
    flat = flatten(grads)
    for name, g in flat.items():
        np.save(os.path.join(work, name.replace("/", "__") + ".npy"),
                g.cpu().numpy())
    n_params = sum(p.numel() for p in flat.values())
    del params, grads, flat, seen
    torch.cuda.empty_cache()
    return {"loss": float(loss), "aux": float(met["aux"]), "gnorm": gnorm,
            "dir": work, "n_params": n_params, "wall": step_s,
            "saved_s": time.perf_counter() - t0 - step_s}


def tp_rank(rank: int, world: int, spec: dict, out: dict, dev) -> None:
    """(d-f) on this rank: moonshot at full width, 2 layers, expert and
    tensor parallel over mesh (data 1, model 4) from the same seed as
    ``tp_reference``: step 1's loss, grad norm and gradient blocks against
    the one-device step's (per leaf, max |diff| and max |want| of this
    rank's block), routing against the one-device pass, then 2 steps with
    their walls, traffic, launches and the whole leaves' digests."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shardings import (batch_specs, local_slice,
                                              spec_axes)
    from repro_torch.models.convert import flatten
    from repro_torch.models.model import init_params, pattern_period
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import adamw_update, tree_leaves

    ref = spec["tp_ref"]
    cfg, tc, batches = tp_train_setup(dev)
    mesh = Mesh(np.arange(world).reshape(DIST_TP["mesh"]), ("data", "model"))
    specs = TT.state_layout(cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = TT.init_sharded_state(
        cfg, specs, mesh, rank, torch.Generator(device=dev).manual_seed(0),
        device=dev)
    torch.cuda.synchronize()
    # the init's peak over what the rank held before it, beside its blocks
    # and the largest leaf drawn whole
    out["f_init_peak"] = torch.cuda.max_memory_allocated() - before
    out["f_state_bytes"] = sum(
        t.numel() * t.element_size()
        for t in tree_leaves(state.params) + tree_leaves(state.opt))
    out["f_whole_leaf"] = max(
        t.numel() * t.element_size()
        for t in tree_leaves(init_params(cfg, device="meta")))
    torch.cuda.empty_cache()
    out["f_setup"] = time.perf_counter() - t0
    local = []
    for b in batches:
        bs = batch_specs(b, mesh)
        local.append({k: local_slice(v, bs[k], mesh, rank)
                      for k, v in b.items()})
    pspecs = flatten(specs.params)
    whole = [k for k, sp in pspecs.items()
             if not any(mesh.shape[a] > 1 for a in spec_axes(sp))]
    torch.cuda.reset_peak_memory_stats()
    out["f_steps"] = []
    for i in range(DIST_TP["steps"]):
        reset_all_launches()
        D.TRAFFIC.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:       # train_step's own path, its gradient kept
            with router_probs() as seen:
                loss, met, grads = TT.loss_and_grads(
                    cfg, tc, state.params, local[0], mesh=mesh)
            params, opt, gnorm = adamw_update(
                tc.optimizer, grads, state.opt, state.params, mesh=mesh,
                specs=specs)
            state = TT.TrainState(params, opt)
            met = dict(met, loss=loss, grad_norm=gnorm)
        else:
            state, met = TT.train_step(cfg, tc, state, local[i], mesh=mesh,
                                       specs=specs)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["f_steps"].append({
            "wall": wall, "loss": loss, "gnorm": float(met["grad_norm"]),
            "aux": float(met["aux"]), "launches": lm_launches(),
            "traffic": dict(vars(D.TRAFFIC)),
            "whole_digest": _tree_digest(
                [flatten(state.params)[k] for k in whole])})
        if i == 0:
            # the gradient blocks against the one-device gradient's
            from repro_torch.models.moe import dispatch_codes

            # (max |diff|, max |want|, layer) of each leaf, a stacked
            # leaf's layers apart
            leaves, per = {}, pattern_period(cfg)
            for name, g in flatten(grads).items():
                want = np.load(os.path.join(ref["dir"], name.replace(
                    "/", "__") + ".npy"), mmap_mode="c")
                w = local_slice(torch.from_numpy(want), pspecs[name], mesh,
                                rank).to(dev)
                if name.startswith("blocks/pos"):
                    j = int(name.split("/")[1][3:])
                    for i in range(g.shape[0]):
                        leaves[f"{name}[{i}]"] = (
                            float((g[i] - w[i]).abs().max()),
                            float(w[i].abs().max()), i * per + j)
                else:
                    leaves[name] = (float((g - w).abs().max()),
                                    float(w.abs().max()), None)
                del w, want
            out["f_leaves"] = leaves
            one = torch.from_numpy(np.load(os.path.join(ref["dir"],
                                                        "probs.npy")))
            # each MoE layer's dispatch against the one-device pass's:
            # tokens routed to other experts (flips), with their top-k gap
            # in the one-device probabilities; other drops with the same
            # experts (knock-ons); probabilities of the tokens routed alike
            out["f_routing"] = []
            for a, b in zip(one, seen[:cfg.n_layers]):
                a = a.to(dev)
                ca, cb = dispatch_codes(a, cfg), dispatch_codes(b, cfg)
                flip = ((ca > 0) != (cb > 0)).any(-1)
                alike = ~(ca != cb).any(-1)
                out["f_routing"].append({
                    "flips": int(flip.sum()),
                    "knock": int((~alike & ~flip).sum()),
                    "gap": float(topk_gap(a, cfg.top_k)[flip].max())
                    if bool(flip.any()) else 0.0,
                    "probs_diff": float((a - b)[alike].abs().max())
                    if bool(alike.any()) else 0.0})
            del grads, seen
    out["f_peak"] = torch.cuda.max_memory_allocated()
    out["f_share"] = torch.cuda.get_device_properties(0).total_memory \
        * 0.9 / world
    out["f_whole_leaves"] = len(whole)
    out["f_expected"] = expected_train_launches(cfg)


def phase_distributed(fig20: tuple, built, built_scipy: float,
                      card: str, counts: dict) -> None:
    """(d) The multi-device DGRO path over ``torch.distributed``: R = 4
    ranks spawned once, all on ``cuda:0`` (NCCL needs a card a rank), gloo
    over a ``FileStore`` in ``build/``, every CUDA tensor staged through
    pinned host buffers.  Each rank writes its numbers to a file and this
    process asserts on them; a rank that fails, or ranks that outlive 300
    s, are killed and fail the phase.  (d-a) ``diameters_sharded`` of
    fig20's 64 genomes at N = 4096, bitwise fig20's one-process scores;
    (d-b) ``apsp_rowshard`` of the build's overlay, bitwise the
    one-process ``apsp_rowshard`` on the card, its diameter within rtol
    1e-5 of scipy's, K1 12 times a rank; (d-c) ``parallel_ring_shmap``
    at M = R, bitwise ``parallel_ring_host``; (d-d) ``ring_allreduce`` of
    gemma3-1b's embedding-sized leaf from per-rank seeds, equal on every
    rank and within ``chunk_error_bound`` of the fp64 sum, and a
    1,000,003-element ring on the card bitwise the same ring over CPU
    tensors; (d-e) ``pod_compressed_train_step`` on gemma3-1b cut to 4
    layers, mesh (pod R, data 1, model 1) in the DGRO order of
    ``model_dcn_latency(R, n_pods=2)``, one 1024-token sequence a rank, 2
    steps: parameters equal on every rank after each, step 1's reduced
    gradient within the bound of the exact mean, losses and grad norms
    finite, K3 / K4 / K3b / K4b launches a rank-step as
    ``expected_train_launches``; (d-f) moonshot-v1-16b-a3b at full width
    cut to 2 layers, tensor and expert parallel over mesh (data 1, model
    4), a 2 x 1024 batch, remat, 2 steps: step 1's loss and grad norm
    within rel 1e-5 of the one-device port step at the same seed
    (``tp_reference``, computed here before the spawn), every MoE
    layer's routing against the one-device pass's up to the first flip
    (flips only at near ties, other drops only beside a flip, the router
    probabilities of the tokens routed alike within ``TP_PROBS``), every
    gradient leaf within 1e-4 x its max |want| but the MoE leaves of the
    layers from a flip on (``tp_checks``), the init's peak a rank beside
    its blocks and the largest leaf drawn whole, the leaves the specs leave
    whole bitwise equal on every rank after each step, K3 / K3b / K4 /
    K4b launches a rank-step as ``expected_train_launches``, and the peak
    a rank under its share of the card; (d-g) serving over mesh (data 1,
    model 4), each part held to the one-device port served on the card
    before the spawn (``serve_tp_reference``, ``serve_tp_checks``): (d-g1)
    gemma3-1b at full width and depth, batch 8 x 1000, max_len 1024, 16
    greedy decode steps (every KV cache split over slots: K6's partial form
    on every decode layer, merged across ranks), (d-g2) zamba2-7b at full
    width cut to 6 layers, batch 4 x 512 and 8 decode steps, and a train
    step at 2 x 512 with remat, (d-g3) falcon-mamba-7b at full width cut
    to 4 layers, the same serving and a train step at 2 x 1024 (K5 / K5b on
    2,048 channels a rank).  The ranks share one card: the phase measures
    the transport and proves the protocol; it is no speed-up."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.core import batcheval
    from repro_torch.core.parallel import parallel_ring_host
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import ops as minplus_ops
    from repro_torch.launch.mesh import dgro_host_order, model_dcn_latency

    r = DIST["ranks"]
    work = os.path.join(ROOT, "build", "dist_smoke")
    os.makedirs(work, exist_ok=True)
    _, genomes, diam_one = fig20
    adj = built.adjacency
    spec = dict(DIST, genomes=os.path.join(work, "genomes.npy"),
                adj=os.path.join(work, "adj.npy"))
    np.save(spec["genomes"], genomes)
    np.save(spec["adj"], adj)
    t0 = time.perf_counter()
    rows_one = batcheval.apsp_rowshard(adj, device="cuda")
    one_wall = time.perf_counter() - t0
    ring_host = parallel_ring_host(make_latency("fabric", DIST["n"], seed=0),
                                   r, seed=0)
    order, rep = dgro_host_order(model_dcn_latency(r, n_pods=2))
    spec["pod_order"] = [int(i) for i in order]
    spec["tp_ref"] = tp = tp_reference(os.path.join(work, "tp_ref"),
                                       torch.device("cuda"))
    log(f"  (d-f) one-device yardstick: {DIST_TP['arch']}, "
        f"{DIST_TP['layers']} layers, {tp['n_params']} parameters, batch "
        f"{DIST_TP['batch']} x {DIST_TP['seq']}: step-1 loss "
        f"{tp['loss']:.7f} (aux {tp['aux']:.7f}), grad norm "
        f"{tp['gnorm']:.7f}; {tp['wall']:.3f} s with the init, "
        f"{tp['saved_s']:.1f} s to write the gradient [{card}]")
    t0 = time.perf_counter()
    spec["serve_ref"] = serve_ref = serve_tp_reference(
        os.path.join(work, "serve_ref"), torch.device("cuda"))
    log(f"  (d-g) one-device yardsticks (gemma3-1b, zamba2-7b, "
        f"falcon-mamba-7b served; the SSM parts' train steps): "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    torch.cuda.empty_cache()
    log(f"  pod ring order {spec['pod_order']} ({rep['selected']}, diameter "
        f"{rep['diameter']:.3f} vs random {rep['random_diameter']:.3f}); "
        f"spawning {r} ranks on cuda:0 (gloo, FileStore) "
        f"[{card}]")
    torch.cuda.empty_cache()
    t0, spawned = time.perf_counter(), time.time()
    try:
        res = D.spawn_ranks(dist_rank, r, args=(spec,),
                            timeout=DIST["timeout"], workdir=work)
    finally:       # the yardstick's 7.4 GB gradient, the logits
        shutil.rmtree(tp["dir"], ignore_errors=True)
    done = time.time()
    parts = []
    for i, (what, at) in enumerate(res[0]["marks"]):
        before = spawned if i == 0 else res[0]["marks"][i - 1][1]
        parts.append(f"{'start-up' if i == 0 else what} {at - before:.1f}")
    log(f"  (d) {r} ranks done in {time.perf_counter() - t0:.1f} s; rank "
        f"0's wall by part, s: {', '.join(parts)}, exit "
        f"{done - res[0]['marks'][-1][1]:.1f}")
    fails = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            fails.append(what)

    def walls(key):
        return max(o[key]["wall"] for o in res)

    def traffic(key, what):
        return sum(o[key]["traffic"][what] for o in res)

    # (d-a): the tiled method's ceil(N / T) diagonal steps of one K2 and
    # two K1 for each of a rank's B / R genomes
    k1 = [o["a"]["launches"]["minplus_acc"] for o in res]
    k2 = [o["a"]["launches"]["fw_tile"] for o in res]
    per = len(genomes) // r
    steps = -(-DIST["n"] // minplus_ops.default_tile(DIST["n"]))
    methods = {o["a_report"]["method"] for o in res}
    same = all(np.array_equal(o["a_diam"], diam_one) for o in res)
    log(f"  (d-a) diameters_sharded B={len(genomes)} N={DIST['n']} over {r} "
        f"ranks: bitwise fig20's one-process scores {same}; {walls('a'):.3f}"
        f" s wall (slowest rank); staged {traffic('a', 'bytes_staged')} B "
        f"through the host in all; method {methods}, K2 / K1 launches a "
        f"rank {k2} / {k1} (expected {per * steps} / {2 * per * steps}) "
        f"[{card}]")
    check(same, "(d-a) sharded scores differ from the one-process scores")
    check(methods == {"tiled"}, f"(d-a) method {methods}, not tiled")
    check(k2 == [per * steps] * r and k1 == [2 * per * steps] * r,
          f"(d-a) K2 / K1 launches {k2} / {k1}, not {per * steps} / "
          f"{2 * per * steps} a rank")
    # (d-b)
    k1 = [o["b"]["launches"]["minplus_acc"] for o in res]
    same = all(o["b_digest"] == _digest(rows_one) for o in res)
    d = res[0]["b_diam"]
    log(f"  (d-b) apsp_rowshard N={DIST['n']} over {r} ranks: bitwise the "
        f"one-process apsp_rowshard ({one_wall:.3f} s) {same}; diameter "
        f"{d!r} vs scipy {built_scipy!r}; K1 launches a rank {k1}; "
        f"{walls('b'):.3f} s wall; gathered "
        f"{traffic('b', 'bytes_received')} B, staged "
        f"{traffic('b', 'bytes_staged')} B in all [{card}]")
    check(same, "(d-b) row-sharded APSP differs from one process")
    check(np.isclose(d, built_scipy, rtol=1e-5, atol=0.0),
          "(d-b) diameter beyond rtol 1e-5 of scipy")
    check(k1 == [12] * r, f"(d-b) K1 launches {k1}, not 12 a rank")
    # (d-c)
    same = all(np.array_equal(o["c_ring"], ring_host) for o in res)
    log(f"  (d-c) parallel_ring_shmap N={DIST['n']} M={r}: bitwise "
        f"parallel_ring_host {same}; {walls('c'):.3f} s wall [{card}]")
    check(same, "(d-c) the partitioned ring differs from the host's")
    # (d-d)
    o0 = res[0]
    nbytes = int(np.prod(DIST["emb"])) * 4
    wall = walls("d")
    log(f"  (d-d) ring_allreduce of {DIST['emb']} fp32 ({nbytes} B a rank) "
        f"over {r} ranks: equal on every rank "
        f"{len({o['d_digest'] for o in res}) == 1}; max |ring - fp64 sum| "
        f"{o0['d_err']:.4g}, worst |diff| / bound "
        f"{o0['d_worst']:.3f}; {wall:.3f} s (slowest rank), "
        f"{o0['d']['traffic']['seconds']:.3f} s of it in rank 0's "
        f"{o0['d']['traffic']['hops']} hops; "
        f"{traffic('d', 'bytes_received')} B received, "
        f"{traffic('d', 'bytes_staged')} B staged in all: "
        f"{traffic('d', 'bytes_staged') / wall / 1e9:.3f} GB/s through the "
        f"host, {r * nbytes / wall / 1e9:.3f} GB/s of fp32 input reduced "
        f"[{card}]")
    check(len({o["d_digest"] for o in res}) == 1, "(d-d) ranks differ")
    check(o0["d_within"], "(d-d) beyond the quantization bound")
    log(f"  (d-d) a {DIST['small']}-element ring on the card bitwise the "
        f"same ring over CPU tensors: "
        f"{all(o['d_small_equal'] for o in res)}; {walls('d_small'):.3f} s")
    check(all(o["d_small_equal"] for o in res),
          "(d-d) the card's ring differs from the CPU's")
    # (d-e)
    want = o0["e_expected"]
    log(f"  (d-e) gemma3-1b, {DIST['layers']} of 26 layers, "
        f"{o0['e_params']} parameters a rank, mesh (pod {r}, data 1, model "
        f"1), one {DIST['seq']}-token sequence a rank; step 1's reduced "
        f"gradient vs the exact fp32 mean: within the bound "
        f"{o0['e_grad']['d_within']}, worst |diff| / bound "
        f"{o0['e_grad']['d_worst']:.3f}, max |diff| "
        f"{o0['e_grad']['d_err']:.4g}")
    check(o0["e_grad"]["d_within"], "(d-e) reduced gradient beyond the "
          "bound")
    for i in range(DIST["steps"]):
        recs = [o["e_steps"][i] for o in res]
        launches = [{k: v for k, v in rec["launches"].items()
                     if k in want} for rec in recs]
        same = len({rec["digest"] for rec in recs}) == 1
        log(f"  (d-e) step {i}: loss {recs[0]['loss']:.6f} gnorm "
            f"{recs[0]['gnorm']:.4f}; {max(rec['wall'] for rec in recs):.3f}"
            f" s (slowest rank), {recs[0]['traffic']['seconds']:.3f} s of "
            f"it in rank 0's collectives ({recs[0]['traffic']['hops']} "
            f"hops); {recs[0]['traffic']['bytes_staged']} B staged a rank; "
            f"parameters equal on every rank {same}")
        check(same, f"(d-e) step {i}: ranks' parameters differ")
        check(all(np.isfinite([rec["loss"], rec["gnorm"]]).all()
                  for rec in recs),
              f"(d-e) step {i}: loss or grad norm not finite")
        check(all(l == want for l in launches),
              f"(d-e) step {i}: launches {launches[0]} != {want}")
    log(f"  (d-e) launches a rank-step {launches[0]} (expected {want}); "
        f"peak memory a rank {[o['e_peak'] for o in res]} B [{card}]")
    tp_checks(res, tp, card, counts, check)
    serve_tp_checks(res, serve_ref, card, counts, check)
    shutil.rmtree(os.path.join(work, "serve_ref"), ignore_errors=True)
    if fails:
        raise AssertionError("; ".join(fails))


TP_TIE = 1e-6        # a flip's top-k gap over the row's max probability
TP_PROBS = 1e-5      # router probabilities of tokens routed alike


def tp_checks(res: list, tp: dict, card: str, counts: dict, check) -> None:
    """(d-f)'s gates over the ranks' numbers (``tp_rank``) and the
    one-device yardstick's (``tp_reference``).  Routing, layer by layer up
    to the first layer with a flip (a later layer's input carries the
    flip's difference): every flip a near tie (gap <= ``TP_TIE``), drops
    that differ only beside a flip, the probabilities of the tokens routed
    alike within ``TP_PROBS``.  Every gradient leaf within 1e-4 x its
    max |want|, but the MoE leaves (router, experts) of the layers from
    the first flip on, whose tokens differ by the flipped ones."""
    o0 = res[0]
    want = o0["f_expected"]
    routing = [[o["f_routing"][l] for o in res]
               for l in range(len(o0["f_routing"]))]
    flips = [max(r["flips"] for r in rs) for rs in routing]
    first = next((l for l, n in enumerate(flips) if n), None)
    rec0 = [o["f_steps"][0] for o in res]
    loss_ok = all(abs(r["loss"] - tp["loss"]) <= 1e-5 * abs(tp["loss"])
                  for r in rec0)
    gnorm_ok = all(abs(r["gnorm"] - tp["gnorm"]) <= 1e-5 * tp["gnorm"]
                   for r in rec0)
    skipped = sorted(n for n, (_, _, l) in o0["f_leaves"].items()
                     if first is not None and l is not None and l >= first
                     and "/moe/" in n)
    worst = max((max(o["f_leaves"][n][0] for o in res)
                 / max(max(o["f_leaves"][n][1] for o in res), 1e-30), n)
                for n in o0["f_leaves"] if n not in skipped)
    setup = max(o["f_setup"] for o in res)
    log(f"  (d-f) {DIST_TP['arch']} at full width, {DIST_TP['layers']} "
        f"layers, mesh (data 1, model 4): setup {setup:.1f} s a rank, the "
        f"init's peak {max(o['f_init_peak'] for o in res)} B a rank beside "
        f"{o0['f_state_bytes']} B of blocks and moments and a largest "
        f"leaf of {o0['f_whole_leaf']} B drawn whole; step 1 loss "
        f"{rec0[0]['loss']:.7f} vs one device {tp['loss']:.7f}, grad norm "
        f"{rec0[0]['gnorm']:.7f} vs {tp['gnorm']:.7f}; worst gradient leaf "
        f"max |dg| / max |g| {worst[0]:.3g} ({worst[1]}) [{card}]")
    for l, rs in enumerate(routing):
        log(f"  (d-f) layer {l} routing vs one device: {flips[l]} tokens "
            f"routed to other experts (largest top-k gap "
            f"{max(r['gap'] for r in rs):.3g} of the max probability), "
            f"{max(r['knock'] for r in rs)} other drops beside them, "
            f"probabilities of the tokens routed alike max |diff| "
            f"{max(r['probs_diff'] for r in rs):.3g}"
            + ("" if first is None or l <= first else
               " (after a flip: not gated)"))
        if first is not None and l > first:
            continue
        check(max(r["gap"] for r in rs) <= TP_TIE,
              f"(d-f) layer {l}: a token routed to other experts beyond "
              f"the near-tie gap {TP_TIE}")
        check(flips[l] or not max(r["knock"] for r in rs),
              f"(d-f) layer {l}: other drops with no routing flip")
        check(max(r["probs_diff"] for r in rs) <= TP_PROBS,
              f"(d-f) layer {l}: router probabilities beyond {TP_PROBS}")
    if skipped:
        log(f"  (d-f) leaves left out of the worst-leaf check (MoE leaves "
            f"from layer {first} on, where a flip changed their tokens): "
            f"{skipped}")
    check(loss_ok, "(d-f) step-1 loss beyond rel 1e-5 of one device")
    check(gnorm_ok, "(d-f) step-1 grad norm beyond rel 1e-5 of one device")
    check(worst[0] <= 1e-4, f"(d-f) gradient leaf {worst[1]} beyond "
          f"1e-4 x max |g|")
    for i in range(DIST_TP["steps"]):
        recs = [o["f_steps"][i] for o in res]
        launches = [{k: v for k, v in rec["launches"].items() if k in want}
                    for rec in recs]
        same = len({rec["whole_digest"] for rec in recs}) == 1
        staged = [rec["traffic"]["bytes_staged"] for rec in recs]
        log(f"  (d-f) step {i}: loss {recs[0]['loss']:.6f} gnorm "
            f"{recs[0]['gnorm']:.4f}; {max(rec['wall'] for rec in recs):.3f}"
            f" s (slowest rank), {recs[0]['traffic']['seconds']:.3f} s of it"
            f" in rank 0's collectives; {staged[0]} B staged a rank-step "
            f"(ranks {min(staged)}..{max(staged)}); the "
            f"{o0['f_whole_leaves']} whole leaves equal on every rank "
            f"{same}; launches a rank {launches[0]} [{card}]")
        check(same, f"(d-f) step {i}: whole leaves differ across ranks")
        check(all(np.isfinite([rec["loss"], rec["gnorm"]]).all()
                  for rec in recs), f"(d-f) step {i}: not finite")
        check(all(l == want for l in launches),
              f"(d-f) step {i}: launches {launches[0]} != {want}")
    counts["moe_tp"] = res[0]["f_steps"][0]["launches"]
    peaks = [o["f_peak"] for o in res]
    log(f"  (d-f) launches a rank-step {launches[0]} (expected {want}); peak"
        f" a rank {peaks} B, share {o0['f_share']:.0f} B [{card}]")
    check(max(peaks) < o0["f_share"], "(d-f) a rank's peak over its share")


def serve_tp_setup(part: dict, dev):
    """(d-g)'s config, prompts and (for an SSM part) train config and
    global batch, on ``dev``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import upload
    from repro_torch.train import train_step as TT

    cfg = get_arch(part["arch"])
    if part["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=part["layers"])
    prompts = np.random.default_rng(len(part["tag"]) + part["batch"]) \
        .integers(1, cfg.vocab, (part["batch"], part["prompt_len"]))
    tc = batch = None
    if "train" in part:
        b, t = part["train"]
        tc = TT.TrainConfig(remat=True)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t,
                                      global_batch=b, mean_doc_len=t / 2))
        batch = {k: upload(v, dev) for k, v in data.batch(0).items()}
    return cfg, prompts, tc, batch


def _serve_loop(cfg, params, prompts, part: dict, dev, **mesh_kw):
    """Prefill and ``part["steps"]`` greedy decode steps (``launch.serve.
    greedy``): (logits of every step as returned, tokens (B, steps + 1),
    prefill wall, each decode step's wall and bytes staged)."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.launch.serve import greedy
    from repro_torch.models import model as Mdl

    mesh = mesh_kw.get("mesh")
    tp, _ = Mdl.mesh_groups(mesh)
    rank = None if mesh is None else D.rank()
    caches = Mdl.init_caches(cfg, part["batch"], part["max_len"], device=dev,
                             mesh=mesh, rank=rank)
    kw = {} if mesh is None else dict(mesh=mesh, max_len=part["max_len"])
    toks = torch.as_tensor(prompts, device=dev).long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches, _ = Mdl.forward(cfg, params, toks, mode="prefill",
                                    caches=caches, **kw)
    out = [greedy(cfg, params, logits, tp)]
    torch.cuda.synchronize()
    prefill = time.perf_counter() - t0
    seen, steps = [logits], []
    for i in range(part["steps"]):
        staged = D.TRAFFIC.bytes_staged
        t0 = time.perf_counter()
        logits, caches = Mdl.forward(cfg, params, out[-1][:, None],
                                     mode="decode", caches=caches,
                                     pos=part["prompt_len"] + i, **kw)
        out.append(greedy(cfg, params, logits, tp))
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0,
                      D.TRAFFIC.bytes_staged - staged))
        seen.append(logits)
    return seen, torch.stack(out, 1), prefill, steps


def serve_tp_reference(work: str, dev) -> dict:
    """(d-g)'s yardstick, in the parent before the ranks start: each part
    served on one card by the one-device port (its logits of every step
    to ``work``, with their greedy tokens, each row's max |logit| and its
    top-2 gap), and an SSM part's one-device train step (loss, grad norm)
    at the same seed; the card's memory is given back."""
    import torch

    from repro_torch.models.model import init_params
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import global_norm

    os.makedirs(work, exist_ok=True)
    ref = {}
    for part in DIST_SERVE["parts"]:
        cfg, prompts, tc, batch = serve_tp_setup(part, dev)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        seen, toks, prefill, steps = _serve_loop(cfg, params, prompts, part,
                                                 dev)
        lg = torch.stack(seen)                       # (steps + 1, B, V)
        top2 = lg.topk(2, dim=-1).values
        path = os.path.join(work, f"{part['tag']}_logits.npy")
        np.save(path, lg.cpu().numpy())
        rec = {"logits": path, "tokens": toks.cpu().numpy(),
               "gap": (top2[..., 0] - top2[..., 1]).cpu().numpy(),
               "max_logit": lg.abs().amax(-1).cpu().numpy(),
               "prefill_s": prefill, "step_s": [w for w, _ in steps]}
        del seen, lg, top2
        if tc is not None:
            loss, met, grads = TT.loss_and_grads(cfg, tc, params, batch)
            rec["loss"], rec["gnorm"] = float(loss), float(global_norm(grads))
            del grads
        ref[part["tag"]] = rec
        del params
        torch.cuda.empty_cache()
    return ref


def serve_tp_rank(rank: int, world: int, part: dict, spec: dict, out: dict,
                  dev) -> None:
    """One (d-g) part on this rank over mesh (data 1, model 4), from the
    seed of ``serve_tp_reference``: the rank's blocks of the parameters
    (``init_sharded_params``) and of the caches (``init_caches(mesh=)``),
    prefill and greedy decode with the launches and the transport's
    counters reset just before; rank 0 gathers each step's logits and holds
    them, row by row up to a row's first token that differs, to the
    one-device logits.  An SSM part then takes one train step (remat) from
    ``init_sharded_state``: loss, grad norm, launches and the whole leaves'
    digest."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shardings import (gather_leaf, local_batch,
                                              param_specs, spec_axes)
    from repro_torch.models import model as Mdl
    from repro_torch.models.convert import flatten
    from repro_torch.models.sharding import P
    from repro_torch.train import train_step as TT

    tag = part["tag"]
    ref = spec["serve_ref"][tag]
    cfg, prompts, tc, batch = serve_tp_setup(part, dev)
    mesh = Mesh(np.arange(world).reshape(DIST_SERVE["mesh"]),
                ("data", "model"))
    tp, _ = Mdl.mesh_groups(mesh)
    t0 = time.perf_counter()
    params = TT.init_sharded_params(
        cfg, param_specs(Mdl.init_params(cfg, device="meta"), mesh), mesh,
        rank, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    rec = {"setup": time.perf_counter() - t0}
    reset_all_launches()
    D.TRAFFIC.reset()
    seen, toks, prefill, steps = _serve_loop(cfg, params, prompts, part, dev,
                                             mesh=mesh)
    rec.update(launches=lm_launches(), prefill_s=prefill, steps=steps,
               traffic=dict(vars(D.TRAFFIC)), tokens=toks.cpu().numpy())
    cols = "model" if Mdl.head_range(cfg, params, tp) is not None else None
    whole = [gather_leaf(lg, P(None, cols), mesh) for lg in seen]
    if rank == 0:
        # rows held up to (and with) the step whose input first differs
        want_toks = torch.from_numpy(ref["tokens"]).to(dev)
        same_in = torch.cumprod((toks == want_toks).long(), dim=1).bool()
        lg_ref = np.load(ref["logits"], mmap_mode="r")
        worst = []
        for i, lg in enumerate(whole):
            rows = torch.ones(toks.shape[0], dtype=torch.bool, device=dev) \
                if i == 0 else same_in[:, i - 1]
            want = torch.from_numpy(np.array(lg_ref[i])).to(dev)
            diff = (lg - want).abs().amax(-1) / want.abs().amax(-1)
            worst.append(float(diff[rows].max()) if bool(rows.any())
                         else 0.0)
        rec["logit_rel"] = worst
        del lg_ref
    del seen, whole
    if tc is not None:
        del params
        torch.cuda.empty_cache()
        specs = TT.state_layout(cfg, mesh)
        state = TT.init_sharded_state(
            cfg, specs, mesh, rank, torch.Generator(device=dev).manual_seed(0),
            device=dev)
        mine = local_batch(batch, mesh, rank)
        reset_all_launches()
        D.TRAFFIC.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = TT.train_step(cfg, tc, state, mine, mesh=mesh,
                                   specs=specs)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        pspecs = flatten(specs.params)
        kept = [k for k, sp in pspecs.items()
                if not any(mesh.shape[a] > 1 for a in spec_axes(sp))]
        rec["train"] = {
            "wall": time.perf_counter() - t0, "loss": loss,
            "gnorm": float(met["grad_norm"]), "launches": lm_launches(),
            "traffic": dict(vars(D.TRAFFIC)),
            "whole_digest": _tree_digest([flatten(state.params)[k]
                                          for k in kept]),
            "whole_leaves": len(kept)}
        del state, met
    rec["peak"] = torch.cuda.max_memory_allocated()
    out[f"serve_{tag}"] = rec


def serve_tp_checks(res: list, ref: dict, card: str, counts: dict,
                    check) -> None:
    """(d-g)'s gates over the ranks' numbers and the one-device yardstick:
    every rank's greedy tokens equal the one device's up to a row's first
    difference, which must come at a near tie (top-2 gap under ``tie`` x
    max |logit|); the logits of the rows so far within ``logit_tol`` x max
    |logit|; every kernel's launches a rank those of the one-device serve
    (``expected_lm_launches``: K3 on every norm, the gate norms' split form
    included; K4 once an attention layer in prefill; K5 once a Mamba1
    layer a forward; K6 once an attention layer a decode step, in its
    partial form for gemma3-1b's slot-split caches); an SSM part's train
    step's loss and grad norm within rel 1e-5 of the one device's, its
    whole leaves equal on every rank, every launch (K3 / K3b with the
    others) as ``expected_train_launches``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.model import layer_kind, pattern_period

    tie, tol = DIST_SERVE["tie"], DIST_SERVE["logit_tol"]
    for part in DIST_SERVE["parts"]:
        tag, steps = part["tag"], part["steps"]
        recs = [o[f"serve_{tag}"] for o in res]
        r0, want = recs[0], ref[tag]
        cfg = get_arch(part["arch"])
        if part["layers"]:
            cfg = dataclasses.replace(cfg, n_layers=part["layers"])
        per = pattern_period(cfg)
        kinds = [layer_kind(cfg, i % per) for i in range(cfg.n_layers)]
        ssm = cfg.family in ("ssm", "hybrid")
        attn = sum(k["shared_attn"] for k in kinds) if ssm else cfg.n_layers
        mamba1 = sum(k["type"] == "mamba1" for k in kinds) if ssm else 0
        # tokens: equal on every rank, and to the one device's up to a
        # row's first difference, at a near tie
        same_ranks = all(np.array_equal(r["tokens"], r0["tokens"])
                         for r in recs)
        diff = r0["tokens"] != want["tokens"]
        flips = []
        for b in range(diff.shape[0]):
            if diff[b].any():
                i = int(np.argmax(diff[b]))
                flips.append((b, i, float(want["gap"][i, b]
                                          / want["max_logit"][i, b])))
        ties_ok = all(g < tie for _, _, g in flips)
        la = r0["launches"]
        k6 = la["decode_attention_partial"] + la["decode_attention"]
        walls = [w for w, _ in r0["steps"]]
        staged = [[b for _, b in r["steps"]] for r in recs]
        log(f"  (d-{tag}) {cfg.name}, {cfg.n_layers} layers at full width, "
            f"mesh (data 1, model 4), batch {part['batch']} x "
            f"{part['prompt_len']}, {steps} greedy decode steps: parameters "
            f"a rank in {max(r['setup'] for r in recs):.1f} s; prefill "
            f"{max(r['prefill_s'] for r in recs):.4f} s (one device "
            f"{want['prefill_s']:.4f} s); decode step walls, s (rank 0) "
            f"{[round(w, 4) for w in walls]} (mean {np.mean(walls):.4f}; one "
            f"device {np.mean(want['step_s']):.4f}); bytes staged a "
            f"rank-step {staged[0]} (ranks "
            f"{min(min(x) for x in staged)}..{max(max(x) for x in staged)}), "
            f"prefill + decode {r0['traffic']['bytes_staged']} B, "
            f"{r0['traffic']['seconds']:.3f} s in rank 0's collectives "
            f"[{card}]")
        log(f"  (d-{tag}) tokens equal on every rank {same_ranks}; vs one "
            f"device: {len(flips)} rows part (row, step, top-2 gap / max "
            f"|logit|) {flips}; logits of the rows so far, max |diff| / max "
            f"|logit| by step {[f'{x:.2e}' for x in r0['logit_rel']]}; "
            f"launches a rank {la}; peak a rank "
            f"{max(r['peak'] for r in recs)} B [{card}]")
        check(same_ranks, f"(d-{tag}) ranks' tokens differ")
        check(ties_ok, f"(d-{tag}) a token differs from one device beyond "
              f"a near tie: {flips}")
        check(max(r0["logit_rel"]) <= tol, f"(d-{tag}) logits beyond {tol} "
              f"x max |logit| of one device")
        check(all(r["launches"] == la for r in recs),
              f"(d-{tag}) ranks' launches differ")
        # every kernel as the one-device serve launches it; gemma3-1b's
        # caches are split over slots, so its K6 runs in the partial form
        exp = expected_lm_launches(cfg, steps + 1)
        if tag == "g1":
            exp["decode_attention_partial"] = exp.pop("decode_attention")
            exp["decode_attention"] = 0
        check(la == exp and k6 == attn * steps
              and la["selective_scan"] == mamba1 * (steps + 1),
              f"(d-{tag}) launches {la} != {exp}")
        if tag == "g1":
            counts["serve_tp"] = la
        if "train" not in part:
            continue
        trs = [r["train"] for r in recs]
        exp = expected_train_launches(cfg)
        got = trs[0]["launches"]
        same = len({t["whole_digest"] for t in trs}) == 1
        log(f"  (d-{tag}) train step, batch {part['train'][0]} x "
            f"{part['train'][1]}, remat: loss {trs[0]['loss']:.7f} vs one "
            f"device {want['loss']:.7f}, grad norm {trs[0]['gnorm']:.7f} vs "
            f"{want['gnorm']:.7f}; {max(t['wall'] for t in trs):.3f} s "
            f"(slowest rank), {trs[0]['traffic']['seconds']:.3f} s in rank "
            f"0's collectives, {trs[0]['traffic']['bytes_staged']} B staged "
            f"a rank; the {trs[0]['whole_leaves']} whole leaves equal on "
            f"every rank {same}; launches a rank {trs[0]['launches']} "
            f"(expected {exp}) [{card}]")
        check(all(abs(t["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
                  for t in trs), f"(d-{tag}) loss beyond rel 1e-5")
        check(all(abs(t["gnorm"] - want["gnorm"]) <= 1e-5 * want["gnorm"]
                  for t in trs), f"(d-{tag}) grad norm beyond rel 1e-5")
        check(same, f"(d-{tag}) whole leaves differ across ranks")
        check(got == exp, f"(d-{tag}) train launches {got} != {exp}")
        counts[f"{cfg.name}_tp_train"] = trs[0]["launches"]


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
    n_ops = sum(r[1] for r in rows)
    if not rows:
        log(f"  {label}: {wall:.3f} s wall; the profiler saw no device "
            f"time (busy share not measured)")
        return
    log(f"  {label}: {wall:.3f} s wall, {dev_s:.4f} s device time in "
        f"{n_ops} device ops (kernels and copies), busy share "
        f"{dev_s / wall:.4f}")
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
    profiled("build('parallel') M=32 nearest, scored stitch, N=4096",
             lambda: overlay.build("parallel", w,
                                   overlay.ParallelConfig(m=32), seed=0))
    profile_dqn()


def profile_dqn() -> None:
    """The deep-Q path at N=200 under the profiler: the 10-start greedy
    rollout cut to K = 2 rings (400 steps) and a training epoch to K = 1
    (200 steps), the same per-step work as the build's 1,600, to keep the
    traces small: the profiler's own cost grows with its events (~190,000
    for an epoch of 400 steps)."""
    import torch

    from repro_torch.core import qlearning, rollout
    from repro_torch.core.embedding import init_qparams
    from repro_torch.core.topology import make_latency
    from repro_torch.train.optimizer import adamw_init

    n, k = DQN["n"], 2
    w = make_latency(DQN["dist"], n, seed=0)
    cfg = qlearning.DQNConfig(n=n, k_rings=k)
    params = init_qparams(torch.Generator().manual_seed(0), cfg.p, cfg.h)
    profiled(f"dgro-dqn {DQN['n_starts']}-start rollout N={n} K={k}",
             lambda: qlearning.dgro_overlay(params, cfg, w,
                                            n_starts=DQN["n_starts"]))
    slots = rollout.graph_slots(cfg.buffer_capacity, 1, 1, n)
    buf = rollout.init_buffer(cfg.buffer_capacity, n, slots)
    plan = rollout.make_plan(np.random.default_rng(0), 1, 1, n, 1,
                             cfg.batch_size)
    profiled(f"dgro-dqn train_epoch N={n} K=1 ({n} steps)",
             lambda: rollout.train_epoch(
                 params, adamw_init(params.tensors()), buf,
                 torch.as_tensor(w[None], device="cuda"), [0], plan.starts,
                 plan.eps_u, plan.choice_u, plan.sample_u, 1.0, cfg.gamma,
                 cfg.lr, cfg.alpha, k_rings=1, batch_size=cfg.batch_size))


def phase_timing(rng, counts: dict, errs: dict) -> list:
    """Each kernel at the main path's shapes: ms per launch by CUDA events,
    its twin's ms, and the bound; the timed launches are held bitwise
    against the twin too.  Returns the kernels line's entries."""
    import torch

    from repro_torch.core.diameter import adjacency_from_rings
    from repro_torch.core.topology import make_latency
    from repro_torch.kernels.minplus import kernel, ops, ref

    dev = torch.device("cuda")
    launches = {name: sum(c.get(name, 0) for c in counts.values())
                for name in kernel.SOURCES}
    # the operands of one diagonal step of the tiled APSP at N=4096, T=256
    n, t = 4096, ops.default_tile(4096)
    w = make_latency("fabric", n, seed=0)
    d = torch.from_numpy(adjacency_from_rings(
        w, [rng.permutation(n) for _ in range(12)])).to(dev)
    diag = kernel.fw_tile(d[:t, :t])
    errs["fw_tile"] = max(errs["fw_tile"], check_equal(
        f"K2 diagonal tile T={t} of N={n}", diag, ref.fw_tile_ref(d[:t, :t])))
    rowp = kernel.minplus_acc(diag[None], d[None, :t, :], init=d[None, :t, :])
    colp = rowp.transpose(1, 2).contiguous()
    # adapt's squaring step at N=256 (B=4), and its unbatched (B2) twin
    sq = torch.from_numpy(np.stack([adjacency_from_rings(
        make_latency("bitnode", 256, seed=0),
        [rng.permutation(256) for _ in range(8)]) for _ in range(4)])).to(dev)
    one = sq[:1]
    work = d[None].clone()      # the outer update runs in place on a copy
    # K1 at every shape the paths give it: (label, a, b, init, in place)
    k1_shapes = [
        (f"outer update (1,{n},{t})x(1,{t},{n}) in place", colp, rowp,
         d[None], True),
        (f"row panel (1,{t},{t})x(1,{t},{n}) +init", diag[None],
         d[None, :t, :], d[None, :t, :], False),
        ("squaring step (4,256,256)^2", sq, sq, None, False),
        ("unbatched squaring step (1,256,256)^2", one, one, None, False),
    ]
    k1 = {}
    for label, a, b, init, in_place in k1_shapes:
        bsz, m, kk = a.shape
        nn = b.shape[2]
        want = ref.minplus_acc_ref(a, b, init)
        plain = time_ms(lambda: ref.minplus_acc_ref(a, b, init),
                        reps=2 if m * nn > 1 << 20 else 5, warmup=1)
        chosen = kernel.variant(bsz, m, kk, nn)
        by_variant = {}
        for choice in kernel.MINPLUS_VARIANTS:
            if in_place:
                out = work
                work.copy_(init)
                kernel.minplus_acc(a, b, init=work, out=work, choice=choice)
                run = (lambda c=choice: kernel.minplus_acc(
                    a, b, init=work, out=work, choice=c))
            else:
                out = kernel.minplus_acc(a, b, init, choice=choice)
                run = (lambda c=choice, o=out: kernel.minplus_acc(
                    a, b, init, out=o, choice=c))
            errs["minplus_acc"] = max(errs["minplus_acc"], check_equal(
                f"K1 {label}, tile {choice[0]}, {choice[1]} k chunks", out,
                want))
            by_variant[f"{choice[0]}x{choice[1]}"] = time_ms(run, reps=20)
        nbytes = a.element_size() * (a.numel() + b.numel()
                                     + (2 if init is not None else 1)
                                     * bsz * m * nn)
        b_ms, b_by = bound(float(bsz) * m * kk * nn, nbytes)
        ms = by_variant[f"{chosen[0]}x{chosen[1]}"]
        k1[label] = {"variant": list(chosen), "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "variants": by_variant}
        log(f"  K1 {label}: variant {chosen} {ms:.4f} ms (64x64 unsplit "
            f"{by_variant['64x1']:.4f} ms; twin {plain:.3f} ms; bound "
            f"{b_ms:.5f} ms by {b_by}); every variant: " + ", ".join(
                f"{v} {x:.4f}" for v, x in by_variant.items()))
    outer = k1[k1_shapes[0][0]]
    entries = [{
        "name": "minplus_acc", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus_acc.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:97",
        "also_replaces": ["src/repro/kernels/minplus/kernel.py:249",
                          "src/repro/kernels/minplus/kernel.py:188"],
        "shape": f"outer update (1,{n},{t})x(1,{t},{n}) fp32, in place",
        "launches": launches["minplus_acc"],
        "max_abs_err": errs["minplus_acc"], "ms": outer["ms"],
        "plain_ms": outer["plain_ms"], "bound_ms": outer["bound_ms"],
        "bound_by": outer["bound_by"], "library_ms": None,
        "variant": outer["variant"], "shapes": k1,
        "launches_are": "calls: a call with k chunks > 1 runs two kernels, "
                        "the chunks' product and their combine, timed "
                        "together"}]

    x = torch.from_numpy(tile_input(rng, t)).to(dev)
    k2_ms = time_ms(lambda: kernel.fw_tile(x), reps=20)
    k2_plain = time_ms(lambda: ref.fw_tile_ref(x), reps=2, warmup=1)
    want = ref.fw_tile_ref(x)
    errs["fw_tile"] = max(errs["fw_tile"], check_equal(
        f"K2 T={t} timed input", kernel.fw_tile(x), want))
    k2_b, k2_by = bound(float(t) ** 3, 4.0 * 2 * t * t)
    # every (cluster size C, pivots per barrier P) K2 is built for, timed
    # on the same tile (the path runs FW_TILE_CLUSTER x FW_TILE_PIVOTS),
    # each with its chain floor: T / P cluster barriers (their round trip,
    # measured) + T x 2 R T / 128 cycles of relaxation per CTA (R = 256 / C)
    barrier = {}
    for c in sorted({c for c, _ in kernel.FW_TILE_VARIANTS}):
        cycles, ns = kernel.cluster_barrier_cycles(c)
        barrier[c] = {
            "cycles": cycles, "ns": ns,
            "with_row_read_cycles": kernel.cluster_barrier_cycles(
                c, remote=True)[0]}
        log(f"  cluster of {c}: barrier {cycles:.1f} cycles ({ns:.1f} ns), "
            f"with K2's pivot-row read "
            f"{barrier[c]['with_row_read_cycles']:.1f} cycles")
    sweep = {}
    for c, p in kernel.FW_TILE_VARIANTS:
        v_ms = time_ms(lambda: kernel.fw_tile_variant(x, c, p), reps=20)
        errs["fw_tile"] = max(errs["fw_tile"], check_equal(
            f"K2 T={t} timed input, cluster of {c}, {p} pivots a barrier",
            kernel.fw_tile_variant(x, c, p), want))
        cycles, ns = barrier[c]["cycles"], barrier[c]["ns"]
        relax_cycles = 2.0 * (kernel.FW_TILE_MAX // c) * t / 128
        floor_ms = (t / p * cycles + t * relax_cycles) * (ns / cycles) / 1e6
        sweep[f"{c}x{p}"] = {"ms": v_ms, "chain_floor_ms": floor_ms}
        log(f"  K2 T={t} cluster of {c}, {p} pivots a barrier: {v_ms:.4f} "
            f"ms; chain floor {floor_ms:.4f} ms")
    chosen = sweep[f"{kernel.FW_TILE_CLUSTER}x{kernel.FW_TILE_PIVOTS}"]
    entries.append({
        "name": "fw_tile", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/fw_tile.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:188",
        "shape": f"diagonal tile ({t},{t}) fp32, cluster of "
                 f"{kernel.FW_TILE_CLUSTER}, {kernel.FW_TILE_PIVOTS} pivots "
                 f"a barrier",
        "launches": launches["fw_tile"], "max_abs_err": errs["fw_tile"],
        "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_b,
        "bound_by": k2_by, "library_ms": None,
        "chain_floor_ms": chosen["chain_floor_ms"],
        "variants": sweep,
        "cluster_barrier": {str(c): v for c, v in barrier.items()}})
    log(f"  K2 T={t}: {k2_ms:.4f} ms (twin {k2_plain:.2f} ms, bound "
        f"{k2_b:.5f} ms by {k2_by}, chain floor "
        f"{chosen['chain_floor_ms']:.4f} ms)")
    return entries


def check_close(what: str, got, want, tol: float, rel: bool = False) -> float:
    """Fail unless max |got - want| <= tol (times max(1, |want|) elementwise
    when ``rel``); returns max |diff|."""
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(g.shape)} {got.dtype} != "
                             f"{tuple(w.shape)} {want.dtype}")
    diff = (g - w).abs()
    err = float(diff.max())
    limit = tol * w.abs().clamp_min(1.0) if rel else tol
    if not bool(torch.isfinite(g).all()) or not bool((diff <= limit).all()):
        scaled = " x max(1, |want|)" if rel else ""
        raise AssertionError(f"{what}: kernel vs twin max |diff| {err} "
                             f"(tolerance {tol}{scaled})")
    log(f"  {what}: max |diff| {err:.3g}")
    return err


def bf16_ulp_close(what: str, got, want) -> float:
    """Fail unless every element is within one bf16 ulp of the twin's."""
    import torch

    torch.cuda.synchronize()
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
    diff = (got.float() - w).abs()
    err = float(diff.max())
    if got.shape != want.shape or not bool((diff <= ulp).all()):
        raise AssertionError(f"{what}: kernel vs twin max |diff| {err}, "
                             f"beyond one bf16 ulp")
    log(f"  {what}: max |diff| {err:.3g} (within one bf16 ulp)")
    return err


FLASH_CASES = [   # the JAX package's kernel test cases, then the served shapes
    dict(b=1, hq=2, hkv=2, tq=128, tk=128, d=128, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, tq=256, tk=256, d=64, causal=True, window=None),
    dict(b=1, hq=4, hkv=1, tq=200, tk=200, d=80, causal=True, window=96),
    dict(b=1, hq=2, hkv=2, tq=128, tk=384, d=128, causal=False, window=None),
    dict(b=1, hq=8, hkv=2, tq=64, tk=64, d=32, causal=True, window=32),
    dict(b=8, hq=4, hkv=1, tq=1024, tk=1024, d=256, causal=True, window=512),
    dict(b=8, hq=4, hkv=1, tq=1024, tk=1024, d=256, causal=True, window=None),
    dict(b=8, hq=16, hkv=16, tq=1024, tk=1024, d=128, causal=True,
         window=None),                                  # moonshot prefill
    dict(b=8, hq=32, hkv=32, tq=1024, tk=1024, d=112, causal=True,
         window=None),                                  # zamba2's shared block
    # the tensor-core instances' edges: Tq / Tk one past a query tile (128)
    # and one short of a KV tile (64), D = 100 and 127, a window ending
    # inside a KV tile, rows past the window's reach (fully masked)
    dict(b=2, hq=8, hkv=2, tq=129, tk=129, d=64, causal=True, window=None),
    dict(b=1, hq=4, hkv=4, tq=129, tk=63, d=112, causal=False, window=None),
    dict(b=2, hq=4, hkv=1, tq=300, tk=300, d=100, causal=True, window=90),
    dict(b=1, hq=2, hkv=2, tq=200, tk=40, d=127, causal=True, window=20),
    dict(b=8, hq=32, hkv=32, tq=1024, tk=1024, d=64, causal=True,
         window=None),                                  # musicgen
    dict(b=8, hq=32, hkv=8, tq=1280, tk=1280, d=128, causal=True,
         window=None),                                  # pixtral
]


def phase_lm_kernels(rng, errs: dict) -> None:
    """K4 and K3 against their plain versions on the card, fp32 and bf16.
    K4: fp32 within 2e-5, bf16 within 3e-2 (the JAX kernel tests' own
    tolerances: online against dense softmax), and K4's fp32 output at
    moonshot's and musicgen's layers leaning from float64 by at most 5e-6
    (its tensor-core accumulators).  K3: fp32 within 1e-6 x max(1, |want|)
    (1/sqrtf against torch's CUDA rsqrt, summed in another order), bf16
    within one bf16 ulp."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    dev = torch.device("cuda")

    def rand(shape, dt, sd=1.0):
        return torch.from_numpy(rng.normal(0, sd, shape).astype(np.float32)) \
            .to(dev, dt)

    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        name = str(dt)[6:]
        key = "flash_attention" + ("" if dt == torch.float32 else "_bf16")
        for c in FLASH_CASES:
            q = rand((c["b"], c["hq"], c["tq"], c["d"]), dt)
            k = rand((c["b"], c["hkv"], c["tk"], c["d"]), dt)
            v = rand((c["b"], c["hkv"], c["tk"], c["d"]), dt)
            tag = (f"K4 b{c['b']} hq{c['hq']} hkv{c['hkv']} tq{c['tq']} "
                   f"tk{c['tk']} d{c['d']} causal={c['causal']} "
                   f"window={c['window']} {name}")
            errs[key] = max(errs.get(key, 0.0), check_close(
                tag, fa_ops.flash_attention(q, k, v, causal=c["causal"],
                                            window=c["window"]),
                attention_ref(q, k, v, causal=c["causal"],
                              window=c["window"]), tol))
            del q, k, v
    # the tensor-core instances' fp32 accumulators must not drift toward
    # zero: the output's lean from float64 at moonshot's and musicgen's
    # layers, |sum(got exact) / sum(exact^2) - 1| <= 5e-6
    for tag, h, d in (("moonshot", 16, 128), ("musicgen", 32, 64)):
        q, k, v = (rand((8, h, 1024, d), torch.float32) for _ in range(3))
        got = fa_ops.flash_attention(q, k, v).double()
        exact = attention_ref(q.double(), k.double(), v.double())
        lean = float((got * exact).sum() / (exact * exact).sum() - 1.0)
        log(f"  K4 {tag} (8,{h},1024,{d}) fp32: lean from float64 "
            f"{lean:+.2e}")
        if abs(lean) > 5e-6:
            raise AssertionError(f"K4 {tag}: leans {lean:+.2e} from the "
                                 f"float64 output")
        del q, k, v, got, exact
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        key = "rmsnorm" + ("" if dt == torch.float32 else "_bf16")
        for rows, d, off in ((8 * 1024, 1152, 0), (8 * 1024 * 4, 256, 0),
                             (1, 1152, 0), (7, 1152, 0), (300, 256, 0),
                             (5, 8192, 0), (7, 1150, 0), (300, 256, 1),
                             (8 * 1024, 2048, 0), (8, 2048, 0),
                             (8 * 1024, 4096, 0), (8, 4096, 0),
                             (8 * 1024, 3584, 0), (8, 3584, 0),
                             (8 * 1024, 7168, 0), (8, 7168, 0),
                             (8, 5120, 0), (10 * 1024, 5120, 0),
                             (1, 2056, 0), (33, 2056, 0), (9, 5120, 1)):
            # off = 1: rows one element off a 16-byte boundary
            x = rand((rows * d + off,), dt, 2.0)[off:].view(rows, d)
            s = rand((d,), dt, 0.1)
            got, want = rn_ops.rmsnorm(x, s, 1e-6), rmsnorm_ref(x, s, 1e-6)
            tag = (f"K3 ({rows}, {d}){' offset 1' if off else ''} {name}, "
                   f"variant {rn_kernel.variant(x, s)[0]}")
            err = check_close(tag, got, want, 1e-6, rel=True) \
                if dt == torch.float32 else bf16_ulp_close(tag, got, want)
            errs[key] = max(errs.get(key, 0.0), err)
    rmsnorm_split_checks(rng, errs)
    decode_attention_checks(rng, errs)


def rmsnorm_split_checks(rng, errs: dict) -> None:
    """K3 / K3b's split form (a row split across ranks by columns,
    normalised by the ranks' summed sum of squares) against its plain
    version on the card at (d-g2)'s rank shapes, zamba2-7b's gate norm a
    rank (1792 of d_inner 7168: prefill 4 x 512, decode 4, training 2 x
    512 rows), fp32: the output within 1e-6 x max(1, |want|), dx / dscale
    / the statistic's gradient as K3b's default form is held
    (``grad_close``: 5e-5 x max(1, max |want|); dscale sums 2,048 rows in
    another order).  The blocks of 4 ranks normalised by their summed
    statistic are held to K3 over the whole row, within 1e-6."""
    import torch

    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

    dev = torch.device("cuda")

    def rand(*shape, sd=1.0):
        return torch.from_numpy(rng.normal(0, sd, shape).astype(
            np.float32)).to(dev)

    dd, whole = 1792, 7168
    for rows in (4 * 512, 4, 2 * 512):
        x, s, g = rand(rows, whole, sd=2.0), rand(whole, sd=0.1), \
            rand(rows, whole)
        parts = [slice(i * dd, (i + 1) * dd) for i in range(4)]
        ss = sum(x[:, p].square().sum(-1) for p in parts).contiguous()
        xs, ssl = x[:, parts[1]].contiguous(), s[parts[1]].contiguous()
        gs = g[:, parts[1]].contiguous()
        tag = f"K3 split form ({rows}, {dd}) of rows of {whole}"
        err = check_close(tag, rn.rmsnorm_rows(xs, ssl, 1e-6, ss, whole),
                          rmsnorm_ref(xs, ssl, 1e-6, ss, whole), 1e-6,
                          rel=True)
        merged = torch.cat([rn.rmsnorm_rows(x[:, p].contiguous(),
                                            s[p].contiguous(), 1e-6, ss,
                                            whole) for p in parts], dim=1)
        err = max(err, check_close(f"{tag}, 4 blocks vs K3 on the whole row",
                                   merged, rn.rmsnorm_rows(x, s, 1e-6), 1e-6,
                                   rel=True))
        errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), err)
        got = rn.rmsnorm_rows_bwd(xs, ssl, gs, 1e-6, ss, whole)
        want = rmsnorm_bwd_ref(xs, ssl, gs, 1e-6, ss, whole)
        errs["rmsnorm_bwd"] = max(errs.get("rmsnorm_bwd", 0.0), max(
            grad_close(f"K3b split form ({rows}, {dd}) {what}", a, b)
            for what, a, b in zip(("dx", "dscale", "dss"), got, want)))
        del x, s, g, xs, gs, merged, got, want


DECODE_CASES = [   # (B, Hq, Hkv, S, D, window, pos): ragged, then the paths'
    (1, 4, 4, 1, 16, None, 0),
    (3, 8, 4, 17, 40, None, 20),            # wrapped past S
    (2, 10, 2, 300, 128, None, 120),        # partly written, g = 5
    (2, 32, 16, 200, 128, 100, 250),        # gemma3-27b's g = 2, a window
    (8, 4, 1, 512, 256, 512, 1055),         # gemma3-1b local, rolled
    (8, 4, 1, 1056, 256, None, 1055),       # gemma3-1b global
    (8, 16, 16, 1056, 128, None, 1030),     # moonshot
    (8, 32, 32, 1056, 112, None, 1040),     # zamba2's shared block
    (8, 32, 32, 1312, 64, None, 1100),      # musicgen-large
    (8, 32, 8, 1312, 128, None, 1311),      # pixtral-12b
    (8, 32, 8, 8192, 128, None, 8191),      # pixtral-12b, a long cache
]


def decode_attention_checks(rng, errs: dict) -> None:
    """K6 against its plain twin on the card, for every cache dtype (fp32,
    bf16, float8_e4m3fn: the fp8 cache is q's K/V cast by
    ``layers.to_cache_dtype``) at ragged shapes and the paths' decode
    shapes: within 1e-5 x max |want| (fp32 online against dense softmax,
    summed in another order), and two calls bitwise (a fixed merge
    order, no atomics)."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import to_cache_dtype

    dev = torch.device("cuda")
    worst = {}
    for b, hq, hkv, s, d, window, pos in DECODE_CASES:
        q = torch.from_numpy(rng.normal(0, 1, (b, hq, 1, d))
                             .astype(np.float32)).to(dev)
        kv = torch.from_numpy(rng.normal(0, 2, (2, b, hkv, s, d))
                              .astype(np.float32)).to(dev)
        for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            k, v = (to_cache_dtype(t, dt) for t in kv)
            got = da.decode_attention(q, k, v, pos, window)
            again = da.decode_attention(q, k, v, pos, window)
            name = str(dt)[6:]
            tag = (f"K6 b{b} hq{hq} hkv{hkv} S{s} D{d} window={window} "
                   f"pos={pos} {name}")
            err = rel_close(tag, got, decode_attention_ref(q, k, v, pos,
                                                           window))
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: two calls differ")
            worst[name] = max(worst.get(name, 0.0), err)
        del q, kv, k, v
    errs["decode_attention"] = worst["float32"]
    errs["decode_attention_bf16"] = worst["bfloat16"]
    errs["decode_attention_fp8"] = worst["float8_e4m3fn"]
    decode_partial_checks(rng, errs)
    # torch's own CUDA cast past 464, beside the port's (recorded, not
    # gated: the port never writes a cache with it)
    x = torch.tensor([448.0, 464.0, 464.00003, 500.0, -500.0, 1e4],
                     device=dev)
    log(f"  fp8 cast on the card of {x.tolist()}: torch's .to() bytes "
        f"{x.to(torch.float8_e4m3fn).view(torch.uint8).tolist()}, the "
        f"port's to_cache_dtype (the reference's) "
        f"{to_cache_dtype(x, torch.float8_e4m3fn).view(torch.uint8).tolist()}")
    log(f"  K6: {len(DECODE_CASES)} shapes x 3 cache dtypes within 1e-5 x "
        f"max |want| of the plain twin, two calls bitwise; worst max |diff| "
        f"{worst}")


# K6's partial form at (d-g1)'s rank shapes, 4 ranks: gemma3-1b's global
# layer (256 of 1024 slots a rank) and local layer (128 of its rolled
# 512-slot cache), both at pos 1015 (the last decode step's), and a
# partly written cache (pos 300: ranks 2 and 3 hold no valid slot)
PARTIAL_CASES = [(8, 4, 1, 1024, 256, None, 1015),
                 (8, 4, 1, 512, 256, 512, 1015),
                 (8, 4, 1, 1024, 256, None, 300)]


def decode_partial_checks(rng, errs: dict) -> None:
    """K6's partial form against its plain version on the card for every
    cache dtype at :data:`PARTIAL_CASES`: each rank's output within 1e-5 x
    max |want|, its log-sum-exp within 1e-5 absolute (-inf where the plain
    one is), the ranks' results merged as ``layers.merge_partials`` merges
    them within 1e-5 x max |want| of the whole-cache plain version; the
    whole-cache call bitwise the partial form over (0, S)."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import to_cache_dtype

    dev = torch.device("cuda")
    worst = {}
    for b, hq, hkv, s, d, window, pos in PARTIAL_CASES:
        q = torch.from_numpy(rng.normal(0, 1, (b, hq, 1, d))
                             .astype(np.float32)).to(dev)
        kv = torch.from_numpy(rng.normal(0, 2, (2, b, hkv, s, d))
                              .astype(np.float32)).to(dev)
        n = s // 4
        for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            name = str(dt)[6:]
            k, v = (to_cache_dtype(t, dt) for t in kv)
            tag = f"K6 partial S{s} window={window} pos={pos} {name}"
            parts = []
            for r in range(4):
                kr = k[:, :, r * n:(r + 1) * n].contiguous()
                vr = v[:, :, r * n:(r + 1) * n].contiguous()
                out, lse = da.decode_attention(q, kr, vr, pos, window,
                                               slots=(r * n, s))
                w_out, w_lse = decode_attention_ref(q, kr, vr, pos, window,
                                                    (r * n, s))
                err = rel_close(f"{tag} rank {r} output", out, w_out) \
                    if bool(w_out.any()) else float(out.abs().max())
                if err and not bool(w_out.any()):
                    raise AssertionError(f"{tag} rank {r}: output not zero "
                                         f"with no valid slot")
                if not torch.equal(torch.isneginf(lse), torch.isneginf(w_lse)):
                    raise AssertionError(f"{tag} rank {r}: -inf differs")
                fin = torch.isfinite(w_lse)
                lse_err = float((lse - w_lse)[fin].abs().max()) \
                    if bool(fin.any()) else 0.0
                if lse_err > 1e-5:
                    raise AssertionError(f"{tag} rank {r}: lse off by "
                                         f"{lse_err}")
                parts.append((out, lse))
                worst[name] = max(worst.get(name, 0.0), err)
            outs = torch.stack([o for o, _ in parts])
            lses = torch.stack([l for _, l in parts])
            w = torch.exp(lses - lses.max(0).values)
            merged = (outs * w[..., None]).sum(0) / w.sum(0)[..., None]
            rel_close(f"{tag} merged over 4 ranks vs the whole cache",
                      merged, decode_attention_ref(q, k, v, pos, window))
            whole = da.decode_attention(q, k, v, pos, window)
            if not torch.equal(whole, da.decode_attention(
                    q, k, v, pos, window, slots=(0, s))[0]):
                raise AssertionError(f"{tag}: the whole-cache call differs "
                                     f"from the partial form over (0, S)")
        del q, kv, k, v
    errs["decode_attention_partial"] = worst["float32"]
    errs["decode_attention_partial_bf16"] = worst["bfloat16"]
    errs["decode_attention_partial_fp8"] = worst["float8_e4m3fn"]
    log(f"  K6 partial form: {len(PARTIAL_CASES)} shapes x 3 cache dtypes x "
        f"4 ranks within 1e-5 x max |want| of its plain version, merged "
        f"within 1e-5 of the whole cache, whole-cache call bitwise the "
        f"partial form over (0, S); worst max |diff| {worst}")


BWD_CASES = [   # K4b: ragged T and D, GQA, the training shapes
    dict(b=1, hq=4, hkv=1, tq=200, tk=200, d=80, causal=True, window=96),
    dict(b=2, hq=4, hkv=2, tq=129, tk=129, d=256, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=130, tk=700, d=256, causal=False, window=None),
    dict(b=2, hq=4, hkv=2, tq=257, tk=257, d=255, causal=True, window=None),
    # Tq > Tk with a window: rows 24.. see no key (a zero gradient)
    dict(b=1, hq=2, hkv=1, tq=64, tk=16, d=16, causal=True, window=8),
    # the tiles of the redesign (64 resident rows, 16-row steps): an odd
    # count of key tiles under the causal mask, Tk one past a tile, 8:1 GQA
    # at D = 256 (the per-head partials' sum), a window ending inside a step
    dict(b=1, hq=2, hkv=1, tq=320, tk=320, d=256, causal=True, window=None),
    dict(b=2, hq=2, hkv=2, tq=65, tk=65, d=128, causal=True, window=None),
    dict(b=1, hq=8, hkv=1, tq=200, tk=200, d=256, causal=True, window=None),
    dict(b=1, hq=4, hkv=2, tq=300, tk=300, d=128, causal=True, window=100),
    dict(b=4, hq=4, hkv=1, tq=1024, tk=1024, d=256, causal=True, window=512),
    dict(b=4, hq=4, hkv=1, tq=1024, tk=1024, d=256, causal=True, window=None),
    # moonshot-v1-16b-a3b's training shape, phase (m-d)
    dict(b=4, hq=16, hkv=16, tq=1024, tk=1024, d=128, causal=True,
         window=None),
    # zamba2-7b's shared block in training, phase (z-t)
    dict(b=4, hq=32, hkv=32, tq=1024, tk=1024, d=112, causal=True,
         window=None),
]


def grad_close(what: str, got, want) -> float:
    """Fail unless a gradient holds to its plain twin: fp32 within 5e-5 x
    max(1, max |want|) (sums of up to Tq x D products in another order);
    bf16 within one bf16 ulp of each value plus 1e-3 x max(1, max |want|).
    Returns max |diff|."""
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    diff = (g - w).abs()
    err = float(diff.max())
    top = max(1.0, float(w.abs().max()))
    if got.dtype == torch.float32:
        limit = 5e-5 * top
    else:
        limit = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(
            torch.finfo(torch.float32).tiny))) - 7) + 1e-3 * top
    if not bool(torch.isfinite(g).all()) or not bool((diff <= limit).all()):
        raise AssertionError(f"{what}: kernel vs twin max |diff| {err}")
    log(f"  {what}: max |diff| {err:.3g} (max |want| {top:.3g})")
    return err


def drift_close(what: str, got, plain, exact) -> None:
    """Fail unless each of K4b's gradients ``got`` leans from the float64
    gradient ``exact`` by at most 5e-6 of it: |sum(got exact) / sum(exact^2)
    - 1|, a bias that max |diff| does not show and that adds up over a
    model's layers (one tensor-core accumulator over 512 products drifts
    ~1e-5 toward zero, enough to move gemma3-1b's gradient norm past check
    (a)'s 1e-5).  The fp32 plain version's lean is printed beside."""
    def lean(a, b):
        return float((a.double() * b).sum() / (b * b).sum() - 1.0)

    for w, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        kernel, ref = lean(g, e), lean(p, e)
        log(f"  {what} {w}: lean from float64 {kernel:+.2e} (plain fp32 "
            f"{ref:+.2e})")
        if abs(kernel) > 5e-6:
            raise AssertionError(f"{what} {w}: leans {kernel:+.2e} from the "
                                 f"float64 gradient")


def phase_lm_bwd_kernels(rng, errs: dict) -> None:
    """K4 with its L, K4b and K3b against their plain versions on the card,
    fp32 and bf16 (:func:`grad_close`); K4's output with L written bitwise
    the serving output; two K4b / K3b calls bitwise; a fully masked row's
    dq zero; K4b's lean from float64 at the training shapes
    (:func:`drift_close`)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

    dev = torch.device("cuda")

    def rand(shape, dt, sd=1.0):
        return torch.from_numpy(rng.normal(0, sd, shape).astype(np.float32)) \
            .to(dev, dt)

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        sfx = "" if dt == torch.float32 else "_bf16"
        for c in BWD_CASES:
            q = rand((c["b"], c["hq"], c["tq"], c["d"]), dt)
            k, v = (rand((c["b"], c["hkv"], c["tk"], c["d"]), dt)
                    for _ in range(2))
            do = rand((c["b"], c["hq"], c["tq"], c["d"]), dt)
            kw = dict(scale=c["d"] ** -0.5, causal=c["causal"],
                      window=c["window"])
            out, lse = fa.flash_attention(q, k, v, with_lse=True, **kw)
            if not torch.equal(out, fa.flash_attention(q, k, v, **kw)):
                raise AssertionError("K4's output changes when L is written")
            want_lse = attention_fwd_ref(q, k, v, **kw)[1]
            lse_tol = 1e-5 if dt == torch.float32 else 1e-2
            if lse.dtype != torch.float32 or not bool(
                    ((lse - want_lse).abs()
                     <= lse_tol * want_lse.abs().clamp_min(1.0)).all()):
                raise AssertionError(
                    f"K4's L vs its plain version: max |diff| "
                    f"{float((lse - want_lse).abs().max())}")
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
            tag = (f"K4b b{c['b']} hq{c['hq']} hkv{c['hkv']} tq{c['tq']} "
                   f"tk{c['tk']} d{c['d']} causal={c['causal']} "
                   f"window={c['window']} {name}")
            err = max(grad_close(f"{tag} {w}", g, ww)
                      for w, g, ww in zip(("dq", "dk", "dv"), got, want))
            errs["flash_attention_bwd" + sfx] = max(
                errs.get("flash_attention_bwd" + sfx, 0.0), err)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: two K4b calls differ")
            if c["window"] and c["tq"] > c["tk"] + c["window"]:
                if got[0][:, :, c["tk"] + c["window"]:].any():
                    raise AssertionError(f"{tag}: a fully masked row has "
                                         f"a gradient")
            if dt == torch.float32 and c["b"] == TRAIN["batch"]:
                drift_close(tag, got, want, attention_bwd_ref(
                    *(x.double() for x in (q, k, v, out, lse, do)), **kw))
        for rows, d, off in ((4096, 1152, 0), (16384, 256, 0), (7, 1150, 0),
                             (300, 256, 1), (5, 8192, 0), (1001, 2048, 0),
                             (1001, 2056, 0), (4096, 2048, 0),
                             (4096, 4096, 0), (4096, 3584, 0),
                             (4096, 7168, 0), (1, 4096, 0), (8, 7168, 0),
                             (9, 4096, 1), (3, 16392, 0), (3, 32776, 0)):
            x = rand((rows * d + off,), dt, 2.0)[off:].view(rows, d)
            g = rand((rows, d), dt)
            sc = rand((d,), dt, 0.1)
            got = rn.rmsnorm_rows_bwd(x, sc, g)
            want = rmsnorm_bwd_ref(x, sc, g)
            tag = (f"K3b ({rows}, {d}){' offset 1' if off else ''} {name}, "
                   f"variant {rn.variant(x, sc, g)[0]}")
            err = max(grad_close(f"{tag} {w}", a, b)
                      for w, a, b in zip(("dx", "dscale"), got, want))
            errs["rmsnorm_bwd" + sfx] = max(errs.get("rmsnorm_bwd" + sfx,
                                                     0.0), err)
            again = rn.rmsnorm_rows_bwd(x, sc, g)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: two K3b calls differ")
    scan_bwd_checks(errs, dev)


# K5b's gradients, each held to 1e-5 x its max |want|, the forward's
# tolerance.  The sums over the d channels (dB, dC) and over B x S steps
# (dA, dD) need no looser one: their worst, 2.96e-6 (dA at falcon's
# training layer; dB 1.35e-6), is under it (this script on an H100 80GB
# HBM3 at 700 W)
SCAN_GRADS = ("ddt", "dx", "dB", "dC", "dA", "dh0", "dD", "dz")
SSM_TRAIN = dict(batch=4, seq=1024, layers={"falcon-mamba-7b": 4,
                                            "zamba2-7b": 6}, steps=6)


def scan_grads_close(what: str, got, want) -> float:
    """Fail unless each of K5b's gradients holds to its plain twin within
    1e-5 x its max |want|; returns the worst max |diff|."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} gradients, want "
                             f"{len(want)}")
    return max(rel_close(f"{what} {n}", g, w)
               for n, g, w in zip(SCAN_GRADS, got, want))


def scan_bwd_checks(errs: dict, dev) -> None:
    """K5b against ``selective_scan_bwd_ref`` on the card: gated at ragged
    shapes (B 3, d 200 -- not a multiple of its block of channels -- N 1,
    5 and 16, S 1, 17 and 130), scan-only at one; then gated at
    falcon-mamba-7b's training layer (4, 1024, 8192, 16) with a nonzero h0
    and dh_last, against the plain backward and against torch autograd of
    ``selective_scan_gated_ref``; two K5b calls bitwise; K5 with its saved
    states bitwise the serving call."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.selective_scan import kernel as ss
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_bwd_ref, selective_scan_gated_ref)

    t0 = time.perf_counter()

    def case(shape, seed, gated=True):
        ins = scan_inputs(shape, seed, dev)
        gate = gate_inputs(ins, seed) if gated else ()
        gen = torch.Generator(device=dev).manual_seed(seed + 200)
        cot = (torch.randn(ins[0].shape, generator=gen, device=dev),
               torch.randn(ins[5].shape, generator=gen, device=dev))
        y, h, hs = ss.selective_scan(*ins, *gate, states=True)
        served = ss.selective_scan(*ins, *gate)
        if not (torch.equal(y, served[0]) and torch.equal(h, served[1])):
            raise AssertionError(f"K5 {shape}: saving its states changes "
                                 f"its output")
        return ins, gate, hs, cot

    err = 0.0
    for s in (1, 17, 130):
        for n in (1, 5, 16):
            shape = (3, s, 200, n)
            ins, gate, hs, cot = case(shape, s * n)
            err = max(err, scan_grads_close(
                f"K5b gated {shape}", ss.selective_scan_bwd(
                    *ins, hs, *cot, *gate),
                selective_scan_bwd_ref(*ins, *cot, *gate)))
    shape = (3, 130, 200, 5)
    ins, gate, hs, cot = case(shape, 7, gated=False)
    err = max(err, scan_grads_close(
        f"K5b scan-only {shape}", ss.selective_scan_bwd(*ins, hs, *cot),
        selective_scan_bwd_ref(*ins, *cot)))
    falcon = get_arch(SSM["archs"][0])
    shape = (SSM_TRAIN["batch"], SSM_TRAIN["seq"], falcon.d_inner,
             falcon.ssm_state)
    ins, gate, hs, cot = case(shape, 11)
    got = ss.selective_scan_bwd(*ins, hs, *cot, *gate)
    err = max(err, scan_grads_close(
        f"K5b gated {shape}, falcon's training layer, vs plain", got,
        selective_scan_bwd_ref(*ins, *cot, *gate)))
    again = ss.selective_scan_bwd(*ins, hs, *cot, *gate)
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError("two K5b calls differ")
    log(f"  K5b {shape}: two calls bitwise equal")
    del again
    leaves = [t.clone().requires_grad_() for t in (*ins, *gate)]
    y, h = selective_scan_gated_ref(*leaves)
    auto = torch.autograd.grad((y * cot[0]).sum() + (h * cot[1]).sum(),
                               leaves)
    del y, h
    scan_grads_close(f"K5b gated {shape} vs torch autograd of the plain "
                     f"forward", got, auto)
    errs["selective_scan_bwd"] = err
    log(f"  K5b checks: {time.perf_counter() - t0:.1f} s")


SERVE = dict(arch="gemma3-1b", batch=8, prompt_len=1024, max_new=32,
             max_len=1056)


def expected_lm_launches(cfg, max_new: int) -> dict:
    """K3 / K4 / K5 / K6 launches of one ``generate``.  Attention
    families: per layer, prefill runs ln1 and ln2 and, with qk_norm,
    q_norm, k_norm and ``_prefill_kv``'s k_norm; decode runs ln1, ln2 (+
    q_norm, k_norm); every forward ends in the final norm.  K4 runs once
    per layer in prefill, K6 once per layer in each decode step (decode
    attention over the cache).  SSM families: every forward runs each
    layer's ln (and a Mamba2 layer's gate norm), ln1 and ln2 of each shared
    attention call and the final norm; K4 runs once per shared attention
    call in prefill and K6 once per shared call in each decode step, and K5
    once per Mamba1 layer in every forward (gated over the prompt in
    prefill, at S = 1 in each decode step): 64 x 32 = 2,048 for
    falcon-mamba-7b's serve."""
    from repro_torch.models.model import layer_kind, pattern_period

    steps = max_new - 1
    if cfg.family in ("ssm", "hybrid"):
        per = pattern_period(cfg)
        kinds = [layer_kind(cfg, i % per) for i in range(cfg.n_layers)]
        attn = sum(k["shared_attn"] for k in kinds)
        mamba1 = sum(k["type"] == "mamba1" for k in kinds)
        forward = 2 * cfg.n_layers - mamba1 + 2 * attn + 1
        return {"rmsnorm": forward * max_new, "flash_attention": attn,
                "selective_scan": mamba1 * max_new, "rmsnorm_bwd": 0,
                "flash_attention_bwd": 0, "selective_scan_bwd": 0,
                "decode_attention": attn * steps,
                "decode_attention_partial": 0}
    qk = 2 if cfg.qk_norm else 0
    prefill = cfg.n_layers * (2 + qk + qk // 2) + 1
    decode = cfg.n_layers * (2 + qk) + 1
    return {"rmsnorm": prefill + steps * decode,
            "flash_attention": cfg.n_layers, "rmsnorm_bwd": 0,
            "flash_attention_bwd": 0, "selective_scan": 0,
            "selective_scan_bwd": 0, "decode_attention": cfg.n_layers * steps,
            "decode_attention_partial": 0}


def phase_serve(counts: dict, errs: dict) -> dict:
    """The LM serving path: gemma3-1b at full width, random weights from a
    torch.Generator seeded 0, 8 prompts of 1024 tokens from numpy
    default_rng(0), 32 new tokens, greedy.  Then the same prefill once
    through the kernels and once through the plain versions, on the card:
    the last-position logits must agree within rtol = atol = 1e-4 (the
    CPU parity tests' tolerance; fp32 throughout, TF32 off)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as Mdl

    cfg = get_arch(SERVE["arch"])
    b, plen, new, max_len = (SERVE[k] for k in
                             ("batch", "prompt_len", "max_new", "max_len"))
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Mdl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {Mdl.param_count(params)} parameters (fp32) made on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(b, plen))
    t0 = time.perf_counter()
    generate(cfg, params, prompts, 3, max_len)     # warm-up, not counted
    log(f"  warm-up generate (prefill + 2 decode steps): "
        f"{time.perf_counter() - t0:.2f} s")

    reset_all_launches()
    tokens, t = generate(cfg, params, prompts, new, max_len)
    counts["serve"] = lm_launches()
    want = expected_lm_launches(cfg, new)
    log(f"  generate: prefill {t['prefill_s']:.4f} s "
        f"({b * plen / t['prefill_s']:.1f} tok/s), decode {t['decode_s']:.4f}"
        f" s for {new - 1} steps ({b * (new - 1) / t['decode_s']:.1f} tok/s);"
        f" launches {counts['serve']} (expected {want}); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    if counts["serve"] != want:
        raise AssertionError(f"serve launches {counts['serve']} != {want}")
    tok = tokens.cpu().numpy()
    if tok.shape != (b, new) or tok.min() < 0 or tok.max() >= cfg.vocab:
        raise AssertionError(f"bad tokens: {tok.shape} {tok.min()} "
                             f"{tok.max()}")
    log(f"  first request continuation: {tok[0][:16].tolist()}")

    def prefill(impl):
        caches = Mdl.init_caches(cfg, b, max_len, device=dev)
        logits, _, _ = Mdl.forward(cfg, params, torch.as_tensor(
            prompts, device=dev), mode="prefill", caches=caches, impl=impl)
        return logits

    kern, plain = prefill("flash"), prefill("ref")
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError("prefill logits are not finite")
    err = float((kern - plain).abs().max())
    log(f"  prefill logits, kernels vs plain on the card: max |diff| {err:.3g}"
        f" (max |logit| {float(plain.abs().max()):.4g})")
    if not torch.allclose(kern, plain, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"prefill logits: kernels vs plain max |diff| "
                             f"{err} beyond rtol = atol = 1e-4")
    if not torch.equal(kern.argmax(-1).cpu(), tokens[:, 0].cpu()):
        raise AssertionError("generate's first tokens are not the argmax "
                             "of the kernel path's prefill logits")
    errs["serve_logits"] = err
    return {"cfg": cfg, "params": params, "prompts": prompts}


TRAIN = dict(arch="gemma3-1b", batch=4, seq=1024, steps=8, lr=3e-3,
             save_at=4, ce_chunk=256)


def expected_train_launches(cfg) -> dict:
    """K3 / K3b / K4 / K4b / K5 / K5b launches of one ``train_step`` with
    remat.  An attention layer runs ln1 and ln2 (and, with qk_norm, q_norm
    and k_norm) forward and attention once; an SSM layer its ln (and a
    Mamba2 layer its gate norm) and a Mamba1 layer K5 once, and a shared
    attention call ln1, ln2 and attention; the final norm runs once, and
    each has one backward.  Remat runs the forward of the scanned blocks'
    layers again in the backward (not the remainder layers', nor the final
    norm): K5 runs twice a Mamba1 layer, K5b once."""
    from repro_torch.models.model import layer_kind, pattern_period

    per = pattern_period(cfg)
    again = (cfg.n_layers // per) * per
    k3 = k4 = k5 = k3_again = k4_again = k5_again = 0
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i % per)
        if cfg.family in ("ssm", "hybrid"):
            attn = int(kind["shared_attn"])
            norms = (1 if kind["type"] == "mamba1" else 2) + 2 * attn
            scan = int(kind["type"] == "mamba1")
        else:
            attn, scan = 1, 0
            norms = 2 + (2 if cfg.qk_norm else 0)
        k3, k4, k5 = k3 + norms, k4 + attn, k5 + scan
        if i < again:
            k3_again += norms
            k4_again += attn
            k5_again += scan
    return {"rmsnorm": k3 + 1 + k3_again, "rmsnorm_bwd": k3 + 1,
            "flash_attention": k4 + k4_again, "flash_attention_bwd": k4,
            "selective_scan": k5 + k5_again, "selective_scan_bwd": k5,
            "decode_attention": 0, "decode_attention_partial": 0}


def phase_train(counts: dict, card: str) -> dict:
    """The LM training path: gemma3-1b at full width, fp32 (TF32 off),
    random weights from a torch.Generator seeded 0, the port's synthetic
    Markov data (seed 0), global batch 4 x 1024, remat, AdamW (weight
    decay 0.1) with warmup-cosine over 8 steps.  Checks, each failing the
    script: (a) step 0's loss and gradients through the kernels (K3, K4,
    K3b, K4b) against the plain path on the card -- loss rel 1e-6, global
    grad norm rel 1e-5, every leaf max |dg| <= 1e-4 x max |g_plain| (the
    issue's 1e-5 / 1e-4 / 1e-3 tightened tenfold: the worst leaf measured
    5.8e-6), and a nonzero gradient on every leaf; (b) remat
    off against on, every leaf within 1e-6 x max |g| (the same arithmetic
    recomputed: bitwise is reported); (c) two backward passes bitwise; (d)
    the loss after 8 steps below step 0's; (e) an async save at step 4,
    restored into a fresh state, replays steps 4-7 with bitwise the same
    losses; (f) the launches of a step equal ``expected_train_launches``;
    (g) a chunked-CE step (chunk 256) has step 0's loss within rel 1e-5."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.checkpoint.checkpoint import AsyncCheckpointer, restore
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import upload
    from repro_torch.models.convert import flatten
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import (AdamWConfig, global_norm,
                                             warmup_cosine)

    cfg = get_arch(TRAIN["arch"])
    b, s, steps, lr = (TRAIN[k] for k in ("batch", "seq", "steps", "lr"))
    dev = torch.device("cuda")
    tc = TT.TrainConfig(optimizer=AdamWConfig(
        lr=lr, weight_decay=0.1,
        schedule=warmup_cosine(lr, warmup=max(steps // 20, 5), total=steps)),
        remat=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                                  mean_doc_len=s / 2))
    batches = [{k: upload(v, dev) for k, v in data.batch(i).items()}
               for i in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    state = TT.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    n_params = sum(p.numel() for p in flatten(state.params).values())
    log(f"  {cfg.name}: {n_params} parameters (fp32), batch {b} x {s}, "
        f"remat, {steps} steps [{card}]")
    TT.loss_and_grads(cfg, tc, state.params, batches[0])   # warm-up
    torch.cuda.synchronize()

    # (f) the counted step
    reset_all_launches()
    t0 = time.perf_counter()
    m0 = TT.train_step(cfg, tc, state, batches[0])[1]
    loss0 = float(m0["loss"])
    step0_s = time.perf_counter() - t0
    counts["train"] = lm_launches()
    want = expected_train_launches(cfg)
    log(f"  (f) step 0: loss {loss0:.6f}, grad norm "
        f"{float(m0['grad_norm']):.6f}, {step0_s:.3f} s; launches "
        f"{counts['train']} (expected {want})")
    if counts["train"] != want:
        raise AssertionError(f"train launches {counts['train']} != {want}")

    # (a) kernels against the plain path; (c) twice bitwise; (b) remat off
    lk, _, gk = TT.loss_and_grads(cfg, tc, state.params, batches[0])
    lr_, _, gr = TT.loss_and_grads(cfg, tc, state.params, batches[0],
                                   impl="ref")
    nk, nr = float(global_norm(gk)), float(global_norm(gr))
    fk, fr = flatten(gk), flatten(gr)
    worst = max((float((fk[n] - fr[n]).abs().max())
                 / max(float(fr[n].abs().max()), 1e-30), n) for n in fr)
    log(f"  (a) kernels vs plain on the card: loss {float(lk):.7f} vs "
        f"{float(lr_):.7f}, grad norm {nk:.7f} vs {nr:.7f}, worst leaf "
        f"max |dg| / max |g| {worst[0]:.3g} ({worst[1]}) [{card}]")
    if abs(float(lk) - float(lr_)) > 1e-6 * abs(float(lr_)):
        raise AssertionError("(a) loss: kernels vs plain beyond rel 1e-6")
    if abs(nk - nr) > 1e-5 * nr:
        raise AssertionError("(a) grad norm: kernels vs plain beyond rel "
                             "1e-5")
    if worst[0] > 1e-4:
        raise AssertionError(f"(a) leaf {worst[1]}: max |dg| beyond 1e-4 x "
                             f"max |g|")
    dead = [n for n, g in fk.items() if not bool(g.any())]
    if dead:
        raise AssertionError(f"(a) no gradient reaches {dead[:8]}")
    del gr, fr
    _, _, g2 = TT.loss_and_grads(cfg, tc, state.params, batches[0])
    same = all(torch.equal(x, y) for x, y in zip(fk.values(),
                                                 flatten(g2).values()))
    log(f"  (c) two backward passes bitwise equal: {same}")
    if not same:
        raise AssertionError("(c) two backward passes differ")
    del g2
    _, _, gn = TT.loss_and_grads(cfg, dataclasses.replace(tc, remat=False),
                                 state.params, batches[0])
    fn = flatten(gn)
    bitwise = all(torch.equal(fk[n], fn[n]) for n in fk)
    rel = max(float((fk[n] - fn[n]).abs().max())
              / max(float(fn[n].abs().max()), 1e-30) for n in fn)
    log(f"  (b) remat off vs on: bitwise {bitwise}, worst leaf max |dg| / "
        f"max |g| {rel:.3g}; peak {torch.cuda.max_memory_allocated()} B "
        f"so far")
    if rel > 1e-6:
        raise AssertionError("(b) remat changes the gradients beyond 1e-6")
    del gk, gn, fk, fn

    # (g) chunked CE
    mc = TT.train_step(cfg, dataclasses.replace(
        tc, ce_chunk=TRAIN["ce_chunk"]), state, batches[0])[1]
    log(f"  (g) chunked CE (chunk {TRAIN['ce_chunk']}): loss "
        f"{float(mc['loss']):.7f} vs {loss0:.7f}, grad norm "
        f"{float(mc['grad_norm']):.6f}")
    if abs(float(mc["loss"]) - loss0) > 1e-5 * abs(loss0):
        raise AssertionError("(g) chunked CE loss beyond rel 1e-5")

    # (d) 8 steps, (e) async save at step 4, restore, replay
    ckdir = os.path.join(ROOT, "build", "train_smoke_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = AsyncCheckpointer(ckdir)
    # the checks above leave the allocator's cache split into blocks of
    # their sizes: start the timed steps from an empty cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    losses, walls = [], []
    st = state
    del state
    for i in range(steps):
        if i == TRAIN["save_at"]:
            t0 = time.perf_counter()
            ck.save_async(i, st)
            log(f"  (e) save_async at step {i}: {time.perf_counter() - t0:.2f}"
                f" s on the caller (the host copy)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = TT.train_step(cfg, tc, st, batches[i])
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        log(f"  step {i}: loss {losses[-1]:.6f} ce {float(m['ce']):.6f} "
            f"gnorm {float(m['grad_norm']):.4f} {walls[-1] * 1e3:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ck.wait()
    log(f"  (e) waited {time.perf_counter() - t0:.2f} s more for the write")
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    ms = float(np.median(walls[1:])) * 1e3
    log(f"  train step: {ms:.1f} ms median of steps 1-{steps - 1} (mean "
        f"{np.mean(walls[1:]) * 1e3:.1f}, max {max(walls[1:]) * 1e3:.1f}), "
        f"{b * s / ms * 1e3:.1f} tok/s, max_memory_allocated {peak} B, "
        f"allocator retries {retries} [{card}]")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(d) loss did not fall: {losses}")
    del st
    t0 = time.perf_counter()
    fresh = TT.init_state(cfg, torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    st, at = restore(ckdir, fresh)
    del fresh
    log(f"  (e) restored step {at} into a fresh state in "
        f"{time.perf_counter() - t0:.2f} s")
    replay = []
    for i in range(at, steps):
        st, m = TT.train_step(cfg, tc, st, batches[i])
        replay.append(float(m["loss"]))
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"  (d) losses {losses}; (e) replayed {replay}")
    if at != TRAIN["save_at"] or replay != losses[at:]:
        raise AssertionError("(e) the replay from the checkpoint differs")
    return {"cfg": cfg, "tc": tc, "state": st, "batch": batches[0],
            "ms": ms, "peak": peak}


MOE = dict(arch="moonshot-v1-16b-a3b", n_layers=24, batch=8, prompt_len=1024,
           max_new=32, max_len=1056, layer_tokens=8192, train_layers=2,
           train_batch=4, train_seq=1024, peak_limit=80e9)


@contextlib.contextmanager
def router_probs():
    """Yield a list that gathers the router probabilities of every
    ``moe.moe_apply`` call made inside the block, in call order (a
    remat'd block's recomputation included)."""
    from repro_torch.models import moe

    seen, apply = [], moe.moe_apply

    def recording(*args, **kw):
        y, probs = apply(*args, **kw)
        seen.append(probs.detach())
        return y, probs

    moe.moe_apply = recording
    try:
        yield seen
    finally:
        moe.moe_apply = apply


def other_dispatch(probs_a, probs_b, cfg) -> tuple:
    """(tokens routed to another expert set, tokens with any other
    dispatch) summed over pairs of router probabilities."""
    from repro_torch.models.moe import dispatch_codes

    flips = diff = 0
    for a, b in zip(probs_a, probs_b):
        ca, cb = dispatch_codes(a, cfg), dispatch_codes(b, cfg)
        flips += int(((ca > 0) != (cb > 0)).any(-1).sum())
        diff += int((ca != cb).any(-1).sum())
    return flips, diff


def topk_gap(probs, k: int):
    """(T,) gap between each row's k-th and (k+1)-th probability over the
    row's largest."""
    top = probs.topk(k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]) / top[:, 0]


def routing_parts(what: str, probs_a, probs_b, cfg, tie: float) -> tuple:
    """Where two runs of one MoE layer routed alike.  A token whose routed
    expert set differs (a flip) must be a near tie in run a: gap <= ``tie``
    (``topk_gap``).  A token whose set agrees but whose drops differ is a
    flip's knock-on (an earlier copy took or freed a slot), allowed only
    beside a flip.  Returns (mask of tokens routed alike, flips, knock-ons,
    share of copies dropped in run a)."""
    from repro_torch.models.moe import dispatch_codes

    a = dispatch_codes(probs_a, cfg)
    b = dispatch_codes(probs_b.to(probs_a.device), cfg)
    flip = ((a > 0) != (b > 0)).any(-1)
    knock = (a != b).any(-1) & ~flip
    n_flip, n_knock = int(flip.sum()), int(knock.sum())
    if n_flip:
        gap = topk_gap(probs_a, cfg.top_k)[flip]
        if float(gap.max()) > tie:
            raise AssertionError(
                f"{what}: {n_flip} tokens routed to other experts, one at a "
                f"k-th / (k+1)-th gap of {float(gap.max()):.3g} of the max "
                f"probability, beyond the near-tie bound {tie}")
    elif n_knock:
        raise AssertionError(f"{what}: {n_knock} tokens drop other copies "
                             f"with no routing flip")
    dropped = float((a == 1).sum()) / (probs_a.shape[0] * cfg.top_k)
    return ~(a != b).any(-1), n_flip, n_knock, dropped


def rows_close(what: str, got, want, agree, rtol: float, atol: float) -> float:
    """Fail unless the rows of ``agree`` hold |got - want| <= atol + rtol
    |want| (and are finite); returns their max |diff|."""
    import torch

    g = got.reshape(agree.shape[0], -1)[agree]
    w = want.to(got.device).reshape(agree.shape[0], -1)[agree]
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or \
            not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max |diff| {err} beyond rtol {rtol} "
                             f"atol {atol} on tokens routed alike")
    return err


def moe_layer_card_vs_cpu(cfg, dev) -> None:
    """(m-a) One MoE layer at full width, T = 8,192 tokens from numpy
    default_rng(1) (unit RMS, as after a norm), weights from a torch
    Generator seeded 1 carried to the CPU: the card against the CPU port.
    Expert ids equal but at near ties (gap <= 1e-6 x the max probability);
    tokens routed alike within rtol 1e-4 / atol 1e-5; two card runs
    bitwise."""
    import torch

    from repro_torch.models import moe

    p = moe.init_moe(torch.Generator(device=dev).manual_seed(1), cfg,
                     torch.float32, dev)
    x = np.random.default_rng(1).normal(
        0, 1, (1, MOE["layer_tokens"], cfg.d_model)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    y, probs = moe.moe_apply(p, xd, cfg)
    y2, probs2 = moe.moe_apply(p, xd, cfg)
    same = torch.equal(y, y2) and torch.equal(probs, probs2)
    t0 = time.perf_counter()
    yc, probsc = moe.moe_apply({k: v.cpu() for k, v in p.items()},
                               torch.from_numpy(x), cfg)
    cpu_s = time.perf_counter() - t0
    agree, flips, knock, dropped = routing_parts(
        "(m-a) card vs CPU", probs, probsc, cfg, 1e-6)
    err = rows_close("(m-a) card vs CPU", y, yc, agree, 1e-4, 1e-5)
    gap = topk_gap(probs, cfg.top_k)
    log(f"  (m-a) MoE layer T={x.shape[1]}, E={cfg.n_experts}, top-"
        f"{cfg.top_k}, C={moe._capacity(x.shape[1], cfg)}: card vs CPU "
        f"(CPU {cpu_s:.2f} s) max |dy| {err:.3g} on {int(agree.sum())} "
        f"tokens routed alike; {flips} routing flips, {knock} knock-on "
        f"drops; {int((gap <= 1e-6).sum())} tokens at a near tie (gap <= "
        f"1e-6 of the max), smallest gap {float(gap.min()):.3g}; copies "
        f"dropped {dropped:.6f}; two card runs bitwise: {same}")
    if not same:
        raise AssertionError("(m-a) two card runs of the MoE layer differ")


def moe_layer(cfg, params, i: int, x, impl: str) -> tuple:
    """Layer i of an all-MoE stack on prefill input x, through
    ``model._attn_mlp_layer`` (what ``forward`` runs): (output, router
    probabilities)."""
    import torch

    from repro_torch.models import model as Mdl

    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    with router_probs() as probs:
        out, _ = Mdl._attn_mlp_layer(
            cfg, Mdl.layer_kind(cfg, 0),
            Mdl._index(params["blocks"]["pos0"], i), x, positions=positions,
            cache=None, cache_pos=None, mode="train", impl=impl)
    return out, probs[0]


def moe_chain(cfg, params, tokens, impl: str) -> tuple:
    """The prefill layer by layer: every layer's input and the last one's
    output (L + 1 hidden states), each layer's router probabilities, and
    the last position's logits."""
    from repro_torch.models.layers import rms_norm

    xs, probs = [params["embed"][tokens]], []
    for i in range(cfg.n_layers):
        x, pr = moe_layer(cfg, params, i, xs[-1], impl)
        xs.append(x)
        probs.append(pr)
    x = rms_norm(xs[-1], params["final_norm"], cfg.norm_eps, impl == "ref")
    return xs, probs, x[:, -1, :] @ params["lm_head"]


def phase_moe(counts: dict, errs: dict, card: str, dev) -> dict:
    """(m) The MoE serving path: moonshot-v1-16b-a3b at full width with 24
    of its 48 layers (all 48 hold 115.6 GB in fp32), fp32 with TF32 off,
    random weights from a torch.Generator seeded 0, 8 prompts of 1024
    tokens from numpy default_rng(0), 32 new tokens, greedy.  (m-a) one
    MoE layer on the card against the CPU port; (m-b) ``generate``, its
    K3 / K4 launches, peak memory under 80 GB and tokens; (m-c) each
    layer's input (the kernel path's) through the kernels and the plain
    versions: tokens routed alike within rtol = atol = 1e-4, every routing
    flip a near tie (gap <= 1e-5 x the max probability); the whole
    prefill's logits kernels vs plain, held to 1e-4 only where no layer's
    routing flipped.  Returns what (m-f) profiles."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as Mdl

    cfg = dataclasses.replace(get_arch(MOE["arch"]),
                              n_layers=MOE["n_layers"])
    b, plen, new, max_len = (MOE[k] for k in
                             ("batch", "prompt_len", "max_new", "max_len"))
    log(f"  memory_allocated at the start of the phase: "
        f"{torch.cuda.memory_allocated()} B [{card}]")
    moe_layer_card_vs_cpu(cfg, dev)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Mdl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {Mdl.param_count(params)} parameters (fp32, "
        f"{cfg.n_layers} of 48 layers) made on the card in "
        f"{time.perf_counter() - t0:.2f} s; memory_allocated "
        f"{torch.cuda.memory_allocated()} B")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(b, plen))
    t0 = time.perf_counter()
    generate(cfg, params, prompts, 3, max_len)     # warm-up, not counted
    log(f"  warm-up generate (prefill + 2 decode steps): "
        f"{time.perf_counter() - t0:.2f} s")

    # (m-b) the counted run
    reset_all_launches()
    tokens, t = generate(cfg, params, prompts, new, max_len)
    counts["moe_serve"] = lm_launches()
    want = expected_lm_launches(cfg, new)
    peak = torch.cuda.max_memory_allocated()
    log(f"  (m-b) generate: prefill {t['prefill_s']:.4f} s "
        f"({b * plen / t['prefill_s']:.1f} tok/s), decode {t['decode_s']:.4f}"
        f" s for {new - 1} steps ({b * (new - 1) / t['decode_s']:.1f} tok/s,"
        f" {t['decode_s'] / (new - 1) * 1e3:.2f} ms a step); launches "
        f"{counts['moe_serve']} (expected {want}); max_memory_allocated "
        f"{peak} B [{card}]")
    if counts["moe_serve"] != want:
        raise AssertionError(f"(m-b) launches {counts['moe_serve']} != "
                             f"{want}")
    if peak >= MOE["peak_limit"]:
        raise AssertionError(f"(m-b) peak {peak} B is not under 80 GB")
    tok = tokens.cpu().numpy()
    if tok.shape != (b, new) or tok.min() < 0 or tok.max() >= cfg.vocab:
        raise AssertionError(f"(m-b) bad tokens: {tok.shape} {tok.min()} "
                             f"{tok.max()}")
    log(f"  first request continuation: {tok[0][:16].tolist()}")

    # (m-c) kernels against plain, layer by layer, then the whole prefill
    toks = torch.as_tensor(prompts, device=dev)
    caches = Mdl.init_caches(cfg, b, max_len, device=dev)
    kern = Mdl.forward(cfg, params, toks, mode="prefill", caches=caches)[0]
    del caches
    if not torch.equal(kern.argmax(-1).cpu(), tokens[:, 0].cpu()):
        raise AssertionError("(m-b) generate's first tokens are not the "
                             "argmax of the kernel path's prefill logits")
    xs, probs_k, chain = moe_chain(cfg, params, toks, "flash")
    if not torch.equal(chain, kern):
        raise AssertionError("(m-c) the layer-by-layer kernel path does not "
                             "reproduce forward's prefill logits bitwise")
    flips = knocks = 0
    worst = 0.0
    drops = []
    for i in range(cfg.n_layers):
        y_ref, pr_ref = moe_layer(cfg, params, i, xs[i], "ref")
        agree, f, kn, dropped = routing_parts(
            f"(m-c) layer {i}", probs_k[i], pr_ref, cfg, 1e-5)
        worst = max(worst, rows_close(f"(m-c) layer {i}", xs[i + 1], y_ref,
                                      agree, 1e-4, 1e-4))
        flips, knocks = flips + f, knocks + kn
        drops.append(dropped)
    log(f"  (m-c) {cfg.n_layers} layers, kernels vs plain on the kernel "
        f"path's inputs: max |diff| {worst:.3g} on tokens routed alike; "
        f"{flips} routing flips (each a near tie, gap <= 1e-5), {knocks} "
        f"knock-on drops; copies dropped by layer "
        f"{[round(d, 6) for d in drops]}")
    errs["moe_layers"] = worst
    del xs
    _, probs_r, plain = moe_chain(cfg, params, toks, "ref")
    whole_flips, whole_diff = other_dispatch(probs_k, probs_r, cfg)
    err = float((kern - plain).abs().max())
    same_top = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    log(f"  (m-c) whole prefill, kernels vs plain: logits max |diff| "
        f"{err:.3g} (max |logit| {float(plain.abs().max()):.4g}), argmax "
        f"agrees on {same_top} of {b}; {whole_flips} tokens routed to other "
        f"experts and {whole_diff} with other dispatch over the "
        f"{cfg.n_layers} layers")
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError("(m-c) prefill logits are not finite")
    if whole_diff == 0 and not torch.allclose(kern, plain, rtol=1e-4,
                                              atol=1e-4):
        raise AssertionError(f"(m-c) prefill logits: kernels vs plain max "
                             f"|diff| {err} beyond 1e-4 with no routing flip")
    return {"cfg": cfg, "params": params, "prompts": prompts}


def decode_steps(served: dict, steps: int, max_len: int):
    """Prefill the served prompts (after their patch embeddings, where
    ``served["vision"]`` holds some) into fresh caches of
    ``served["cache_dtype"]`` (default fp32), and return a function that
    runs ``steps`` greedy decode steps on them from the prompts' end (the
    decode-only profiles; a second call rewrites the same cache positions,
    and an SSM state steps on from where the first left it)."""
    import torch

    from repro_torch.models import model as Mdl

    cfg, params, prompts = (served[k] for k in ("cfg", "params", "prompts"))
    vis = served.get("vision")
    start = prompts.shape[1] + (0 if vis is None else vis.shape[1])
    dev = params["embed"].device
    caches = Mdl.init_caches(cfg, prompts.shape[0], max_len,
                             served.get("cache_dtype", torch.float32),
                             device=dev)
    logits, caches, _ = Mdl.forward(cfg, params, torch.as_tensor(
        prompts, device=dev), mode="prefill", caches=caches,
        vision_embeds=vis)
    first = logits.argmax(-1)

    def decode():
        x = first
        for i in range(steps):
            lg, _ = Mdl.forward(cfg, params, x[:, None], mode="decode",
                                caches=caches, pos=start + i)
            x = lg.argmax(-1)

    return decode


def train_counted(tag: str, cfg, n_batches: int, key: str, counts: dict,
                  card: str, dev, b: int, s: int) -> tuple:
    """The start of a training phase at full width: ``cfg``'s train state
    (AdamW, remat, fp32 with TF32 off) and ``n_batches`` global batches of
    b x s of the port's Markov data on the card; after a warm-up pass,
    check (d): one counted ``train_step`` whose K3 / K3b / K4 / K4b / K5 /
    K5b launches equal ``expected_train_launches`` (kept in
    ``counts[key]``).  Returns (tc, state, batches)."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import upload
    from repro_torch.models.convert import flatten
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import AdamWConfig

    tc = TT.TrainConfig(optimizer=AdamWConfig(lr=3e-3, weight_decay=0.1),
                        remat=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                                  mean_doc_len=s / 2))
    batches = [{k: upload(v, dev) for k, v in data.batch(i).items()}
               for i in range(n_batches)]
    torch.cuda.reset_peak_memory_stats()
    state = TT.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    n_params = sum(p.numel() for p in flatten(state.params).values())
    TT.loss_and_grads(cfg, tc, state.params, batches[0])        # warm-up
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    m = TT.train_step(cfg, tc, state, batches[0])[1]
    loss0 = float(m["loss"])
    step_s = time.perf_counter() - t0
    counts[key] = got = lm_launches()
    want = expected_train_launches(cfg)
    log(f"  {tag} {cfg.name}, {cfg.n_layers} layers, {n_params} parameters "
        f"(fp32), batch {b} x {s}, remat: step loss {loss0:.6f} (ce "
        f"{float(m['ce']):.6f}, aux {float(m['aux']):.6f}), grad norm "
        f"{float(m['grad_norm']):.6f}, {step_s:.3f} s; (d) launches {got} "
        f"(expected {want}) [{card}]")
    if got != want:
        raise AssertionError(f"{tag} launches {got} != {want}")
    return tc, state, batches


def train_checks(tag: str, cfg, tc, params, batch, watch=None,
                 leaf_gate=None) -> list:
    """Checks (a)-(c) of a training phase on the card at ``params``: (a)
    the kernels' loss and grad norm against the plain path's within rel
    1e-5, every leaf's max |dg| <= 1e-4 x max |g_plain| and every leaf's
    gradient nonzero; (c) two passes bitwise; (b) remat off bitwise remat
    on.  ``watch`` (a context manager) records each of the two passes of
    (a); ``leaf_gate(seen_kernels, seen_plain)`` says whether the leaf
    check applies and what to log beside it (the MoE phase's routing
    flips).  Returns the gradient leaves' names."""
    import dataclasses

    import torch

    from repro_torch.models.convert import flatten
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import global_norm

    watch = watch or contextlib.nullcontext
    with watch() as seen_k:
        lk, mk, gk = TT.loss_and_grads(cfg, tc, params, batch)
    with watch() as seen_r:
        lr_, mr, gr = TT.loss_and_grads(cfg, tc, params, batch, impl="ref")
    apply, note = leaf_gate(seen_k, seen_r) if leaf_gate else (True, "")
    del seen_k, seen_r
    nk, nr = float(global_norm(gk)), float(global_norm(gr))
    fk, fr = flatten(gk), flatten(gr)
    worst = max((float((fk[n] - fr[n]).abs().max())
                 / max(float(fr[n].abs().max()), 1e-30), n) for n in fr)
    log(f"  {tag} (a) kernels vs plain on the card: loss {float(lk):.7f} vs "
        f"{float(lr_):.7f}, aux {float(mk['aux']):.7f} vs "
        f"{float(mr['aux']):.7f}, grad norm {nk:.7f} vs {nr:.7f}, worst "
        f"leaf max |dg| / max |g| {worst[0]:.3g} ({worst[1]}){note}")
    if abs(float(lk) - float(lr_)) > 1e-5 * abs(float(lr_)):
        raise AssertionError(f"{tag} (a) loss: kernels vs plain beyond rel "
                             f"1e-5")
    if abs(nk - nr) > 1e-5 * nr:
        raise AssertionError(f"{tag} (a) grad norm: kernels vs plain beyond "
                             f"rel 1e-5")
    if apply and worst[0] > 1e-4:
        raise AssertionError(f"{tag} (a) leaf {worst[1]}: max |dg| beyond "
                             f"1e-4 x max |g|")
    if not apply:
        log(f"  {tag} (a) worst-leaf check not applied: the two passes "
            f"took other paths")
    dead = [n for n, g in fk.items() if not bool(g.any())]
    if dead:
        raise AssertionError(f"{tag} (a) no gradient reaches {dead[:8]}")
    del gr, fr
    _, _, g2 = TT.loss_and_grads(cfg, tc, params, batch)
    twice = all(torch.equal(x, y) for x, y in zip(fk.values(),
                                                  flatten(g2).values()))
    del g2
    ln, _, gn = TT.loss_and_grads(cfg, dataclasses.replace(tc, remat=False),
                                  params, batch)
    no_remat = torch.equal(ln, lk) and all(
        torch.equal(x, y) for x, y in zip(fk.values(), flatten(gn).values()))
    names = list(fk)
    del gn, gk, fk
    log(f"  {tag} (c) two passes bitwise: {twice}; (b) remat off bitwise "
        f"remat on: {no_remat}; every leaf's gradient nonzero ({len(names)} "
        f"leaves)")
    if not twice:
        raise AssertionError(f"{tag} (c) two backward passes differ")
    if not no_remat:
        raise AssertionError(f"{tag} (b) remat changes the loss or "
                             f"gradients")
    return names


def phase_moe_train(counts: dict, card: str, dev) -> None:
    """(m-d) Training through the dispatch: moonshot-v1-16b-a3b at full
    width, 2 layers, global batch 4 x 1024 of the port's Markov data,
    remat, fp32 (TF32 off).  ``train_counted``'s one counted
    ``train_step`` (K3 / K3b / K4 / K4b launches held to the layer
    pattern) and ``train_checks``: the kernels' loss and grad norm against
    the plain path's within rel 1e-5, every leaf's gradient nonzero
    (router, experts, shared expert among them), and, where both paths
    dispatched every token alike (no near-tie routing flip), every leaf's
    max |dg| <= 1e-4 x max |g_plain|, as training check (a); two passes
    bitwise; remat off bitwise remat on."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(MOE["arch"]),
                              n_layers=MOE["train_layers"])
    tc, state, batches = train_counted(
        "(m-d)", cfg, 1, "moe_train", counts, card, dev, MOE["train_batch"],
        MOE["train_seq"])

    def same_dispatch(probs_k, probs_r) -> tuple:
        flips, diff = other_dispatch(probs_k, probs_r, cfg)
        return diff == 0, (f"; {flips} tokens routed to other experts, "
                           f"{diff} with other dispatch, over the MoE calls "
                           f"of the pass")

    names = train_checks("(m-d)", cfg, tc, state.params, batches[0],
                         watch=router_probs, leaf_gate=same_dispatch)
    log(f"  (m-d) leaves of the router and experts among them: "
        f"{sorted(n for n in names if '/moe/' in n or 'shared' in n)[:3]} "
        f"...; peak {torch.cuda.max_memory_allocated()} B")


SSM = dict(archs=("falcon-mamba-7b", "zamba2-7b"), batch=8, prompt_len=1024,
           max_new=32, max_len=1056, layer_batch=2, layer_seq=256,
           check_batch=2, check_prompt=128, check_steps=128,
           peak_limit=80e9)
# exp on the special-function units: 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x the H100 SXM's 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9


# K5b's first design (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6) at falcon's
# training layer, printed beside the measured time for reference
K5B_FIRST_MS = 3.3571


def scan_bwd_bound(shape: tuple, ch: int) -> dict:
    """K5b's least time at (B, S, d, N), gated: the backward's own work --
    dt, x, z, dout, B_t, C_t, A, D and h0 read once, ddt, dx, dz, dB, dC,
    dA, dD and dh0 written once (no dh_last: training passes none); one
    exp per (b, t, c, n) (the decay) and the sigmoid's per (b, t, c) on
    the SFUs; ~22 fp32 FLOP per (b, t, c, n) (an FMA = 2: the state
    stepped forward, C . h, the reverse step and the five sums).  Beside
    it, what this design adds: the saved states read and the dB / dC
    partials of ``ch``-channel blocks written, and the decay taken
    twice."""
    b, s, d, n = shape
    elems, rows = float(b * s * d * n), float(b * s * d)
    nbytes = 4.0 * (7 * rows + 4 * b * s * n + 2 * d * n + 2 * d
                    + 2 * b * d * n)
    design = 4.0 * (b * -(-s // 16) * d * n + 2 * b * s * -(-d // ch) * n)
    fp32_ms = 22.0 * elems / FLOP_PER_S * 1e3
    sfu_ms = (elems + rows) / SFU_PER_S * 1e3
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    ops_ms = max(fp32_ms, sfu_ms)
    return dict(
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        bound_ms_bytes=bytes_ms, bound_ms_fp32=fp32_ms, bound_ms_exp=sfu_ms,
        design_bytes_ms=(nbytes + design) / BYTES_PER_S * 1e3,
        design_exp_ms=(2.0 * elems + rows) / SFU_PER_S * 1e3,
        bytes=nbytes, design_bytes=nbytes + design)


def rel_close(what: str, got, want, tol: float = 1e-5) -> float:
    """Fail unless ``got`` is finite and max |got - want| <= tol x
    max |want|; returns max |diff|."""
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float().to(got.device)
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    err = float((g - w).abs().max())
    top = float(w.abs().max())
    if not bool(torch.isfinite(g).all()) or err > tol * top:
        raise AssertionError(f"{what}: max |diff| {err} beyond {tol} x max "
                             f"|want| {top}")
    log(f"  {what}: max |diff| {err:.3g} = {err / top:.3g} x max |want| "
        f"{top:.4g}")
    return err


def scan_inputs(shape: tuple, seed: int, dev) -> tuple:
    """K5's inputs at (B, S, d, N), made on the card from a torch Generator:
    dt = softplus(N(0, 1) - 4.6) (the layers' dt_b: dt ~ 0.01), x, B_t,
    C_t and a nonzero h0 unit normals, A = -(1..N) per channel (the Mamba1
    init's -exp(A_log))."""
    import torch
    import torch.nn.functional as F

    b, s, d, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=gen, device=dev)

    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return (F.softplus(randn(b, s, d) - 4.6), randn(b, s, d), randn(b, s, n),
            randn(b, s, n), a.expand(d, n).contiguous(), randn(b, d, n))


def gate_inputs(ins: tuple, seed: int) -> tuple:
    """Mamba1's D (d,) and z (B, S, d) for K5's gated mode beside
    ``scan_inputs``: unit normals from a torch Generator on the card."""
    import torch

    b, s, d = ins[0].shape
    gen = torch.Generator(device=ins[0].device).manual_seed(seed + 100)
    return (torch.randn(d, generator=gen, device=ins[0].device),
            torch.randn((b, s, d), generator=gen, device=ins[0].device))


def ssm_layer_card_vs_cpu(cfg, tag: str, dev, errs: dict) -> None:
    """(x-a) One SSM layer at full width, B = 2, S = 256, weights from a
    torch Generator seeded 1 carried to the CPU, input unit normals from
    numpy default_rng(1): the card (Mamba1 through K5, Mamba2 through K3's
    gate norm) against the CPU port (the plain versions), the output, the
    conv state and the SSM state within 1e-5 x max |want|.  falcon adds K5
    against its plain versions on the card with a nonzero h0: scan-only and
    gated at the prefill's (8, 1024, 8192, 16), gated at decode's (8, 1,
    8192, 16); zamba2 one shared attention call (K4 at D = 112
    against the CPU's plain attention), within the same bound."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.selective_scan import kernel as ss
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_gated_ref, selective_scan_ref)
    from repro_torch.models import layers, mamba

    m1 = cfg.ssm_kind == "mamba1"
    init = mamba.init_mamba1 if m1 else mamba.init_mamba2
    apply = mamba.mamba1_apply if m1 else mamba.mamba2_apply
    p = init(torch.Generator(device=dev).manual_seed(1), cfg, torch.float32,
             dev)
    x = np.random.default_rng(1).normal(
        0, 1, (SSM["layer_batch"], SSM["layer_seq"], cfg.d_model)) \
        .astype(np.float32)
    before = ss.launches["selective_scan"]
    got = apply(p, torch.from_numpy(x).to(dev), cfg)
    launched = ss.launches["selective_scan"] - before
    t0 = time.perf_counter()
    want = apply({k: v.cpu() for k, v in p.items()}, torch.from_numpy(x), cfg)
    cpu_s = time.perf_counter() - t0
    what = f"({tag}-a) {cfg.ssm_kind} layer {tuple(x.shape)} card vs CPU"
    for w, g, ww in (("y", got[0], want[0]),
                     ("conv state", got[1][0], want[1][0]),
                     ("SSM state", got[1][1], want[1][1])):
        rel_close(f"{what} {w}", g, ww)
    log(f"  {what}: K5 launches {launched}, CPU {cpu_s:.2f} s")
    if launched != int(m1):
        raise AssertionError(f"{what}: {launched} K5 launches")
    del p, got
    if m1:
        for s, seed in ((SSM["prompt_len"], 2), (1, 3)):
            ins = scan_inputs((SSM["batch"], s, cfg.d_inner, cfg.ssm_state),
                              seed, dev)
            gate = gate_inputs(ins, seed)
            runs = [("gated", ss.selective_scan(*ins, *gate),
                     selective_scan_gated_ref(*ins, *gate))]
            if s > 1:
                runs.append(("scan-only", ss.selective_scan(*ins),
                             selective_scan_ref(*ins)))
            for mode, got, want in runs:
                errs["selective_scan"] = max(errs.get("selective_scan", 0.0),
                                             max(rel_close(
                    f"({tag}-a) K5 {mode} {tuple(ins[0].shape)} N="
                    f"{cfg.ssm_state}, nonzero h0, vs plain {w}", g, ww)
                    for w, g, ww in zip(("y", "h_last"), got, want)))
        return
    ap = layers.init_attention(torch.Generator(device=dev).manual_seed(3),
                               cfg, torch.float32, dev)
    pos = torch.arange(SSM["layer_seq"], dtype=torch.int32)
    before = fa.launches["flash_attention"]
    out, _ = layers.attention_apply(ap, torch.from_numpy(x).to(dev), cfg,
                                    positions=pos.to(dev), window=None)
    if fa.launches["flash_attention"] != before + 1:
        raise AssertionError(f"({tag}-a) the shared attention call did not "
                             f"run K4")
    outc, _ = layers.attention_apply({k: v.cpu() for k, v in ap.items()},
                                     torch.from_numpy(x), cfg, positions=pos,
                                     window=None)
    rel_close(
        f"({tag}-a) shared attention {tuple(x.shape)}, {cfg.n_heads} heads "
        f"of D = {cfg.hd}, card (K4) vs CPU", out, outc)


def phase_ssm(arch: str, counts: dict, errs: dict, card: str, dev) -> dict:
    """(f) / (z) The SSM serving paths: ``arch`` (falcon-mamba-7b: 64
    Mamba1 layers; zamba2-7b: 81 Mamba2 layers and 13 calls of the shared
    attention block) at full width and full depth, fp32 with TF32 off,
    random weights from a torch.Generator seeded 0, 8 prompts of 1024
    tokens from numpy default_rng(0), 32 new tokens, greedy.  (x-a) one
    layer card vs CPU (``ssm_layer_card_vs_cpu``); (x-b) ``generate``: its
    K3 / K4 / K5 launches equal to ``expected_lm_launches``, peak memory
    under 80 GB, tokens in range; (x-c) the prefill's last-position logits
    through the kernels against ``impl="ref"`` on the card within rtol =
    atol = 1e-4, and generate's first tokens their argmax; (x-d) prefill of
    128 tokens and 128 decode steps against the train-mode forward over
    the 256 tokens (B = 2, teacher-forced), every position's logits within
    the reference's 2e-3 (``tests/test_models.py``).  Returns what (x-f)
    profiles."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as Mdl

    cfg = get_arch(arch)
    key = arch.split("-")[0]
    tag = key[0]
    b, plen, new, max_len = (SSM[k] for k in
                             ("batch", "prompt_len", "max_new", "max_len"))
    held = torch.cuda.memory_allocated()
    gc.collect()
    log(f"  memory_allocated at the start of the phase: {held} B, "
        f"{torch.cuda.memory_allocated()} B after a cyclic collection "
        f"[{card}]")
    with torch.no_grad():
        ssm_layer_card_vs_cpu(cfg, tag, dev, errs)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Mdl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {Mdl.param_count(params)} parameters (fp32, all "
        f"{cfg.n_layers} layers) made on the card in "
        f"{time.perf_counter() - t0:.2f} s; memory_allocated "
        f"{torch.cuda.memory_allocated()} B")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(b, plen))
    t0 = time.perf_counter()
    generate(cfg, params, prompts, 3, max_len)     # warm-up, not counted
    log(f"  warm-up generate (prefill + 2 decode steps): "
        f"{time.perf_counter() - t0:.2f} s")

    # (x-b) the counted run
    reset_all_launches()
    tokens, t = generate(cfg, params, prompts, new, max_len)
    counts[f"{key}_serve"] = got = lm_launches()
    want = expected_lm_launches(cfg, new)
    peak = torch.cuda.max_memory_allocated()
    log(f"  ({tag}-b) generate: prefill {t['prefill_s']:.4f} s "
        f"({b * plen / t['prefill_s']:.1f} tok/s), decode {t['decode_s']:.4f}"
        f" s for {new - 1} steps ({b * (new - 1) / t['decode_s']:.1f} tok/s,"
        f" {t['decode_s'] / (new - 1) * 1e3:.2f} ms a step); launches {got} "
        f"(expected {want}); max_memory_allocated {peak} B [{card}]")
    if got != want:
        raise AssertionError(f"({tag}-b) launches {got} != {want}")
    if peak >= SSM["peak_limit"]:
        raise AssertionError(f"({tag}-b) peak {peak} B is not under 80 GB")
    tok = tokens.cpu().numpy()
    if tok.shape != (b, new) or tok.min() < 0 or tok.max() >= cfg.vocab:
        raise AssertionError(f"({tag}-b) bad tokens: {tok.shape} "
                             f"{tok.min()} {tok.max()}")
    log(f"  first request continuation: {tok[0][:16].tolist()}")

    # (x-c) the prefill's logits, kernels against plain
    toks = torch.as_tensor(prompts, device=dev)

    def prefill(impl):
        caches = Mdl.init_caches(cfg, b, max_len, device=dev)
        return Mdl.forward(cfg, params, toks, mode="prefill", caches=caches,
                           impl=impl)[0]

    kern = prefill("flash")
    t0 = time.perf_counter()
    plain = prefill("ref")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = float((kern - plain).abs().max())
    log(f"  ({tag}-c) prefill logits ({b} x {plen}), kernels vs plain on the "
        f"card: max |diff| {err:.3g} (max |logit| "
        f"{float(plain.abs().max()):.4g}); the plain prefill took "
        f"{plain_s:.2f} s")
    if not bool(torch.isfinite(kern).all()) or not torch.allclose(
            kern, plain, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"({tag}-c) prefill logits: kernels vs plain "
                             f"max |diff| {err} beyond rtol = atol = 1e-4")
    if not torch.equal(kern.argmax(-1).cpu(), tokens[:, 0].cpu()):
        raise AssertionError(f"({tag}-b) generate's first tokens are not the "
                             f"argmax of the kernel path's prefill logits")
    del kern, plain

    # (x-d) decode against the train-mode forward
    cb, cp, cs = (SSM[k] for k in ("check_batch", "check_prompt",
                                   "check_steps"))
    seq = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab, size=(cb, cp + cs)), device=dev)
    with torch.no_grad():
        full, _ = Mdl.forward(cfg, params, seq, mode="train")
        caches = Mdl.init_caches(cfg, cb, cp + cs, device=dev)
        lp, caches, _ = Mdl.forward(cfg, params, seq[:, :cp], mode="prefill",
                                    caches=caches)
        diffs = [(lp - full[:, cp - 1]).abs().max()]
        for i in range(cp, cp + cs):
            ld, caches = Mdl.forward(cfg, params, seq[:, i:i + 1],
                                     mode="decode", caches=caches, pos=i)
            diffs.append((ld - full[:, i]).abs().max())
    worst = float(torch.stack(diffs).max())
    log(f"  ({tag}-d) prefill {cp} + {cs} decode steps vs the train forward "
        f"over {cp + cs} tokens (B = {cb}): max |dlogit| {worst:.3g} (max "
        f"|logit| {float(full.abs().max()):.4g}; the reference's bound 2e-3)")
    if not worst < 2e-3:
        raise AssertionError(f"({tag}-d) decode vs train forward max "
                             f"|dlogit| {worst} not under 2e-3")
    del full, caches
    return {"cfg": cfg, "params": params, "prompts": prompts}


def phase_ssm_train(arch: str, counts: dict, card: str, dev) -> dict:
    """(f-t) / (z-t) Training an SSM family at full width: falcon-mamba-7b
    cut to 4 of its 64 layers (K5 / K5b, K3 / K3b), zamba2-7b to 6 of its
    81 (one layer pattern and one shared attention call: K3 / K3b at d =
    3584 and the 7168-wide gate norm, K4 with L / K4b at D = 112); global
    batch 4 x 1024 of the port's Markov data, remat, fp32 with TF32 off,
    AdamW.  (d) ``train_counted``'s counted ``train_step``; (a)-(c)
    ``train_checks``; (e) after one untimed step, the wall of each of
    ``SSM_TRAIN["steps"]`` more steps, their median and mean, tok/s and
    peak memory, each step's loss and grad norm finite.  Returns what one
    profiled step needs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.train import train_step as TT

    cfg = dataclasses.replace(get_arch(arch),
                              n_layers=SSM_TRAIN["layers"][arch])
    tag = f"({arch[0]}-t)"
    b, s, steps = SSM_TRAIN["batch"], SSM_TRAIN["seq"], SSM_TRAIN["steps"]
    tc, state, batches = train_counted(
        tag, cfg, steps + 1, f"{arch.split('-')[0]}_train", counts, card,
        dev, b, s)
    train_checks(tag, cfg, tc, state.params, batches[0])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    st = TT.train_step(cfg, tc, state, batches[0])[0]     # untimed, warm
    walls = []
    for i in range(1, steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = TT.train_step(cfg, tc, st, batches[i])
        loss = float(m["loss"])
        walls.append(time.perf_counter() - t0)
        gnorm = float(m["grad_norm"])
        log(f"  {tag} step {i}: loss {loss:.6f} gnorm {gnorm:.4f} "
            f"{walls[-1] * 1e3:.1f} ms")
        if not np.isfinite([loss, gnorm]).all():
            raise AssertionError(f"{tag} step {i}: loss {loss}, grad norm "
                                 f"{gnorm}")
    ms = float(np.median(walls)) * 1e3
    mean = sum(walls) / len(walls) * 1e3
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    log(f"  {tag} (e) train step: {ms:.1f} ms median of {len(walls)} after "
        f"one untimed (mean {mean:.1f}, min {min(walls) * 1e3:.1f}, max "
        f"{max(walls) * 1e3:.1f}), {b * s / ms * 1e3:.1f} tok/s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"allocator retries {retries} [{card}]")
    return {"cfg": cfg, "tc": tc, "state": st, "batch": batches[0]}


FRONTEND = dict(archs=("pixtral-12b", "musicgen-large"), batch=8,
                prompt_len=1024, max_new=32, layer_batch=2, layer_seq=256,
                layer_steps=2, fp8_steps=8, byte_layers=(0, 13, 26, 39),
                peak_limit=80e9)


def frontend_layer_card_vs_cpu(cfg, tag: str, dev) -> None:
    """(v-a) / (u-a) One attention + MLP layer at full width, B = 2, S =
    256, weights from a torch Generator seeded 1 carried to the CPU, input
    unit normals from numpy default_rng(1): prefill into an fp32 cache,
    then 2 decode steps, on the card (K3, K4, K6) and on the CPU port (the
    plain versions): every output within 1e-5 x max |want| (``rel_close``),
    the caches within 1e-4 x (K is rotated by RoPE at angles up to 258
    rad, where the card's and the CPU's sin / cos differ by a few fp32
    ulps of the angle: 1.25e-5 x measured on pixtral's K)."""
    import torch

    from repro_torch.models import model as Mdl

    kind = Mdl.layer_kind(cfg, 0)
    lp = Mdl._init_layer(cfg, kind, torch.Generator(device=dev).manual_seed(1),
                         torch.float32, dev)
    lb, ls, steps = (FRONTEND[k] for k in ("layer_batch", "layer_seq",
                                           "layer_steps"))
    x = np.random.default_rng(1).normal(0, 1, (lb, ls + steps, cfg.d_model)) \
        .astype(np.float32)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    def run(params, device):
        cache = {k: torch.zeros((lb, cfg.n_kv_heads, ls + steps, cfg.hd),
                                device=device) for k in ("k", "v")}
        xs = torch.from_numpy(x).to(device)
        outs = [Mdl._attn_mlp_layer(
            cfg, kind, params, xs[:, :ls], mode="prefill", cache=cache,
            cache_pos=None, impl="flash",
            positions=torch.arange(ls, dtype=torch.int32, device=device))[0]]
        for i in range(ls, ls + steps):
            outs.append(Mdl._attn_mlp_layer(
                cfg, kind, params, xs[:, i:i + 1], mode="decode",
                cache=cache, cache_pos=i, impl="flash",
                positions=torch.tensor([i], dtype=torch.int32,
                                       device=device))[0])
        return outs + [cache["k"], cache["v"]]

    t0 = time.perf_counter()
    got = run(lp, dev)
    want = run(to_cpu(lp), torch.device("cpu"))
    what = (f"({tag}-a) {cfg.name} layer, prefill ({lb}, {ls}) + {steps} "
            f"decode steps, card vs CPU")
    for i, (g, w) in enumerate(zip(got, want)):
        label = ("prefill" if i == 0 else f"decode {i}" if i <= steps
                 else ("K cache", "V cache")[i - steps - 1])
        rel_close(f"{what} {label}", g, w, 1e-5 if i <= steps else 1e-4)
    log(f"  {what}: {time.perf_counter() - t0:.2f} s")


def phase_frontend(arch: str, counts: dict, errs: dict, card: str,
                   dev) -> dict:
    """(v) / (u) The frontend families' serving path at full width and
    depth, fp32 with TF32 off, random weights from a torch.Generator seeded
    0, 8 prompts of 1024 tokens from numpy default_rng(0), 32 new tokens,
    greedy: pixtral-12b (40 layers, d 5120, the vision stub: 256 patch
    embeddings a request, ``serve.patch_embeddings``) on an fp32 and an
    fp8 cache, musicgen-large (48 layers, d 2048, D = 64, GELU) on an fp32
    cache.  (x-a) ``frontend_layer_card_vs_cpu``; (x-b) ``generate`` on
    each cache dtype: its K3 / K4 / K6 launches equal to
    ``expected_lm_launches``, peak memory under 80 GB, tokens in range;
    (x-c) the prefill's last-position logits through the kernels against
    ``impl="ref"`` on the card within rtol = atol = 1e-4, and generate's
    first tokens their argmax.  pixtral also: (v-8) the fp8 cache bytes the
    card's prefill wrote, in 4 layers, bitwise the CPU helper's cast of a
    copy of the fp32 cache the same prefill wrote; K6 on that fp8 cache
    against its plain twin (1e-5 x max |want|, two calls bitwise); (v-d) 8
    decode steps teacher-forced on both caches: the fp8 cache's logits
    within the reference's bound of the fp32 cache's (max |dlogit| < 0.7,
    mean < 0.1, ``tests/test_models.py``).  Returns what (v-f) profiles."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.launch.serve import generate, patch_embeddings
    from repro_torch.models import model as Mdl
    from repro_torch.models.layers import to_cache_dtype

    cfg = get_arch(arch)
    key = arch.split("-")[0]
    tag = "v" if cfg.frontend == "vision" else "u"
    b, plen, new = (FRONTEND[k] for k in ("batch", "prompt_len", "max_new"))
    n_vis = cfg.n_patches if cfg.frontend == "vision" else 0
    max_len = n_vis + plen + new
    held = torch.cuda.memory_allocated()
    gc.collect()
    log(f"  memory_allocated at the start of the phase: {held} B, "
        f"{torch.cuda.memory_allocated()} B after a cyclic collection "
        f"[{card}]")
    with torch.no_grad():
        frontend_layer_card_vs_cpu(cfg, tag, dev)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Mdl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {Mdl.param_count(params)} parameters (fp32, all "
        f"{cfg.n_layers} layers) made on the card in "
        f"{time.perf_counter() - t0:.2f} s; memory_allocated "
        f"{torch.cuda.memory_allocated()} B")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(b, plen))
    vis = patch_embeddings(cfg, b, dev) if n_vis else None
    dtypes = (torch.float32, torch.float8_e4m3fn) if n_vis else \
        (torch.float32,)
    t0 = time.perf_counter()
    generate(cfg, params, prompts, 3, max_len, vision_embeds=vis,
             cache_dtype=dtypes[-1])               # warm-up, not counted
    log(f"  warm-up generate (prefill + 2 decode steps): "
        f"{time.perf_counter() - t0:.2f} s")

    # (x-b) the counted runs
    first = None
    for cdt in dtypes:
        name = str(cdt)[6:]
        slot = f"{key}_serve" + ("_fp8" if cdt != torch.float32 else "")
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        tokens, t = generate(cfg, params, prompts, new, max_len,
                             vision_embeds=vis, cache_dtype=cdt)
        counts[slot] = got = lm_launches()
        want = expected_lm_launches(cfg, new)
        peak = torch.cuda.max_memory_allocated()
        log(f"  ({tag}-b) generate, {name} cache, {n_vis} patches + {plen} "
            f"tokens a request: prefill {t['prefill_s']:.4f} s "
            f"({b * (n_vis + plen) / t['prefill_s']:.1f} tok/s), decode "
            f"{t['decode_s']:.4f} s for {new - 1} steps "
            f"({b * (new - 1) / t['decode_s']:.1f} tok/s, "
            f"{t['decode_s'] / (new - 1) * 1e3:.2f} ms a step); launches "
            f"{got} (expected {want}); max_memory_allocated {peak} B [{card}]")
        if got != want:
            raise AssertionError(f"({tag}-b) launches {got} != {want}")
        if peak >= FRONTEND["peak_limit"]:
            raise AssertionError(f"({tag}-b) peak {peak} B is not under "
                                 f"80 GB")
        tok = tokens.cpu().numpy()
        if tok.shape != (b, new) or tok.min() < 0 or tok.max() >= cfg.vocab:
            raise AssertionError(f"({tag}-b) bad tokens: {tok.shape} "
                                 f"{tok.min()} {tok.max()}")
        log(f"  first request continuation: {tok[0][:16].tolist()}")
        if first is None:
            first = tokens

    # (x-c) the prefill's logits, kernels against plain
    toks = torch.as_tensor(prompts, device=dev)

    def prefill(impl, cdt=torch.float32):
        caches = Mdl.init_caches(cfg, b, max_len, cdt, device=dev)
        logits, caches, _ = Mdl.forward(cfg, params, toks, mode="prefill",
                                        caches=caches, impl=impl,
                                        vision_embeds=vis)
        return logits, caches

    kern, caches32 = prefill("flash")
    t0 = time.perf_counter()
    plain, _ = prefill("ref")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = float((kern - plain).abs().max())
    log(f"  ({tag}-c) prefill logits ({b} x {n_vis + plen}), kernels vs "
        f"plain on the card: max |diff| {err:.3g} (max |logit| "
        f"{float(plain.abs().max()):.4g}); the plain prefill took "
        f"{plain_s:.2f} s")
    if not bool(torch.isfinite(kern).all()) or not torch.allclose(
            kern, plain, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"({tag}-c) prefill logits: kernels vs plain "
                             f"max |diff| {err} beyond rtol = atol = 1e-4")
    if not torch.equal(kern.argmax(-1).cpu(), first[:, 0].cpu()):
        raise AssertionError(f"({tag}-b) generate's first tokens are not the "
                             f"argmax of the kernel path's prefill logits")
    errs[f"{key}_logits"] = err
    del plain
    served = {"cfg": cfg, "params": params, "prompts": prompts,
              "vision": vis, "cache_dtype": dtypes[-1], "max_len": max_len}
    if not n_vis:
        return served

    # (v-8) the fp8 cache bytes the card wrote against the CPU helper's
    kern8, caches8 = prefill("flash", torch.float8_e4m3fn)
    log(f"  (v-8) the fp8-cache prefill's logits bitwise the fp32-cache "
        f"prefill's: {bool(torch.equal(kern8, kern))}")
    per = Mdl.pattern_period(cfg)
    checked = 0
    for layer in FRONTEND["byte_layers"]:
        c32 = caches32["blocks"][f"pos{layer % per}"]
        c8 = caches8["blocks"][f"pos{layer % per}"]
        for kv in ("k", "v"):
            want = to_cache_dtype(c32[kv][layer // per].cpu(),
                                  torch.float8_e4m3fn).view(torch.uint8)
            got = c8[kv][layer // per].cpu().view(torch.uint8)
            if not torch.equal(got, want):
                n_bad = int((got != want).sum())
                raise AssertionError(f"(v-8) layer {layer} {kv}: {n_bad} fp8 "
                                     f"bytes differ from the CPU cast")
            checked += got.numel()
    log(f"  (v-8) fp8 cache bytes of layers {FRONTEND['byte_layers']} (K and "
        f"V, {checked} bytes) bitwise the CPU helper's cast of the fp32 "
        f"cache")
    # K6 on that fp8 cache against its plain twin
    c8 = caches8["blocks"]["pos0"]
    q = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (b, cfg.n_heads, 1, cfg.hd)).astype(np.float32)).to(dev)
    pos = n_vis + plen - 1
    got = da.decode_attention(q, c8["k"][0], c8["v"][0], pos)
    if not torch.equal(got, da.decode_attention(q, c8["k"][0], c8["v"][0],
                                                pos)):
        raise AssertionError("(v-8) K6 on the fp8 cache: two calls differ")
    errs["decode_attention_fp8"] = max(errs["decode_attention_fp8"], rel_close(
        f"(v-8) K6 on layer 0's fp8 cache (B {b}, Hkv {cfg.n_kv_heads}, S "
        f"{max_len}, D {cfg.hd}) at pos {pos} vs its plain twin", got,
        decode_attention_ref(q, c8["k"][0], c8["v"][0], pos)))

    # (v-d) decode on the fp8 cache against the fp32 cache
    steps = FRONTEND["fp8_steps"]
    diffs, means = [], []
    with torch.no_grad():
        for i in range(steps):
            x = first[:, i:i + 1]
            l32, caches32 = Mdl.forward(cfg, params, x, mode="decode",
                                        caches=caches32, pos=n_vis + plen + i)
            l8, caches8 = Mdl.forward(cfg, params, x, mode="decode",
                                      caches=caches8, pos=n_vis + plen + i)
            diffs.append(float((l8 - l32).abs().max()))
            means.append(float((l8 - l32).abs().mean()))
    log(f"  (v-d) {steps} decode steps teacher-forced, fp8 cache vs fp32 "
        f"cache: max |dlogit| by step {[round(d, 5) for d in diffs]}, mean "
        f"|dlogit| by step {[round(m, 6) for m in means]} (max |logit| "
        f"{float(l32.abs().max()):.4g}; the reference's bound: max < 0.7, "
        f"mean < 0.1)")
    if not (max(diffs) < 0.7 and max(means) < 0.1):
        raise AssertionError(f"(v-d) fp8 vs fp32 cache decode logits: max "
                             f"{max(diffs)}, mean {max(means)}: beyond the "
                             f"reference's bound (0.7, 0.1)")
    del caches32, caches8, kern, kern8
    return served


def phase_lm_timing(rng, counts: dict, errs: dict) -> list:
    """K4 and K3 at the served shapes (gemma3-1b's and, (m-e),
    moonshot's), K4 with L, K4b and K3b at the training shapes: ms per
    launch by CUDA events, the plain version's ms,
    the bound (fp32 FLOPs of the unmasked score pairs only; each input read
    once, each output written once; for K4b also the bound of the route it
    takes, three TF32 products a product on the tensor cores) and one
    PyTorch call computing the same function (``library_ms``, timed here
    and used nowhere in the port: SDPA, its forward + backward less its
    forward, and ``F.rms_norm`` and autograd's backward through it).
    Returns the kernels line's entries."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
    from repro_torch.configs import get_arch
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_bwd_ref, selective_scan_gated_ref, selective_scan_ref)
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import to_cache_dtype

    dev = torch.device("cuda")
    b, hq, hkv, t, d = SERVE["batch"], 4, 1, SERVE["prompt_len"], 256

    def rand(*shape, sd=1.0):
        return torch.from_numpy(rng.normal(0, sd, shape).astype(np.float32)) \
            .to(dev)

    def k4_bounds(pairs: float, dd: int, nbytes: float) -> dict:
        """K4's bound as fp32 FMAs on the CUDA cores and, beside it, as
        3xTF32 on the tensor cores (three TF32 products a product): 2 D
        multiply-adds a live score pair."""
        b_ms, b_by = flop_bound(4.0 * pairs * dd, nbytes)
        tc_ms, tc_by = flop_bound(12.0 * pairs * dd, nbytes, TF32_FLOP_PER_S)
        return dict(bound_ms=b_ms, bound_by=b_by, bound_ms_3xtf32=tc_ms,
                    bound_by_3xtf32=tc_by)

    q, k, v = rand(b, hq, t, d), rand(b, hkv, t, d), rand(b, hkv, t, d)
    pos = torch.arange(t, device=dev)
    k4 = {}
    for label, window in (("global", None), ("local", 512)):
        ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, window=window),
                     reps=20)
        plain = time_ms(lambda: attention_ref(q, k, v, window=window),
                        reps=3, warmup=1)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[:, None] - pos[None, :] < window

        def lib():
            if window is None:
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        lib_ms = time_ms(lib, reps=20)
        want = attention_ref(q, k, v, window=window)
        errs["flash_attention"] = max(errs["flash_attention"], check_close(
            f"K4 timed input, {label}", fa_ops.flash_attention(
                q, k, v, window=window), want, 2e-5))
        lib_err = float((lib() - want).abs().max())
        pairs = float(mask.sum()) * b * hq
        bnd = k4_bounds(pairs, d,
                        4.0 * (2 * q.numel() + k.numel() + v.numel()))
        k4[label] = dict(instance=fa_kernel.instance(d), ms=ms,
                         plain_ms=plain, library_ms=lib_ms, **bnd)
        log(f"  K4 {label} layer ({b},{hq},{t},{d}) Hkv {hkv} fp32, instance"
            f" {fa_kernel.instance(d)}: {ms:.4f} ms (plain {plain:.3f} ms, "
            f"SDPA {lib_ms:.4f} ms with max |diff| {lib_err:.3g} to plain, "
            f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} as fp32, "
            f"{bnd['bound_ms_3xtf32']:.4f} ms as 3xTF32)")

    # K4 at the other served prefill layers, through its tensor-core
    # instances: moonshot-v1-16b-a3b (m-e), zamba2-7b's shared block,
    # musicgen-large and pixtral-12b (GQA 4:1, 256 patches + 1024 tokens)
    for key, tag, heads, kv_heads, tt, dd in (
            ("moonshot_global", "moonshot global", 16, 16, t, 128),
            ("zamba2_shared", "zamba2 shared block", 32, 32, t, 112),
            ("musicgen", "musicgen", 32, 32, t, 64),
            ("pixtral", "pixtral", 32, 8, 1280, 128)):
        q = rand(b, heads, tt, dd)
        k, v = rand(b, kv_heads, tt, dd), rand(b, kv_heads, tt, dd)
        ms = time_ms(lambda: fa_ops.flash_attention(q, k, v), reps=20)
        plain = time_ms(lambda: attention_ref(q, k, v), reps=3, warmup=1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=heads != kv_heads), reps=20)
        want = attention_ref(q, k, v)
        errs["flash_attention"] = max(errs["flash_attention"], check_close(
            f"K4 timed input, {tag}", fa_ops.flash_attention(q, k, v), want,
            2e-5))
        pairs = tt * (tt + 1) / 2 * b * heads
        bnd = k4_bounds(pairs, dd, 4.0 * (2 * q.numel() + k.numel()
                                          + v.numel()))
        k4[key] = dict(
            shape=f"({b},{heads},{tt},{dd}) Hkv {kv_heads} fp32, causal "
                  f"(global)", instance=fa_kernel.instance(dd), ms=ms,
            plain_ms=plain, library_ms=lib_ms, **bnd)
        log(f"  K4 {tag} layer ({b},{heads},{tt},{dd}) Hkv {kv_heads} fp32,"
            f" instance {fa_kernel.instance(dd)}: {ms:.4f} ms (plain "
            f"{plain:.3f} ms, SDPA {lib_ms:.4f} ms, {ms / lib_ms:.3f}x; bound"
            f" {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} as fp32 on the "
            f"CUDA cores, {bnd['bound_ms_3xtf32']:.4f} ms as 3xTF32 on the "
            f"tensor cores: {bnd['bound_ms_3xtf32'] / ms:.1%})")
        del q, k, v, want

    # K6 at pixtral-12b's decode: q (8, 32, 1, 128), Hkv 8, every slot of
    # an S-slot cache live (pos = S - 1), in each cache dtype.  Bound: the
    # cache read once in its dtype, q read and the output written in fp32;
    # 4 FLOP per (query head, slot, element) of QK and PV.  SDPA (GQA, a
    # boolean mask of the live slots) reads the cache widened to fp32: the
    # widening is in its time.  Cold caches, as in serving, where every
    # layer reads its own: the timed calls (K6's and SDPA's) walk copies of
    # the cache in turn, more than 64 MB of them (the L2 holds 50 MB).
    k6 = {}
    pb, phq, phkv, pd = 8, 32, 8, 128
    q = rand(pb, phq, 1, pd)
    for cs in (1312, 8192):
        kv = rand(2, pb, phkv, cs, pd, sd=2.0)
        last = cs - 1
        live = torch.ones((1, 1, 1, cs), dtype=torch.bool, device=dev)
        for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
            kc, vc = (to_cache_dtype(x, dt) for x in kv)
            nbytes = 2.0 * kc.numel() * kc.element_size() \
                + 2.0 * 4 * q.numel()
            n_rot = max(2, -(-64_000_000 // int(nbytes)) + 1)
            copies = [(kc, vc)] + [(kc.clone(), vc.clone())
                                   for _ in range(n_rot - 1)]
            turn = itertools.cycle(copies)
            ms = time_ms(lambda: da_kernel.decode_attention(
                q, *next(turn), last), reps=50)
            plain = time_ms(lambda: decode_attention_ref(q, kc, vc, last),
                            reps=10)

            def lib():
                kk, vv = next(turn)
                return F.scaled_dot_product_attention(
                    q, kk.float(), vv.float(), attn_mask=live,
                    enable_gqa=True)

            lib_ms = time_ms(lib, reps=50)
            want = decode_attention_ref(q, kc, vc, last)
            name = str(dt)[6:]
            err = rel_close(f"K6 timed input, S {cs} {name}",
                            da_kernel.decode_attention(q, kc, vc, last), want)
            lib_err = float((lib() - want).abs().max())
            b_ms, b_by = flop_bound(4.0 * pb * phq * cs * pd, nbytes)
            label = f"S{cs}_{'fp8' if kc.element_size() == 1 else name}"
            warps, cluster = da_kernel.plan(kc)
            k6[label] = dict(
                shape=f"q ({pb},{phq},1,{pd}), cache ({pb},{phkv},{cs},{pd}) "
                      f"{name}, cold ({n_rot} copies in turn)", ms=ms,
                plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, warps=warps,
                cluster=cluster)
            log(f"  K6 pixtral decode, cache ({pb},{phkv},{cs},{pd}) {name}, "
                f"{warps} warps a CTA, clusters of {cluster}, "
                f"q ({pb},{phq},1,{pd}), cold (the timed calls walk "
                f"{n_rot} copies, {n_rot * nbytes / 1e6:.1f} MB): "
                f"{ms:.4f} ms (plain {plain:.4f} ms warm, SDPA on the cache "
                f"widened to fp32 {lib_ms:.4f} ms cold with max |diff| "
                f"{lib_err:.3g} to plain, bound {b_ms:.5f} ms by {b_by}; "
                f"{b_ms / ms:.1%} of the bound)")
            del kc, vc, copies, turn
        del kv
    del q

    # K6's partial form at (d-g1)'s global layer on one rank: q (8, 4, 1,
    # 256), the rank's 256 of 1024 fp32 slots (pos 1015: rank 3's block
    # 768..1023 holds 768..1015, 248 live; the kernel zero-fills the dead
    # slots without reading them).  Bound: the live slots' K / V read
    # once, q read, the output and the log-sum-exp written; 4 FLOP per
    # (query head, live slot, element).  SDPA on the rank's slots: the
    # same block, a boolean mask of its live slots, GQA (no log-sum-exp).
    # Cold, as K6's whole-cache timing: between two reads of one layer's
    # block a (d-g1) decode step reads 26 layers' blocks (~80 MB against a
    # 50 MB L2), so the timed calls (K6's and SDPA's) walk copies of the
    # block in turn, more than 64 MB of them.
    gb, ghq, ghkv, gd, gs, gpos = 8, 4, 1, 256, 1024, 1015
    n = gs // 4
    q = rand(gb, ghq, 1, gd)
    kv = rand(2, gb, ghkv, n, gd, sd=2.0)
    kc, vc = kv[0].contiguous(), kv[1].contiguous()
    slots = (3 * n, gs)
    idx = 3 * n + torch.arange(n, device=dev)
    live = (torch.remainder(gpos - idx, gs) <= gpos)[None, None, None, :]
    n_live = int(live.sum())
    block = 2.0 * kc.numel() * 4
    n_rot = max(2, -(-64_000_000 // int(block)) + 1)
    copies = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n_rot - 1)]
    turn = itertools.cycle(copies)
    ms = time_ms(lambda: da_kernel.decode_attention(
        q, *next(turn), gpos, slots=slots), reps=50)
    plain = time_ms(lambda: decode_attention_ref(q, kc, vc, gpos, None,
                                                 slots), reps=10)

    def lib():
        kk, vv = next(turn)
        return F.scaled_dot_product_attention(q, kk, vv, attn_mask=live,
                                              enable_gqa=True)

    lib_ms = time_ms(lib, reps=50)
    got, _ = da_kernel.decode_attention(q, kc, vc, gpos, slots=slots)
    want, _ = decode_attention_ref(q, kc, vc, gpos, None, slots)
    err = rel_close("K6 partial timed input", got, want)
    nbytes = 2.0 * 4 * gb * ghkv * n_live * gd + 4.0 * q.numel() * 2 \
        + 4.0 * gb * ghq
    b_ms, b_by = flop_bound(4.0 * gb * ghq * n_live * gd, nbytes)
    warps, cluster = da_kernel.plan(kc)
    k6p = dict(shape=f"q ({gb},{ghq},1,{gd}), a rank's block ({gb},{ghkv},"
                     f"{n},{gd}) fp32 of a {gs}-slot cache, {n_live} live, "
                     f"cold ({n_rot} copies in turn)",
               ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=err, warps=warps, cluster=cluster)
    log(f"  K6 partial, gemma3-1b's global layer on a rank: {k6p['shape']}, "
        f"{warps} warps a CTA, clusters of {cluster}, the timed calls walk "
        f"{n_rot * block / 1e6:.1f} MB: {ms:.4f} ms (plain {plain:.4f} ms "
        f"warm, SDPA on the rank's slots {lib_ms:.4f} ms cold, bound "
        f"{b_ms:.5f} ms by {b_by} ({nbytes:.0f} B); {b_ms / ms:.1%} of the "
        f"bound)")
    del q, kv, kc, vc, copies, turn

    # K5 at falcon-mamba-7b's prefill layer, scan-only and gated (what the
    # model runs), and the yardstick: scan-only K5 and the four torch passes
    # of the gate it replaced, timed in turns.  Bytes: dt and x read (and z),
    # y written, B_t / C_t, A (and D), h0 and h_last.  Operations: per (b,
    # t, c, n) one exp on the special-function units and dt*A, decay*h +
    # dx*B and the FMA of y (6 fp32 FLOP, an FMA = 2), plus dt*x per (b, t,
    # c); the gate adds one exp (the sigmoid's) and 5 FLOP per (b, t, c).
    # The operation floor is the slower of the two pipes.
    falcon = get_arch(SSM["archs"][0])
    shape = (SSM["batch"], SSM["prompt_len"], falcon.d_inner,
             falcon.ssm_state)
    ins = scan_inputs(shape, 4, dev)
    gate = gate_inputs(ins, 4)

    def yardstick():
        y, h_last = ss_kernel.selective_scan(*ins)
        y = y + gate[0] * ins[1]
        return y * F.silu(gate[1]), h_last

    runs = {"scan": lambda: ss_kernel.selective_scan(*ins),
            "gated": lambda: ss_kernel.selective_scan(*ins, *gate),
            "yardstick": yardstick}
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(time_ms(runs[k], reps=20))
    plain = {"scan": time_ms(lambda: selective_scan_ref(*ins), reps=3,
                             warmup=1),
             "gated": time_ms(lambda: selective_scan_gated_ref(*ins, *gate),
                              reps=3, warmup=1)}
    for mode, got, want in (
            ("scan-only", ss_kernel.selective_scan(*ins),
             selective_scan_ref(*ins)),
            ("gated", ss_kernel.selective_scan(*ins, *gate),
             selective_scan_gated_ref(*ins, *gate)),
            ("yardstick", yardstick(),
             selective_scan_gated_ref(*ins, *gate))):
        err = max(rel_close(f"K5 timed input, {mode} {w}", g, ww)
                  for w, g, ww in zip(("y", "h_last"), got, want))
        if mode != "yardstick":
            errs["selective_scan"] = max(errs["selective_scan"], err)
    sb, ss_, sd, sn = shape
    elems, rows = float(sb * ss_ * sd * sn), float(sb * ss_ * sd)
    k5 = {}
    for mode, tensors, gate_flops in (("scan", 3, 0), ("gated", 4, 5)):
        fp32_ms = (6.0 * elems + (1 + gate_flops) * rows) / FLOP_PER_S * 1e3
        sfu_ms = (elems + (rows if gate_flops else 0)) / SFU_PER_S * 1e3
        bytes_ms = 4.0 * (tensors * rows + 2 * sb * ss_ * sn + sd * sn
                          + (sd if gate_flops else 0) + 2 * sb * sd * sn) \
            / BYTES_PER_S * 1e3
        ms = sum(times[mode]) / len(times[mode])
        b_ms, b_by = (max(fp32_ms, sfu_ms), "operations") \
            if max(fp32_ms, sfu_ms) >= bytes_ms else (bytes_ms, "bytes")
        k5[mode] = dict(ms=ms, plain_ms=plain[mode], library_ms=None,
                        bound_ms=b_ms, bound_by=b_by, bound_ms_bytes=bytes_ms,
                        bound_ms_fp32=fp32_ms, bound_ms_exp=sfu_ms)
        log(f"  K5 {mode} falcon prefill layer {shape} fp32: {ms:.4f} ms "
            f"(runs {', '.join(f'{t:.4f}' for t in times[mode])}; plain "
            f"{plain[mode]:.3f} ms, no library call; bound {b_ms:.4f} ms by "
            f"{b_by}: exps {sfu_ms:.4f} ms on the SFUs, bytes "
            f"{bytes_ms:.4f} ms, fp32 {fp32_ms:.4f} ms; {b_ms / ms:.1%} of "
            f"the bound)")
    yard = sum(times["yardstick"]) / len(times["yardstick"])
    runs_s = ", ".join(f"{t:.4f}" for t in times["yardstick"])
    log(f"  K5 yardstick (scan-only K5 + the gate's four torch passes): "
        f"{yard:.4f} ms (runs {runs_s}); gated K5 "
        f"{k5['gated']['ms']:.4f} ms")
    del ins, gate

    k3 = {}
    for label, rows, dd in (("residual", b * t, 1152),
                            ("q_norm", b * t * hq, d),
                            ("decode_residual", b, 1152),
                            ("decode_q_norm", b * hq, d),
                            ("moonshot_residual", b * t, 2048),
                            ("moonshot_decode_residual", b, 2048),
                            ("falcon_residual", b * t, 4096),
                            ("falcon_decode_residual", b, 4096),
                            ("zamba2_residual", b * t, 3584),
                            ("zamba2_decode_residual", b, 3584),
                            ("zamba2_gate", b * t, 7168),
                            ("zamba2_decode_gate", b, 7168),
                            ("pixtral_residual", b * 1280, 5120),
                            ("pixtral_decode_residual", b, 5120)):
        x, s = rand(rows, dd), rand(dd, sd=0.1)
        w = 1.0 + s
        ms = time_ms(lambda: rn_ops.rmsnorm(x, s, 1e-6), reps=50)
        plain = time_ms(lambda: rmsnorm_ref(x, s, 1e-6), reps=10)
        lib_ms = time_ms(lambda: F.rms_norm(x, (dd,), w, 1e-6), reps=50)
        errs["rmsnorm"] = max(errs["rmsnorm"], check_close(
            f"K3 timed input, {label}", rn_ops.rmsnorm(x, s, 1e-6),
            rmsnorm_ref(x, s, 1e-6), 1e-6, rel=True))
        b_ms, b_by = flop_bound(4.0 * x.numel(),
                                4.0 * (2 * x.numel() + dd))
        kind, nv = rn_kernel.variant(x, s)
        k3[label] = dict(shape=f"({rows}, {dd}) fp32", variant=kind, nv=nv,
                         ms=ms, plain_ms=plain, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"  K3 {label} ({rows}, {dd}) fp32, {kind} nv {nv}: {ms:.4f} ms"
            f" (plain {plain:.4f} ms, F.rms_norm {lib_ms:.4f} ms, "
            f"{ms / lib_ms:.3f}x; bound {b_ms:.5f} ms by {b_by}: "
            f"{b_ms / ms:.1%})")
    # K3's split form at (d-g2)'s rank shapes: zamba2-7b's gate norm over a
    # 4-way model axis, a rank's 1792 of d_inner 7168, normalised by the
    # summed statistic (ss read beside x).  No PyTorch call normalises by
    # an outside statistic.  Cold: the timed calls walk copies of x and ss,
    # more than 64 MB of them (the prefill's block is 14.7 MB, which the
    # 50 MB L2 would otherwise hold between calls).
    for label, rows in (("zamba2_gate_rank_split", 4 * 512),
                        ("zamba2_decode_gate_rank_split", 4)):
        dd = 7168 // 4
        x, s = rand(rows, dd), rand(dd, sd=0.1)
        ss = (x.square().sum(-1) * 4.0).contiguous()
        n_rot = max(2, -(-64_000_000 // (4 * x.numel())) + 1)
        turn = itertools.cycle([(x, ss)] + [(x.clone(), ss.clone())
                                            for _ in range(n_rot - 1)])

        def split_call():
            xx, sq = next(turn)
            return rn_ops.rmsnorm(xx, s, 1e-6, sq, 4 * dd)

        ms = time_ms(split_call, reps=50)
        plain = time_ms(lambda: rmsnorm_ref(x, s, 1e-6, ss, 4 * dd),
                        reps=10)
        errs["rmsnorm"] = max(errs["rmsnorm"], check_close(
            f"K3 timed input, {label}", rn_ops.rmsnorm(x, s, 1e-6, ss,
                                                       4 * dd),
            rmsnorm_ref(x, s, 1e-6, ss, 4 * dd), 1e-6, rel=True))
        b_ms, b_by = flop_bound(4.0 * x.numel(),
                                4.0 * (2 * x.numel() + dd + rows))
        kind, nv = rn_kernel.variant(x, s)
        k3[label] = dict(shape=f"({rows}, {dd}) fp32 of rows of {4 * dd}, "
                               f"cold ({n_rot} copies in turn)",
                         variant=kind, nv=nv, ms=ms, plain_ms=plain,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log(f"  K3 split form, {label} ({rows}, {dd}) fp32 of rows of "
            f"{4 * dd}, {kind} nv {nv}, cold ({n_rot} copies): {ms:.4f} ms "
            f"(plain {plain:.4f} ms warm; bound {b_ms:.5f} ms by {b_by}: "
            f"{b_ms / ms:.1%})")
        del turn

    # the backward kernels at the training shapes
    bt = TRAIN["batch"]
    q, do = rand(bt, hq, t, d), rand(bt, hq, t, d)
    k, v = rand(bt, hkv, t, d), rand(bt, hkv, t, d)
    k4b, k4l = {}, {}
    for label, window in (("global", None), ("local", 512)):
        kw = dict(scale=d ** -0.5, causal=True, window=window)
        out, lse = fa_kernel.flash_attention(q, k, v, with_lse=True, **kw)
        # K4 with L, as the training forward calls it
        ms_l = time_ms(lambda: fa_kernel.flash_attention(
            q, k, v, with_lse=True, **kw), reps=20)
        ms = time_ms(lambda: fa_kernel.flash_attention_bwd(
            q, k, v, out, lse, do, **kw), reps=10)
        plain = time_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do,
                                                  **kw), reps=3, warmup=1)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[:, None] - pos[None, :] < window
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

        def sdpa():
            if window is None:
                return F.scaled_dot_product_attention(
                    qg, kg, vg, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        lib_ms = time_ms(sdpa_fwd_bwd, reps=10) - time_ms(
            lambda: sdpa().detach(), reps=10)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], max(
            grad_close(f"K4b timed input, {label} {w}", g, ww)
            for w, g, ww in zip(("dq", "dk", "dv"),
                                fa_kernel.flash_attention_bwd(
                                    q, k, v, out, lse, do, **kw),
                                attention_bwd_ref(q, k, v, out, lse, do,
                                                  **kw))))
        pairs = float(mask.sum()) * bt * hq
        k4l[label] = dict(ms=ms_l, **k4_bounds(pairs, d, 4.0 * (
            2 * q.numel() + k.numel() + v.numel() + lse.numel())))
        log(f"  K4 with L, {label} layer ({bt},{hq},{t},{d}) Hkv {hkv} fp32:"
            f" {ms_l:.4f} ms (bound {k4l[label]['bound_ms']:.4f} ms by "
            f"{k4l[label]['bound_by']}, 3xTF32 "
            f"{k4l[label]['bound_ms_3xtf32']:.4f} ms)")
        # S, dP, dV, dQ, dK: 5 D FMAs a live pair; q, k, v, o, dO and L
        # read once, dq, dk, dv and delta written once.  Two bounds: fp32 on
        # the CUDA cores, and the route K4b takes, 3xTF32 on the tensor cores
        flops = 10.0 * pairs * d
        nbytes = 4.0 * (4 * q.numel() + 4 * k.numel() + 2 * lse.numel())
        b_ms, b_by = flop_bound(flops, nbytes)
        tc_ms, tc_by = flop_bound(3.0 * flops, nbytes, TF32_FLOP_PER_S)
        k4b[label] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          bound_ms_3xtf32=tc_ms, bound_by_3xtf32=tc_by)
        log(f"  K4b {label} layer ({bt},{hq},{t},{d}) Hkv {hkv} fp32: "
            f"{ms:.4f} ms (plain {plain:.3f} ms, SDPA backward {lib_ms:.4f}"
            f" ms, bound {b_ms:.4f} ms by {b_by} as fp32 on the CUDA cores, "
            f"{tc_ms:.4f} ms by {tc_by} as 3xTF32 on the tensor cores)")

    # K4b at moonshot-v1-16b-a3b's training shape (D = 128, Hq = Hkv = 16)
    # and zamba2-7b's shared block (D = 112, Hq = Hkv = 32), with K4's L
    for label, heads, hd in (("moonshot", 16, 128), ("zamba2", 32, 112)):
        q, k, v, do = (rand(bt, heads, t, hd) for _ in range(4))
        kw = dict(scale=hd ** -0.5, causal=True, window=None)
        out, lse = fa_kernel.flash_attention(q, k, v, with_lse=True, **kw)
        ms_l = time_ms(lambda: fa_kernel.flash_attention(
            q, k, v, with_lse=True, **kw), reps=20)
        ms = time_ms(lambda: fa_kernel.flash_attention_bwd(
            q, k, v, out, lse, do, **kw), reps=10)
        plain = time_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do,
                                                  **kw), reps=3, warmup=1)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg,
                                                  is_causal=True)

        lib_ms = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qg, kg, vg), do), reps=10) - time_ms(
            lambda: sdpa().detach(), reps=10)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], max(
            grad_close(f"K4b timed input, {label} {w}", g, ww)
            for w, g, ww in zip(("dq", "dk", "dv"),
                                fa_kernel.flash_attention_bwd(
                                    q, k, v, out, lse, do, **kw),
                                attention_bwd_ref(q, k, v, out, lse, do,
                                                  **kw))))
        pairs = t * (t + 1) / 2 * bt * heads
        nbytes = 4.0 * (4 * q.numel() + 4 * k.numel() + 2 * lse.numel())
        b_ms, b_by = flop_bound(10.0 * pairs * hd, nbytes)
        tc_ms, tc_by = flop_bound(30.0 * pairs * hd, nbytes,
                                  TF32_FLOP_PER_S)
        lb = k4_bounds(pairs, hd, 4.0 * (4 * q.numel() + lse.numel()))
        shape_s = f"({bt},{heads},{t},{hd}) Hkv {heads} fp32, causal (global)"
        k4b[f"{label}_train"] = dict(
            shape=shape_s, ms=ms, plain_ms=plain, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, bound_ms_3xtf32=tc_ms,
            bound_by_3xtf32=tc_by)
        k4l[label] = dict(shape=shape_s, ms=ms_l, **lb)
        log(f"  K4b {label} layer ({bt},{heads},{t},{hd}) Hkv {heads} fp32: "
            f"{ms:.4f} ms (plain {plain:.3f} ms, SDPA backward {lib_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms by {b_by} as fp32 on the CUDA cores, "
            f"{tc_ms:.4f} ms by {tc_by} as 3xTF32 on the tensor cores); K4 "
            f"with L {ms_l:.4f} ms (bound {lb['bound_ms']:.4f} ms by "
            f"{lb['bound_by']}, 3xTF32 {lb['bound_ms_3xtf32']:.4f} ms)")
        del q, k, v, do, out, lse, qg, kg, vg

    # K4 and K4b at (d-f)'s per-rank shape: moonshot's 16 heads over a
    # 4-way model axis, batch 2 x 1024, D = 128, causal
    fb, fh, fd = DIST_TP["batch"], 16 // DIST_TP["mesh"][1], 128
    q, k, v, do = (rand(fb, fh, t, fd) for _ in range(4))
    kw = dict(scale=fd ** -0.5, causal=True, window=None)
    out, lse = fa_kernel.flash_attention(q, k, v, with_lse=True, **kw)
    ms_f = time_ms(lambda: fa_ops.flash_attention(q, k, v), reps=20)
    plain_f = time_ms(lambda: attention_ref(q, k, v), reps=3, warmup=1)
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=20)
    errs["flash_attention"] = max(errs["flash_attention"], check_close(
        "K4 timed input, (d-f) rank", fa_ops.flash_attention(q, k, v),
        attention_ref(q, k, v), 2e-5))
    ms_b = time_ms(lambda: fa_kernel.flash_attention_bwd(
        q, k, v, out, lse, do, **kw), reps=10)
    plain_b = time_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do, **kw),
                      reps=3, warmup=1)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def sdpa_rank():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    lib_b = time_ms(lambda: torch.autograd.grad(
        sdpa_rank(), (qg, kg, vg), do), reps=10) - time_ms(
        lambda: sdpa_rank().detach(), reps=10)
    errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], max(
        grad_close(f"K4b timed input, (d-f) rank {w}", g, ww)
        for w, g, ww in zip(("dq", "dk", "dv"),
                            fa_kernel.flash_attention_bwd(
                                q, k, v, out, lse, do, **kw),
                            attention_bwd_ref(q, k, v, out, lse, do,
                                              **kw))))
    pairs = t * (t + 1) / 2 * fb * fh
    shape_s = f"({fb},{fh},{t},{fd}) Hkv {fh} fp32, causal (global)"
    k4["moonshot_tp_rank"] = dict(
        shape=shape_s, instance=fa_kernel.instance(fd), ms=ms_f,
        plain_ms=plain_f, library_ms=lib_f, **k4_bounds(
            pairs, fd, 4.0 * (2 * q.numel() + k.numel() + v.numel())))
    nbytes = 4.0 * (4 * q.numel() + 4 * k.numel() + 2 * lse.numel())
    b_ms, b_by = flop_bound(10.0 * pairs * fd, nbytes)
    tc_ms, tc_by = flop_bound(30.0 * pairs * fd, nbytes, TF32_FLOP_PER_S)
    k4b["moonshot_tp_rank"] = dict(
        shape=shape_s, ms=ms_b, plain_ms=plain_b, library_ms=lib_b,
        bound_ms=b_ms, bound_by=b_by, bound_ms_3xtf32=tc_ms,
        bound_by_3xtf32=tc_by)
    f4 = k4["moonshot_tp_rank"]
    log(f"  (d-f) rank shape {shape_s}: K4 {ms_f:.4f} ms (plain "
        f"{plain_f:.3f} ms, SDPA {lib_f:.4f} ms, bound "
        f"{f4['bound_ms']:.4f} ms by {f4['bound_by']} as fp32, "
        f"{f4['bound_ms_3xtf32']:.4f} ms as 3xTF32); K4b {ms_b:.4f} ms "
        f"(plain {plain_b:.3f} ms, SDPA backward {lib_b:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} as fp32, {tc_ms:.4f} ms by {tc_by} as "
        f"3xTF32)")
    del q, k, v, do, out, lse, qg, kg, vg

    k3b = {}
    for label, rows, dd in (("residual", bt * t, 1152),
                            ("q_norm", bt * t * hq, d),
                            ("falcon_residual", bt * t, 4096),
                            ("zamba2_residual", bt * t, 3584),
                            ("zamba2_gate", bt * t, 7168)):
        x, g, sc = rand(rows, dd), rand(rows, dd), rand(dd, sd=0.1)
        ms = time_ms(lambda: rn_kernel.rmsnorm_rows_bwd(x, sc, g), reps=50)
        plain = time_ms(lambda: rmsnorm_bwd_ref(x, sc, g), reps=10)
        xg = x.clone().requires_grad_()
        wg = (1.0 + sc).requires_grad_()
        y = F.rms_norm(xg, (dd,), wg, 1e-6)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            y, (xg, wg), g, retain_graph=True), reps=50)
        errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], max(
            grad_close(f"K3b timed input, {label} {w}", a, bb)
            for w, a, bb in zip(("dx", "dscale"),
                                rn_kernel.rmsnorm_rows_bwd(x, sc, g),
                                rmsnorm_bwd_ref(x, sc, g))))
        # x and g read once, dx written once, scale and dscale
        b_ms, b_by = flop_bound(10.0 * x.numel(),
                                4.0 * (3 * x.numel() + 2 * dd))
        k3b[label] = dict(shape=f"({rows}, {dd}) fp32", ms=ms,
                          plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by)
        log(f"  K3b {label} ({rows}, {dd}) fp32: {ms:.4f} ms (plain "
            f"{plain:.4f} ms, autograd of F.rms_norm {lib_ms:.4f} ms, bound"
            f" {b_ms:.5f} ms by {b_by})")

    # K5b at falcon-mamba-7b's training layer, gated, beside K5 with its
    # saved states (the training forward) and the serving K5; the bound
    # and the design's own traffic as ``scan_bwd_bound`` counts them.  No
    # PyTorch call computes the scan's backward: library_ms is None.
    tshape = (SSM_TRAIN["batch"], SSM_TRAIN["seq"], falcon.d_inner,
              falcon.ssm_state)
    ins = scan_inputs(tshape, 12, dev)
    gate = gate_inputs(ins, 12)
    gen = torch.Generator(device=dev).manual_seed(13)
    dout = torch.randn(ins[0].shape, generator=gen, device=dev)
    _, _, hs = ss_kernel.selective_scan(*ins, *gate, states=True)
    runs = {"bwd": lambda: ss_kernel.selective_scan_bwd(
                *ins, hs, dout, None, *gate),
            "states": lambda: ss_kernel.selective_scan(*ins, *gate,
                                                       states=True),
            "serve": lambda: ss_kernel.selective_scan(*ins, *gate)}
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(time_ms(runs[k], reps=10))
    plain_bwd = time_ms(lambda: selective_scan_bwd_ref(*ins, dout, None,
                                                       *gate),
                        reps=2, warmup=1)
    errs["selective_scan_bwd"] = max(errs["selective_scan_bwd"],
                                     scan_grads_close(
        "K5b timed input", runs["bwd"](),
        selective_scan_bwd_ref(*ins, dout, None, *gate)))
    bnd = scan_bwd_bound(tshape, ss_kernel.BWD_CH)
    occ = ss_kernel.bwd_occupancy(tshape[3], True)
    if occ["channels"] != ss_kernel.BWD_CH:
        raise AssertionError(f"K5b is built for {occ['channels']} channels "
                             f"a block, kernel.BWD_CH is "
                             f"{ss_kernel.BWD_CH}")
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    k5b = dict(ms=mean["bwd"], plain_ms=plain_bwd, library_ms=None,
               **{k: v for k, v in bnd.items()
                  if k not in ("bytes", "design_bytes")}, occupancy=occ)
    log(f"  K5b gated falcon training layer {tshape} fp32: {mean['bwd']:.4f}"
        f" ms (runs {', '.join(f'{t:.4f}' for t in times['bwd'])}; K5b's "
        f"first design, for reference: {K5B_FIRST_MS} ms; plain "
        f"{plain_bwd:.3f} ms, no library call; bound {bnd['bound_ms']:.4f} "
        f"ms by {bnd['bound_by']}: bytes {bnd['bound_ms_bytes']:.4f} ms "
        f"({bnd['bytes'] / 1e6:.1f} MB), exps {bnd['bound_ms_exp']:.4f} ms "
        f"on the SFUs, fp32 {bnd['bound_ms_fp32']:.4f} ms; "
        f"{bnd['bound_ms'] / mean['bwd']:.1%} of the bound; the design's "
        f"own bytes, saved states and {ss_kernel.BWD_CH}-channel block "
        f"partials included, {bnd['design_bytes_ms']:.4f} ms "
        f"({bnd['design_bytes'] / 1e6:.1f} MB), its two exps a state "
        f"{bnd['design_exp_ms']:.4f} ms)")
    log(f"  K5b occupancy at N={tshape[3]} gated: {occ['registers']} "
        f"registers a thread, {occ['local_bytes']} bytes of local memory "
        f"(spills), {occ['smem_bytes']} bytes of shared memory a block of "
        f"{occ['threads']} threads, {occ['blocks_per_sm']} blocks = "
        f"{occ['warps_per_sm']} warps an SM")
    log(f"  K5 gated at the same shape: with its saved states (training) "
        f"{mean['states']:.4f} ms (runs "
        f"{', '.join(f'{t:.4f}' for t in times['states'])}), serving "
        f"{mean['serve']:.4f} ms (runs "
        f"{', '.join(f'{t:.4f}' for t in times['serve'])})")
    k5["gated"]["train_with_states"] = dict(
        shape=f"{tshape} fp32", ms=mean["states"], ms_serving=mean["serve"])
    del ins, gate, dout, hs

    def entry(name, source, replaces, shape, main, other_label, other,
              path="serve"):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "shape": shape,
                "launches": counts[path][name],
                "launches_train_step": counts["train"][name],
                "launches_moonshot_serve": counts["moe_serve"][name],
                "launches_moonshot_train_step": counts["moe_train"][name],
                "launches_falcon_serve": counts["falcon_serve"][name],
                "launches_zamba2_serve": counts["zamba2_serve"][name],
                "launches_falcon_train_step": counts["falcon_train"][name],
                "launches_zamba2_train_step": counts["zamba2_train"][name],
                "launches_pixtral_serve": counts["pixtral_serve"][name],
                "launches_pixtral_serve_fp8":
                    counts["pixtral_serve_fp8"][name],
                "launches_musicgen_serve": counts["musicgen_serve"][name],
                "launches_moonshot_tp_rank_step": counts["moe_tp"][name],
                "max_abs_err": errs[name],
                "max_abs_err_bf16": errs[name + "_bf16"], **main,
                other_label: other}

    return [
        entry("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm/kernel.py:35",
              f"({b * t}, 1152) fp32, the residual", k3["residual"],
              "q_norm", k3["q_norm"])
        | {"decode_residual": k3["decode_residual"],
           "decode_q_norm": k3["decode_q_norm"],
           "moonshot_residual": k3["moonshot_residual"],
           "moonshot_decode_residual": k3["moonshot_decode_residual"]}
        | {label: k3[label] for label in (
            "falcon_residual", "falcon_decode_residual", "zamba2_residual",
            "zamba2_decode_residual", "zamba2_gate", "zamba2_decode_gate",
            "pixtral_residual", "pixtral_decode_residual",
            "zamba2_gate_rank_split", "zamba2_decode_gate_rank_split")},
        entry("flash_attention",
              "src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:120",
              f"({b},{hq},{t},{d}) Hkv {hkv} fp32, causal (global layer)",
              k4["global"], "local_window_512", k4["local"])
        | {"also_replaces": ["src/repro/kernels/flash_attention/ops.py:76"],
           "moonshot_global": k4["moonshot_global"],
           "zamba2_shared": k4["zamba2_shared"],
           "musicgen": k4["musicgen"], "pixtral": k4["pixtral"],
           "moonshot_tp_rank": k4["moonshot_tp_rank"],
           "train_with_lse": {
               "shape": f"({bt},{hq},{t},{d}) Hkv {hkv} fp32",
               "global": k4l["global"], "local_window_512": k4l["local"],
               "moonshot": k4l["moonshot"], "zamba2": k4l["zamba2"]}},
        entry("rmsnorm_bwd",
              "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
              "src/repro/models/layers.py:37 (jax.grad of rms_norm; no "
              "Pallas kernel)",
              f"({bt * t}, 1152) fp32, the residual", k3b["residual"],
              "q_norm", k3b["q_norm"], path="train")
        | {label: k3b[label] for label in (
            "falcon_residual", "zamba2_residual", "zamba2_gate")},
        entry("flash_attention_bwd",
              "src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd.cu",
              "src/repro/models/layers.py:79 (jax.grad of "
              "_masked_attention; no Pallas kernel)",
              f"({bt},{hq},{t},{d}) Hkv {hkv} fp32, causal (global layer)",
              k4b["global"], "local_window_512", k4b["local"], path="train")
        | {"moonshot_train": k4b["moonshot_train"],
           "zamba2_train": k4b["zamba2_train"],
           "moonshot_tp_rank": k4b["moonshot_tp_rank"]},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/selective_scan/csrc/"
                   "selective_scan.cu",
         "replaces": "src/repro/models/mamba.py:82 (_ssm_scan_chunked, "
                     "plain jnp; no Pallas kernel) and the gate of "
                     "src/repro/models/mamba.py:144-145",
         "shape": f"{shape} fp32, falcon-mamba-7b's prefill layer, gated "
                  f"(what the model runs)",
         "launches": counts["falcon_serve"]["selective_scan"],
         "launches_zamba2_serve": counts["zamba2_serve"]["selective_scan"],
         "launches_falcon_train_step":
             counts["falcon_train"]["selective_scan"],
         "launches_zamba2_train_step":
             counts["zamba2_train"]["selective_scan"],
         "max_abs_err": errs["selective_scan"], **k5["gated"],
         "scan_only": k5["scan"], "yardstick_ms": yard},
        {"name": "selective_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/selective_scan/csrc/"
                   "selective_scan_bwd.cu",
         "replaces": "src/repro/models/mamba.py:82 and :144-145 (jax.grad "
                     "of _ssm_scan_chunked and the gate; no Pallas kernel)",
         "shape": f"{tshape} fp32, falcon-mamba-7b's training layer, "
                  f"gated",
         "launches": counts["falcon_train"]["selective_scan_bwd"],
         "launches_zamba2_train_step":
             counts["zamba2_train"]["selective_scan_bwd"],
         "max_abs_err": errs["selective_scan_bwd"], **k5b},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attention/csrc/"
                   "decode_attention.cu",
         "replaces": "src/repro/models/layers.py:79 (_masked_attention over "
                     "the cache at decode, called at :221; plain jnp, no "
                     "Pallas kernel)",
         "shape": "q (8,32,1,128), cache (8,8,1312,128) float8_e4m3fn: "
                  "pixtral-12b's decode on an fp8 cache",
         "launches": counts["pixtral_serve_fp8"]["decode_attention"],
         **{f"launches_{path}": counts[path]["decode_attention"]
            for path in ("pixtral_serve", "musicgen_serve", "serve",
                         "moe_serve", "zamba2_serve", "falcon_serve")},
         **{k: v for k, v in k6["S1312_fp8"].items() if k != "shape"},
         "max_abs_err": errs["decode_attention_fp8"],
         "max_abs_err_fp32": errs["decode_attention"],
         "max_abs_err_bf16": errs["decode_attention_bf16"],
         "by_cache": k6},
        {"name": "decode_attention_partial", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attention/csrc/"
                   "decode_attention.cu",
         "replaces": "src/repro/models/layers.py:79 (_masked_attention over "
                     "a cache split over slots by the partitioner at decode, "
                     "called at :221; plain jnp, no Pallas kernel)",
         "launches": counts["serve_tp"]["decode_attention_partial"],
         **k6p,
         "max_abs_err": errs["decode_attention_partial"],
         "max_abs_err_bf16": errs["decode_attention_partial_bf16"],
         "max_abs_err_fp8": errs["decode_attention_partial_fp8"]},
    ]


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
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate
    from repro_torch.train.train_step import train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    secs = _build.build(*families())
    n_src = sum(len(f.sources) for f in families())
    log(f"kernel build ({n_src} sources, one nvcc each, in parallel): "
        f"{secs:.1f} s")
    for fam in families():
        for name, out in fam.build_log.items():
            function = "?"
            for line in out.splitlines():
                if "Function properties for" in line:
                    function = line.split(" for ", 1)[1].strip()
                if "registers" in line or "spill" in line:
                    log(f"  nvcc {name}: {line.strip()}")
                if "spill" in line and " 0 bytes spill stores" not in line:
                    log(f"  nvcc {name}: the spill above is in {function}")

    rng = np.random.default_rng(0)
    errs: dict = {}
    counts: dict = {}
    log("phase: min-plus kernels vs twins on the card")
    phase_kernels(rng, errs)
    log("phase: LM kernels (K3, K4, K6) vs plain versions on the card")
    phase_lm_kernels(rng, errs)
    log("phase: LM backward kernels (K4 with L, K4b, K3b, K5b) vs plain "
        "versions")
    phase_lm_bwd_kernels(rng, errs)
    log("phase: main path, overlay.build('dgro') at N=4096")
    built, built_scipy = phase_build(counts)
    log("phase: ring selection, selection.adapt at N=256")
    phase_adapt(counts)
    log("phase: fig20 cell, diameters_of_rings B=64 N=4096")
    fig20 = phase_fig20(rng)
    log(f"phase: dgro-dqn at N={DQN['n']}")
    phase_dqn(counts)
    log(f"phase: parallel at N={PARALLEL['n']}")
    phase_parallel(counts)
    log(f"phase: churn, the dynamics engine at n0={CHURN['n0']}")
    t0 = time.perf_counter()
    rate_b = phase_churn(counts)
    log(f"  churn phase: {time.perf_counter() - t0:.1f} s")
    for label, run in (
            (f"(r) routing over the build's overlay, N={built.n}",
             lambda: phase_routing(built, counts)),
            ("(p) the churn engine's routing probe",
             lambda: phase_probe(counts, rate_b)),
            (f"(h) hierarchy at N={HIER['n']}", lambda: phase_hier(counts)),
            ("(s) the control-plane service", phase_service),
            (f"(d) the multi-device DGRO path, {DIST['ranks']} ranks on "
             f"one card", lambda: phase_distributed(fig20, built,
                                                     built_scipy, card,
                                                     counts))):
        log(f"phase: {label}")
        t0 = time.perf_counter()
        run()
        log(f"  {label.split(' ')[0]} phase: "
            f"{time.perf_counter() - t0:.1f} s")
    del built, fig20
    log("phase: LM serving, gemma3-1b at full width")
    served = phase_serve(counts, errs)
    log("phase: device time by profiler")
    phase_profile(rng)
    profiled("serve gemma3-1b: prefill 8 x 1024 + 4 decode steps",
             lambda: generate(served["cfg"], served["params"],
                              served["prompts"], 5, SERVE["max_len"]))
    del served
    log(f"phase: LM training, {TRAIN['arch']} at full width")
    t0 = time.perf_counter()
    trained = phase_train(counts, card)
    profiled(f"train {TRAIN['arch']}: one step, batch {TRAIN['batch']} x "
             f"{TRAIN['seq']}, remat [{card}]",
             lambda: train_step(trained["cfg"], trained["tc"],
                                trained["state"], trained["batch"]))
    del trained
    log(f"  training phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    log(f"phase: (m) MoE serving, {MOE['arch']} at full width "
        f"({MOE['n_layers']} of 48 layers)")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    served = phase_moe(counts, errs, card, dev)
    profiled(f"(m-f) serve {MOE['arch']} ({MOE['n_layers']} layers): prefill "
             f"{MOE['batch']} x {MOE['prompt_len']} + 4 decode steps "
             f"[{card}]",
             lambda: generate(served["cfg"], served["params"],
                              served["prompts"], 5, MOE["max_len"]))
    decode = decode_steps(served, 4, MOE["max_len"])
    decode()                                              # warm-up
    profiled(f"(m-f) the same, 4 decode steps alone [{card}]", decode)
    del served, decode
    torch.cuda.empty_cache()
    phase_moe_train(counts, card, dev)
    torch.cuda.empty_cache()
    log(f"  (m) phase: {time.perf_counter() - t0:.1f} s")
    for arch in SSM["archs"]:
        tag = arch[0]
        log(f"phase: ({tag}) SSM serving, {arch} at full width and depth")
        t0 = time.perf_counter()
        served = phase_ssm(arch, counts, errs, card, dev)
        profiled(f"({tag}-f) serve {arch}: prefill {SSM['batch']} x "
                 f"{SSM['prompt_len']} + 4 decode steps [{card}]",
                 lambda: generate(served["cfg"], served["params"],
                                  served["prompts"], 5, SSM["max_len"]))
        decode = decode_steps(served, 4, SSM["max_len"])
        decode()                                          # warm-up
        profiled(f"({tag}-f) the same, 4 decode steps alone [{card}]",
                 decode)
        del served, decode
        torch.cuda.empty_cache()
        log(f"  ({tag}) phase: {time.perf_counter() - t0:.1f} s")
    for arch in SSM["archs"]:
        tag = f"({arch[0]}-t)"
        log(f"phase: {tag} SSM training, {arch} at full width "
            f"({SSM_TRAIN['layers'][arch]} layers)")
        t0 = time.perf_counter()
        trained = phase_ssm_train(arch, counts, card, dev)
        profiled(f"{tag} train {arch} ({trained['cfg'].n_layers} layers): "
                 f"one step, batch {SSM_TRAIN['batch']} x "
                 f"{SSM_TRAIN['seq']}, remat [{card}]",
                 lambda: train_step(trained["cfg"], trained["tc"],
                                    trained["state"], trained["batch"]))
        del trained
        torch.cuda.empty_cache()
        log(f"  {tag} phase: {time.perf_counter() - t0:.1f} s")
    for arch in FRONTEND["archs"]:
        tag = "v" if arch.startswith("pixtral") else "u"
        log(f"phase: ({tag}) frontend serving, {arch} at full width and "
            f"depth")
        t0 = time.perf_counter()
        served = phase_frontend(arch, counts, errs, card, dev)
        if served["vision"] is not None:
            profiled(f"({tag}-f) serve {arch}: prefill {FRONTEND['batch']} x "
                     f"({served['vision'].shape[1]} patches + "
                     f"{FRONTEND['prompt_len']} tokens) + 4 decode steps, "
                     f"fp8 cache [{card}]",
                     lambda: generate(served["cfg"], served["params"],
                                      served["prompts"], 5,
                                      served["max_len"],
                                      vision_embeds=served["vision"],
                                      cache_dtype=served["cache_dtype"]))
            decode = decode_steps(served, 4, served["max_len"])
            decode()                                      # warm-up
            profiled(f"({tag}-f) the same, 4 decode steps alone [{card}]",
                     decode)
            del decode
        del served
        torch.cuda.empty_cache()
        log(f"  ({tag}) phase: {time.perf_counter() - t0:.1f} s")
    log("phase: kernel timing at the paths' shapes")
    entries = phase_timing(rng, counts, errs)
    entries += phase_lm_timing(rng, counts, errs)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card "
        f"was found")

    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
