"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from ``src/repro_torch/kernels/*/csrc``
(one ``nvcc`` per source, all at once) and holds each against its
plain-torch twin on the card: the min-plus kernels K1/K2 bitwise, RMSNorm
K3 and flash attention K4 within stated tolerances.  Then it drives the
port's two paths, each with the kernels' launch counters reset just before
and read just after:

* DGRO -- ``overlay.build("dgro")`` at N=4096 and ``selection.adapt`` at
  N=256 (diameters against scipy's Dijkstra), and fig20's scoring cell;
* the deep-Q constructor -- ``overlay.build("dgro-dqn")`` at N=200 (the
  paper's largest training size) with 2 training epochs instead of the
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
* LM serving -- ``launch.serve.generate`` on gemma3-1b at full width
  (8 requests of 1024-token prompts, 32 new tokens, greedy), with the K3/K4
  launch counts the config implies and the prefill logits held against the
  plain versions run on the card.

It times every kernel at its path's shapes (K2 in every cluster size and
pivots per barrier it is built for, beside a probe of the cluster
barrier), and prints one JSON object per line for the kernels and, last,
the device.  Exits non-zero, printing no
result, when there is no CUDA device, when the port cannot be imported, or
when any phase fails.  Needs one card; imports nothing of JAX.
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
FLOP_PER_S = 67e12
BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def flop_bound(flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of the fp32 operation floor (an FMA
    counts as two) and the byte floor for the same work on the whole card."""
    ops_ms = flops / FLOP_PER_S * 1e3
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


def reset_all_launches() -> None:
    """Every kernel's launch count to 0 (before a path is driven)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.minplus import kernel as mp
    from repro_torch.kernels.rmsnorm import kernel as rn

    for fam in (mp.FAMILY, rn.FAMILY, fa.FAMILY):
        fam.reset_launches()


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
    routing routes over it)."""
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
    return ov


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


DQN = dict(n=200, dist="fabric", epochs=2, n_starts=10)


def phase_dqn(counts: dict) -> None:
    """The deep-Q constructor: ``overlay.build("dgro-dqn")`` at N=200
    (K = 8 rings, T = 1,600 steps an epoch, 10 starts), 2 training epochs.
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
        f"wall, of which train_dqn {tlog.seconds:.2f} s (2 epochs + 2 eval "
        f"rollouts, {tlog.steps_per_sec:.1f} env steps/s); "
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


PARALLEL = dict(n=4096, dist="fabric", m=32, dqn_epochs=40)


def phase_parallel(counts: dict) -> None:
    """Partitioned construction (Alg. 4) at N=4096: M=1 and M=32 with
    nearest segments, M=32 with DQN segments (the builder's default 40
    training epochs at the block size 128), all with the scored stitch.
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


CHURN = dict(n0=4000, dist="bitnode", horizon=30_000.0, rate=2e-3,
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
    Run once under the profiler (its launches counted there), then held
    to scipy; returns the new live Dijkstra matrix."""
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
        profiled("(a') forced adapt at N~4,000 (eps 0.5)",
                 lambda: pol.maybe_adapt(eng))
        wall = time.perf_counter() - t0
    got = dict(kernel.launches)
    counts["churn (a') forced adapt"] = got
    want = ledger.expected_launches()
    kind, rho = ledger.adapts[-1][1:3]
    added = eng.inc.stats["relaxations"] - relax0
    log(f"  (a') forced adapt: added a {kind} ring (rho {rho:.4f}) as "
        f"{added} relaxations, {ledger.apsps('adapt')} candidates scored "
        f"({sorted({(c[3], c[2]) for c in ledger.calls})}), {wall:.3f} s "
        f"with the profiler on; launches {got} (expected {want})")
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
    # device ops) takes the profiler minutes to reduce
    profiled(f"route_pairs_hier N={n}, P=512 of them (cluster APSPs "
             f"cached)", lambda: route_pairs_hier(hov, pairs[:512]))
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
    exit; its last line carries the numbers printed here."""
    for policy, n0, n_events in SERVICE:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "torch_service_smoke.py"),
             "--policy", policy, "--n0", str(n0), "--events", str(n_events),
             "--device", "cuda"],
            capture_output=True, text=True, timeout=400, cwd=ROOT)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            log(out.stdout[-3000:])
            log(out.stderr[-6000:])
            raise AssertionError(f"(s) {policy}: smoke exited "
                                 f"{out.returncode}")
        lines = out.stdout.strip().splitlines()
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
    rollout, and a training epoch cut to K = 2 rings (400 steps, the same
    per-step work as the build's 1,600) to keep the trace small."""
    import torch

    from repro_torch.core import qlearning, rollout
    from repro_torch.core.embedding import init_qparams
    from repro_torch.core.topology import make_latency
    from repro_torch.train.optimizer import adamw_init

    n, k = DQN["n"], 8
    w = make_latency(DQN["dist"], n, seed=0)
    cfg = qlearning.DQNConfig(n=n, k_rings=k)
    params = init_qparams(torch.Generator().manual_seed(0), cfg.p, cfg.h)
    profiled(f"dgro-dqn {DQN['n_starts']}-start rollout N={n} K={k}",
             lambda: qlearning.dgro_overlay(params, cfg, w,
                                            n_starts=DQN["n_starts"]))
    slots = rollout.graph_slots(cfg.buffer_capacity, 1, 2, n)
    buf = rollout.init_buffer(cfg.buffer_capacity, n, slots)
    plan = rollout.make_plan(np.random.default_rng(0), 1, 2, n, 1,
                             cfg.batch_size)
    profiled(f"dgro-dqn train_epoch N={n} K=2 ({2 * n} steps)",
             lambda: rollout.train_epoch(
                 params, adamw_init(params.tensors()), buf,
                 torch.as_tensor(w[None], device="cuda"), [0], plan.starts,
                 plan.eps_u, plan.choice_u, plan.sample_u, 1.0, cfg.gamma,
                 cfg.lr, cfg.alpha, k_rings=2, batch_size=cfg.batch_size))


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
]


def phase_lm_kernels(rng, errs: dict) -> None:
    """K4 and K3 against their plain versions on the card, fp32 and bf16.
    K4: fp32 within 2e-5, bf16 within 3e-2 (the JAX kernel tests' own
    tolerances: online against dense softmax).  K3: fp32 within
    1e-6 x max(1, |want|) (1/sqrtf against torch's CUDA rsqrt, summed in
    another order), bf16 within one bf16 ulp."""
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
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        key = "rmsnorm" + ("" if dt == torch.float32 else "_bf16")
        for rows, d, off in ((8 * 1024, 1152, 0), (8 * 1024 * 4, 256, 0),
                             (1, 1152, 0), (7, 1152, 0), (300, 256, 0),
                             (5, 8192, 0), (7, 1150, 0), (300, 256, 1)):
            # off = 1: rows one element off a 16-byte boundary
            x = rand((rows * d + off,), dt, 2.0)[off:].view(rows, d)
            s = rand((d,), dt, 0.1)
            got, want = rn_ops.rmsnorm(x, s, 1e-6), rmsnorm_ref(x, s, 1e-6)
            tag = (f"K3 ({rows}, {d}){' offset 1' if off else ''} {name}, "
                   f"variant {rn_kernel.variant(x, s)[0]}")
            err = check_close(tag, got, want, 1e-6, rel=True) \
                if dt == torch.float32 else bf16_ulp_close(tag, got, want)
            errs[key] = max(errs.get(key, 0.0), err)


SERVE = dict(arch="gemma3-1b", batch=8, prompt_len=1024, max_new=32,
             max_len=1056)


def expected_lm_launches(cfg, max_new: int) -> dict:
    """K3 / K4 launches of one ``generate``.  Per layer, prefill runs ln1
    and ln2 and, with qk_norm, q_norm, k_norm and ``_prefill_kv``'s
    k_norm; decode runs ln1, ln2 (+ q_norm, k_norm); every forward ends in
    the final norm.  K4 runs once per layer in prefill only: decode attends
    over the cache with the plain masked softmax."""
    qk = 2 if cfg.qk_norm else 0
    prefill = cfg.n_layers * (2 + qk + qk // 2) + 1
    decode = cfg.n_layers * (2 + qk) + 1
    return {"rmsnorm": prefill + (max_new - 1) * decode,
            "flash_attention": cfg.n_layers}


def phase_serve(counts: dict, errs: dict) -> dict:
    """The LM serving path: gemma3-1b at full width, random weights from a
    torch.Generator seeded 0, 8 prompts of 1024 tokens from numpy
    default_rng(0), 32 new tokens, greedy.  Then the same prefill once
    through the kernels and once through the plain versions, on the card:
    the last-position logits must agree within rtol = atol = 1e-4 (the
    CPU parity tests' tolerance; fp32 throughout, TF32 off)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rn
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
    counts["serve"] = {**rn.launches, **fa.launches}
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


def phase_lm_timing(rng, counts: dict, errs: dict) -> list:
    """K4 and K3 at the served shapes: ms per launch by CUDA events, the
    plain version's ms, the bound (fp32 FLOPs of the unmasked score pairs
    only; each input read once, each output written once) and one PyTorch
    call computing the same function (``library_ms``, timed here and used
    nowhere in the port).  Returns the kernels line's entries."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    dev = torch.device("cuda")
    b, hq, hkv, t, d = SERVE["batch"], 4, 1, SERVE["prompt_len"], 256

    def rand(*shape, sd=1.0):
        return torch.from_numpy(rng.normal(0, sd, shape).astype(np.float32)) \
            .to(dev)

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
        b_ms, b_by = flop_bound(4.0 * pairs * d,
                                4.0 * (2 * q.numel() + k.numel() + v.numel()))
        k4[label] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"  K4 {label} layer ({b},{hq},{t},{d}) Hkv {hkv} fp32: "
            f"{ms:.4f} ms (plain {plain:.3f} ms, SDPA {lib_ms:.4f} ms with "
            f"max |diff| {lib_err:.3g} to plain, bound {b_ms:.4f} ms by "
            f"{b_by})")

    k3 = {}
    for label, rows, dd in (("residual", b * t, 1152),
                            ("q_norm", b * t * hq, d),
                            ("decode_residual", b, 1152),
                            ("decode_q_norm", b * hq, d)):
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
        k3[label] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"  K3 {label} ({rows}, {dd}) fp32: {ms:.4f} ms (plain "
            f"{plain:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound {b_ms:.5f} "
            f"ms by {b_by})")

    def entry(name, source, replaces, shape, main, other_label, other):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "shape": shape,
                "launches": counts["serve"][name],
                "max_abs_err": errs[name],
                "max_abs_err_bf16": errs[name + "_bf16"], **main,
                other_label: other}

    return [
        entry("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm/kernel.py:35",
              f"({b * t}, 1152) fp32, the residual", k3["residual"],
              "q_norm", k3["q_norm"])
        | {"decode_residual": k3["decode_residual"],
           "decode_q_norm": k3["decode_q_norm"]},
        entry("flash_attention",
              "src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:120",
              f"({b},{hq},{t},{d}) Hkv {hkv} fp32, causal (global layer)",
              k4["global"], "local_window_512", k4["local"])
        | {"also_replaces": ["src/repro/kernels/flash_attention/ops.py:76"]},
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
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.minplus import kernel as mp
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.launch.serve import generate

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
    secs = _build.build(mp.FAMILY, rn.FAMILY, fa.FAMILY)
    log(f"kernel build (4 sources, one nvcc each, in parallel): {secs:.1f} s")
    for fam in (mp.FAMILY, rn.FAMILY, fa.FAMILY):
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
    log("phase: LM kernels (K3, K4) vs plain versions on the card")
    phase_lm_kernels(rng, errs)
    log("phase: main path, overlay.build('dgro') at N=4096")
    built = phase_build(counts)
    log("phase: ring selection, selection.adapt at N=256")
    phase_adapt(counts)
    log("phase: fig20 cell, diameters_of_rings B=64 N=4096")
    phase_fig20(rng)
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
            ("(s) the control-plane service", phase_service)):
        log(f"phase: {label}")
        t0 = time.perf_counter()
        run()
        log(f"  {label.split(' ')[0]} phase: "
            f"{time.perf_counter() - t0:.1f} s")
    del built
    log("phase: LM serving, gemma3-1b at full width")
    served = phase_serve(counts, errs)
    log("phase: device time by profiler")
    phase_profile(rng)
    profiled("serve gemma3-1b: prefill 8 x 1024 + 4 decode steps",
             lambda: generate(served["cfg"], served["params"],
                              served["prompts"], 5, SERVE["max_len"]))
    del served
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
