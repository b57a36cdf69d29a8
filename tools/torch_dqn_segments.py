"""Hold the port's deep-Q segment constructor (Alg. 4, ``constructor="dqn"``)
to the JAX package at the block size of N=4096, M=32 (P = 128).

Two stages, because the JAX package runs on the CPU and the port's
scored stitch at N=4096 needs the card:

  PYTHONPATH=src python tools/torch_dqn_segments.py reference \
      --out build/dqn_segments.npz
      # CPU, JAX + repro_torch: trains the reference's segment Q-network
      # (SegmentDQNConfig: 40 epochs, 4 envs, block size 128), builds the
      # M=32 DQN segments with it in both packages and compares them;
      # saves the parameters and the segments.

  python tools/torch_dqn_segments.py card --ref build/dqn_segments.npz
      # GPU (--device cpu for a dry run), repro_torch only:
      # build("parallel") M=32 dqn with the reference's parameters carried
      # into the port's cache and with the port's own training run, M=1
      # and M=32 nearest; prints each diameter and its ratio to M=1, and
      # times the nearest + naive fast path (_nearest_merged_naive)
      # against the general path.

``--n``/``--m`` shrink the problem for a dry run on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _build_seed(seed: int) -> int:
    """The seed ``build("parallel", ..., seed=seed)`` hands to Alg. 4."""
    return int(np.random.default_rng(seed).integers(2**31))


def _ring_diameter(w, ring) -> float:
    from repro_torch.core.diameter import adjacency_from_rings, diameter_scipy
    return float(diameter_scipy(adjacency_from_rings(w, [ring])))


def _q_along(arrays, w, nodes, seg, steps=(0, 1, 2, 10, 60)) -> dict:
    """Float64 Q values of the unvisited nodes along one segment's build:
    the largest, and their spread (max - min) relative to it."""
    import torch

    from repro_torch.core.embedding import THETAS, QParams, q_values_batch

    f64 = QParams(**{k: torch.tensor(np.asarray(arrays[k], np.float64))
                     for k in THETAS})
    pos = {v: i for i, v in enumerate(nodes)}
    path = [pos[v] for v in seg]
    blk = torch.tensor(np.asarray(w[np.ix_(nodes, nodes)], np.float64))[None]
    out = {}
    for t in steps:
        if t >= len(path) - 1:
            break
        adj = torch.zeros(1, len(path), len(path), dtype=torch.float64)
        for a, b in zip(path[:t], path[1:t + 1]):
            adj[0, a, b] = adj[0, b, a] = 1.0
        with torch.no_grad():
            q = q_values_batch(f64, blk, adj, torch.tensor([path[t]]))[0]
        seen = torch.zeros(len(path), dtype=torch.bool)
        seen[path[:t + 1]] = True
        q = q[~seen]
        out[t] = dict(max=float(q.max()), rel_spread=float(
            (q.max() - q.min()) / q.abs().max()))
    return out


def reference(args) -> dict:
    from repro.core import parallel as jp
    from repro.core.topology import make_latency
    from repro_torch.core import batcheval
    from repro_torch.core import parallel as tp
    from repro_torch.core import qlearning as tq
    from repro_torch.core.embedding import qparams_from_jax

    w = make_latency("fabric", args.n, seed=0)
    seed = _build_seed(0)
    p = -(-args.n // args.m)
    t0 = time.perf_counter()
    jparams, jcfg = jp._segment_qparams(p, jp.SegmentDQNConfig())
    train_s = time.perf_counter() - t0
    arrays = {k: np.asarray(v) for k, v in jparams._asdict().items()}

    plan = jp.plan_partitions(args.n, args.m, np.random.default_rng(seed))
    jsegs = jp._segments_dqn_many(w, [plan], jp.SegmentDQNConfig())[0]
    nsegs = jp._segments_nearest_many(w, [plan])[0]
    tcfg = tq.DQNConfig(**{f: getattr(jcfg, f)
                           for f in jcfg.__dataclass_fields__})
    with batcheval.eval_options(device="cpu"):
        tp._SEGMENT_PARAMS_CACHE[(p, tp.SegmentDQNConfig())] = (
            qparams_from_jax(arrays, device="cpu"), tcfg)
        tplan = tp.plan_partitions(args.n, args.m,
                                   np.random.default_rng(seed))
        tsegs = tp._segments_dqn_many(w, [tplan], tp.SegmentDQNConfig())[0]
    same = [bool(np.array_equal(a, b)) for a, b in zip(jsegs, tsegs)]
    parts_at = [int(np.flatnonzero(a != b)[0]) for a, b in zip(jsegs, tsegs)
                if not np.array_equal(a, b)]
    # per-block ring diameters and the naive (tail-to-head) merge, by
    # Dijkstra: the scored stitch at this N needs the card
    blocks = {label: [_ring_diameter(w[np.ix_(s, s)], np.arange(len(s)))
                      for s in segs]
              for label, segs in (("dqn", jsegs), ("nearest", nsegs))}
    m1 = jp.parallel_ring(w, 1, seed=seed)
    q_block0 = _q_along(arrays, w, plan.parts[0], jsegs[0])
    out = dict(
        n=args.n, m=args.m, p=p, train_seconds=train_s,
        segments_equal=int(sum(same)), segments=len(same),
        segments_part_at_step=parts_at, q_float64_block0=q_block0,
        block_diameter_mean={k: float(np.mean(v)) for k, v in blocks.items()},
        naive_diameter={
            "M=1 nearest": _ring_diameter(w, m1),
            f"M={args.m} nearest": _ring_diameter(w, np.concatenate(nsegs)),
            f"M={args.m} dqn": _ring_diameter(w, np.concatenate(jsegs))})
    np.savez(args.out, seed=seed, n=args.n, m=args.m, **arrays,
             **{f"seg{i}": s for i, s in enumerate(jsegs)})
    return out


def card(args) -> dict:
    import torch

    from repro_torch.core import batcheval

    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the card stage needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with batcheval.eval_options(device=dev):
        return _card(args, dev)


def _card(args, dev) -> dict:
    import torch

    from repro_torch import overlay
    from repro_torch.core import parallel as tp
    from repro_torch.core import qlearning as tq
    from repro_torch.core.diameter import diameter_scipy
    from repro_torch.core.embedding import THETAS, qparams_from_jax
    from repro_torch.core.topology import make_latency

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    ref = np.load(args.ref)
    n, m = int(ref["n"]), int(ref["m"])
    seed = int(ref["seed"])
    w = make_latency("fabric", n, seed=0)
    p = -(-n // m)
    dqn = tp.SegmentDQNConfig()
    jsegs = [ref[f"seg{i}"] for i in range(m)]
    out = dict(n=n, m=m, p=p, diameter={}, wall_s={})

    def build(label, cfg):
        sync()
        t0 = time.perf_counter()
        ov = overlay.build("parallel", w, cfg, seed=0)
        sync()
        out["wall_s"][label] = time.perf_counter() - t0
        d = ov.diameter()
        if not np.isclose(d, diameter_scipy(ov.adjacency), rtol=1e-5):
            raise AssertionError(f"{label}: diameter {d} != scipy")
        out["diameter"][label] = float(d)

    build("M=1 nearest", overlay.ParallelConfig(m=1))
    build(f"M={m} nearest", overlay.ParallelConfig(m=m))
    dcfg = tq.DQNConfig(n=p, k_rings=1, epochs=dqn.epochs,
                        eps_decay=max(dqn.epochs // 2, 1), dist=dqn.dist,
                        alpha=dqn.alpha, seed=dqn.train_seed,
                        n_envs=dqn.n_envs)
    tp._SEGMENT_PARAMS_CACHE.clear()
    tp._SEGMENT_PARAMS_CACHE[(p, dqn)] = (
        qparams_from_jax({k: ref[k] for k in THETAS}, device=dev), dcfg)
    plan = tp.plan_partitions(n, m, np.random.default_rng(seed))
    segs = tp._segments_dqn_many(w, [plan], dqn)[0]
    out["card_segments_equal_reference"] = int(sum(
        np.array_equal(a, b) for a, b in zip(segs, jsegs)))
    dqn_cfg = overlay.ParallelConfig(m=m, constructor="dqn",
                                     dqn_epochs=dqn.epochs)
    build(f"M={m} dqn, reference parameters", dqn_cfg)
    tp._SEGMENT_PARAMS_CACHE.clear()
    build(f"M={m} dqn, port's training", dqn_cfg)
    base = out["diameter"]["M=1 nearest"]
    out["ratio_to_M1"] = {k: v / base for k, v in out["diameter"].items()}

    # nearest + naive: the fast path against segments + stitch, B builds
    w32 = np.asarray(w, np.float32)
    seeds = list(range(args.builds))
    plans = [tp.plan_partitions(n, m, np.random.default_rng(s))
             for s in seeds]

    def general():
        return [tp.stitch_segments(w32, s) for s in
                tp._build_segments_many(w32, plans, "nearest", None)]

    def fast():
        return tp._nearest_merged_naive(w32, plans)

    same = all(np.array_equal(a, b) for a, b in zip(fast(), general()))
    times = {}
    for label, fn in (("fast", fast), ("general", general),
                      ("fast again", fast), ("general again", general)):
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        times[label] = (time.perf_counter() - t0) / args.reps * 1e3
    out["nearest_naive_ms"] = dict(builds=args.builds, equal=same, **times)
    if dev == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stage", choices=("reference", "card"))
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "dqn_segments.npz"))
    ap.add_argument("--ref", default=os.path.join(ROOT, "build",
                                                  "dqn_segments.npz"))
    ap.add_argument("--builds", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="card stage: 'cpu' for a dry run at a small --n")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    res = reference(args) if args.stage == "reference" else card(args)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
