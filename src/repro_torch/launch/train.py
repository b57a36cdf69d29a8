"""Training launcher: the JAX package's ``launch/train.py`` on one device.

Wires the port's pieces together: random parameters from a seeded torch
generator -> the deterministic data pipeline -> ``train_step`` (remat +
microbatching) -> async checkpointing -> the per-host straggler EWMA of
``membership.elastic``.  Same flags and printed lines (``[train]``,
``step ...``, ``[ckpt] ...``, ``[done] ...``), plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --steps 20 --batch 8 --seq 64 --device cpu

Without ``--device cpu`` it runs on the CUDA card and raises where there is
none.  ``--mesh none`` only: the production meshes (``single``, ``multi``)
are built (``launch.mesh.make_production_mesh``) and their collectives run
(``train.collectives``, ``train.pod_compress``), but they shard parameters
over a ``model`` axis, and the tensor-parallel model code and sharding
specs they need are not ported (the rest of ROADMAP Queue A item 13f).
The SSM families train too (``--arch falcon-mamba-7b`` or ``zamba2-7b``).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint.checkpoint import AsyncCheckpointer, latest_steps, restore
from ..configs import get_arch
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device, upload
from ..membership.elastic import HostState, update_ewma
from ..train.optimizer import AdamWConfig, warmup_cosine
from ..train.train_step import TrainConfig, init_state, train_step

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none", help="production mesh (not ported)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the mesh and the collectives are ported "
            f"(launch.mesh, train.collectives), but the production mesh's "
            f"model axis needs tensor parallelism, the rest of ROADMAP "
            f"Queue A item 13f, which is not; use --mesh none")
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab}")

    tc = TrainConfig(
        optimizer=AdamWConfig(
            lr=args.lr, weight_decay=0.1,
            schedule=warmup_cosine(args.lr, warmup=max(args.steps // 20, 5),
                                   total=args.steps)),
        remat=not args.smoke,
        microbatches=args.microbatches,
    )
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and latest_steps(args.ckpt_dir):
        state, start_step = restore(args.ckpt_dir, state)
        print(f"[ckpt] resumed from step {start_step}")

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch,
                                  mean_doc_len=args.seq / 2))
    # per-host heartbeat EWMA (this process is host 0)
    host = HostState(host_id=0)

    t_start = time.time()
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = {k: upload(v, dev) for k, v in data.batch(step).items()}
        state, metrics = train_step(cfg, tc, state, batch)
        loss = float(metrics["loss"])          # waits for the step
        losses.append(loss)
        dt = time.time() - t0
        update_ewma(host, dt * 1e3)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"ce {float(metrics['ce']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt * 1e3:7.1f}ms")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, state)
    if ckpt:
        ckpt.save_async(args.steps, state)
        ckpt.wait()
        print(f"[ckpt] final checkpoint at {ckpt.last_committed}")
    wall = time.time() - t_start
    n_tok = (args.steps - start_step) * args.batch * args.seq
    if losses:
        print(f"[done] {args.steps} steps, {wall:.1f}s, "
              f"{n_tok / wall:.0f} tok/s, loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
