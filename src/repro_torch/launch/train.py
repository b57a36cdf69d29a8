"""Training launcher: the JAX package's ``launch/train.py`` on one device.

Wires the port's pieces together: random parameters from a seeded torch
generator -> the deterministic data pipeline -> ``train_step`` (remat +
microbatching) -> async checkpointing -> the per-host straggler EWMA of
``membership.elastic``.  Same flags and printed lines (``[train]``,
``step ...``, ``[ckpt] ...``, ``[done] ...``), plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --smoke --steps 20 --batch 8 --seq 64 --device cpu

Without ``--device cpu`` it runs on the CUDA card and raises where there is
none.  The SSM families train too (``--arch falcon-mamba-7b`` or
``zamba2-7b``).

``--mesh single|multi`` trains over the production mesh, as the reference
does: ``make_production_mesh(multi_pod=..., dgro_order=True)`` ((16, 16)
over ("data", "model"), or (2, 16, 16) with a "pod" axis), its DGRO report
printed as ``[mesh] DGRO order: ...``; the state placed by
``state_specs`` (ZeRO moments) and each batch by ``batch_specs``
(``local_batch``: with ``--microbatches``, each rank holds its part of
every microbatch of the global batch); the step tensor / expert parallel
(``train_step``).  The reference's ``default_rules`` only constrain its
partitioner's activation layouts; the port's tensor-parallel code lays
them out itself, so it reads no rules.
Ranks are started as ``torchrun`` starts them: each process reads
``RANK`` / ``WORLD_SIZE`` (and ``MASTER_ADDR`` / ``MASTER_PORT``) and
joins the process group (gloo with ``--device cpu``, NCCL on the cards,
``LOCAL_RANK`` picking the card), unless the caller has started one.  A
world that is not the mesh (256 or 512 ranks) raises, naming both sizes.
Every rank draws the whole initial parameters from the seed and keeps its
blocks (``init_sharded_state``); only rank 0 prints.  The SSM / hybrid
families over a model axis are not ported (ROADMAP Queue A item 13f).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import distributed as D
from ..checkpoint.checkpoint import AsyncCheckpointer, latest_steps, restore
from ..configs import get_arch
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device, upload
from ..membership.elastic import HostState, update_ewma
from ..train.optimizer import AdamWConfig, warmup_cosine
from ..train.train_step import (TrainConfig, init_sharded_state,
                                init_state, state_layout, train_step)
from .mesh import make_production_mesh
from .shardings import local_batch, to_shardings

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
                    default="none", help="production mesh (one rank a "
                    "position, started as torchrun starts them)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.mesh == "none":
        mesh, data_axes = None, ("data",)
    else:
        _join_from_env(dev)
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    dgro_order=True)
        data_axes = ("pod", "data") if args.mesh == "multi" else ("data",)
        mesh.group("model")          # raises unless the world is the mesh
    say = print if D.rank() == 0 else _quiet
    say(f"[train] arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
        f"vocab={cfg.vocab}")
    if mesh is not None and hasattr(mesh, "dgro_report"):
        say(f"[mesh] DGRO order: {mesh.dgro_report}")

    tc = TrainConfig(
        optimizer=AdamWConfig(
            lr=args.lr, weight_decay=0.1,
            schedule=warmup_cosine(args.lr, warmup=max(args.steps // 20, 5),
                                   total=args.steps)),
        remat=not args.smoke,
        microbatches=args.microbatches,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = shardings = None
    if mesh is None:
        state = init_state(cfg, gen, device=dev)
    else:
        specs = state_layout(cfg, mesh, data_axes)
        state = init_sharded_state(cfg, specs, mesh, D.rank(), gen,
                                   device=dev)
        shardings = to_shardings(specs, mesh)
    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and latest_steps(args.ckpt_dir):
        state, start_step = restore(args.ckpt_dir, state,
                                    shardings=shardings)
        say(f"[ckpt] resumed from step {start_step}")

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch,
                                  mean_doc_len=args.seq / 2))

    def local(batch):
        if mesh is None:
            return batch
        whole = {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: v.numpy() for k, v in local_batch(
            whole, mesh, D.rank(), data_axes, args.microbatches).items()}
    # per-host heartbeat EWMA (this process is host 0)
    host = HostState(host_id=0)

    t_start = time.time()
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = {k: upload(v, dev)
                 for k, v in local(data.batch(step)).items()}
        state, metrics = train_step(cfg, tc, state, batch, mesh=mesh,
                                    data_axes=data_axes, specs=specs)
        loss = float(metrics["loss"])          # waits for the step
        losses.append(loss)
        dt = time.time() - t0
        update_ewma(host, dt * 1e3)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:8.4f} "
                f"ce {float(metrics['ce']):8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"{dt * 1e3:7.1f}ms")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, state, shardings=shardings)
    if ckpt:
        ckpt.save_async(args.steps, state, shardings=shardings)
        ckpt.wait()
        say(f"[ckpt] final checkpoint at {ckpt.last_committed}")
    wall = time.time() - t_start
    n_tok = (args.steps - start_step) * args.batch * args.seq
    if losses:
        say(f"[done] {args.steps} steps, {wall:.1f}s, "
            f"{n_tok / wall:.0f} tok/s, loss {losses[0]:.3f} -> "
            f"{losses[-1]:.3f}")
    return losses


def _quiet(*_args, **_kw) -> None:
    """``print`` on ranks other than 0."""


def _join_from_env(dev: torch.device) -> None:
    """Join the process group as a ``torchrun`` rank (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``), where the caller
    has not started one and the environment names a world."""
    if D.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    D.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                         int(os.environ["RANK"]),
                         int(os.environ["WORLD_SIZE"]), "env://")


if __name__ == "__main__":
    main()
