"""Manual data-parallel training with int8-compressed gradient all-reduce
over the DGRO ring, in the PyTorch port: the twin of
``examples/compressed_dp.py`` over ``torch.distributed``.

    PYTHONPATH=src python examples/torch_compressed_dp.py --ranks 8 --device cpu
    PYTHONPATH=src python examples/torch_compressed_dp.py --ranks 4 --device cuda

Spawns ``--ranks`` processes (gloo over a ``FileStore`` in a temporary
directory), each a host of the ring; with ``--device cuda`` every rank
computes on ``cuda:0`` and gloo stages the ring's int8 payloads through
pinned host buffers.  Each rank trains musicgen-large's smoke config on its
2 rows of a global batch of 2N x 64 tokens for 12 steps: local gradients,
the int8 ring all-reduce with error feedback
(``repro_torch.train.collectives``), then the same AdamW update (lr 2e-3)
on every rank.  Prints the reference example's lines, and whether the
ranks' final parameters are bitwise equal (exit 1 if not).
"""
import argparse
import hashlib
import sys

import numpy as np
import torch

from repro_torch import distributed as D
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as Mdl
from repro_torch.train.collectives import compressed_grad_allreduce
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, tree_leaves, tree_like)
from repro_torch.train.train_step import TrainConfig, loss_and_grads

STEPS, SEQ, ROWS = 12, 64, 2


def host(rank: int, world: int, device: str):
    """One host of the ring: returns its printed lines and a digest of its
    final parameters."""
    dev = resolve_device(device)
    cfg = get_arch("musicgen-large").smoke()
    # the example's loss is the plain cross-entropy: no z-loss, no aux
    tc = TrainConfig(remat=False, z_weight=0.0, aux_weight=0.0)
    opt_cfg = AdamWConfig(lr=2e-3)
    params = Mdl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    opt = adamw_init(params)
    err = tree_like(params, [torch.zeros(p.shape, dtype=torch.float32,
                                         device=dev)
                             for p in tree_leaves(params)])
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=world * ROWS))
    group = Mesh(np.arange(world), ("data",)).group("data")
    lines = []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v[rank * ROWS:(rank + 1) * ROWS]).to(dev)
                 for k, v in data.batch(i).items()}
        loss, _, grads = loss_and_grads(cfg, tc, params, batch)
        grads, err = compressed_grad_allreduce(grads, group, err)
        params, opt, gnorm = adamw_update(opt_cfg, grads, opt, params)
        loss = D.pmean(loss, group)
        if i % 2 == 0:
            lines.append(f"step {i:3d} loss {float(loss):7.4f} "
                         f"gnorm {float(gnorm):6.3f}")
    digest = hashlib.sha256()
    for p in tree_leaves(params):
        digest.update(p.detach().cpu().numpy().tobytes())
    return lines, digest.hexdigest(), dict(vars(D.TRAFFIC))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; every rank on cuda:0) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    resolve_device(args.device)              # fail here, not in the ranks
    print(f"== compressed DP: {args.ranks} hosts, int8 ring all-reduce ==")
    results = D.spawn_ranks(host, args.ranks, args=(args.device,),
                            timeout=args.timeout)
    for line in results[0][0]:
        print(line)
    equal = len({digest for _, digest, _ in results}) == 1
    traffic = results[0][2]
    print(f"[example] rank 0: {traffic['hops']} ring hops, "
          f"{traffic['bytes_received']} bytes received, "
          f"{traffic['bytes_staged']} bytes staged through the host")
    print(f"[example] ranks' final parameters equal: {equal}")
    if not equal:
        return 1
    print("[example] OK: trained with 4x-compressed DCN gradient traffic")
    return 0


if __name__ == "__main__":
    sys.exit(main())
