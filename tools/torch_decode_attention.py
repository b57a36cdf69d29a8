"""Decode steps of the port with K6 ``decode_attention`` against the same
steps with its plain twin, on the card, in turns.

    python3 tools/torch_decode_attention.py [--arch pixtral-12b]
        [--steps 8] [--rounds 3]

Serves ``--arch`` at full width and depth (fp32 weights from a
``torch.Generator`` seeded 0; 8 prompts of 1024 tokens from numpy
``default_rng(0)``, after ``n_patches`` random patch embeddings for a
vision config), prefills an fp32 and an fp8 KV cache once each, then times
``--steps`` greedy decode steps on each cache (host clock, ended by a
device synchronise), alternately with K6 (the port's path) and with the
plain twin (``decode_attention_ref``: the cache widened to fp32 in device
memory, the reference's masked softmax), ``--rounds`` times in turns, and
prints each run's ms a step, the medians and K6's launches.  The decode
steps rewrite the same cache positions every run.  Prints the card's name
and power limit; exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pixtral-12b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_decode_attention: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.launch.serve import patch_embeddings
    from repro_torch.models import model as Mdl

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_arch(args.arch)
    b, plen = 8, 1024
    params = Mdl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(b, plen)), device=dev)
    vis = patch_embeddings(cfg, b, dev) if cfg.frontend == "vision" \
        else None
    start = plen + (0 if vis is None else vis.shape[1])
    max_len = start + args.steps
    kernel = da_ops._decode_kernel

    caches, first = {}, {}
    with torch.no_grad():
        for name, dt in (("fp32", torch.float32),
                         ("fp8", torch.float8_e4m3fn)):
            c = Mdl.init_caches(cfg, b, max_len, dt, device=dev)
            logits, caches[name], _ = Mdl.forward(
                cfg, params, prompts, mode="prefill", caches=c,
                vision_embeds=vis)
            first[name] = logits.argmax(-1)

        def run(name: str, path: str) -> float:
            da_ops._decode_kernel = kernel if path == "K6" else \
                decode_attention_ref
            x = first[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(args.steps):
                lg, _ = Mdl.forward(cfg, params, x[:, None], mode="decode",
                                    caches=caches[name], pos=start + i)
                x = lg.argmax(-1)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / args.steps * 1e3

        order = [(n, p) for n in ("fp32", "fp8") for p in ("K6", "twin")]
        for n, p in order:                                  # warm-up
            run(n, p)
        times = {k: [] for k in order}
        da.FAMILY.reset_launches()
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                times[k].append(run(*k))
        da_ops._decode_kernel = kernel
    print(f"{cfg.name}, batch {b}, decode from position {start}, "
          f"{args.steps} steps a run, {args.rounds} runs in turns "
          f"[{card}]")
    for (n, p), ts in times.items():
        print(f"  {n} cache, {p}: ms a step {[round(t, 3) for t in ts]}, "
              f"median {float(np.median(ts)):.3f}")
    print(f"  K6 launches over the K6 runs: {da.launches['decode_attention']}"
          f" (expected {2 * args.rounds * args.steps * cfg.n_layers})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
