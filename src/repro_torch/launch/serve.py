"""Batched serving: prefill a batch of prompts together, then decode
tokens one position at a time against the KV caches.  The loop of the JAX
package's ``launch/serve.py`` as a function, :func:`generate`, and its CLI
with the same flags plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --smoke --device cpu --requests 8 --max-new 32

Without ``--device cpu`` it runs on the CUDA card and raises where there is
none.  Weights are random, drawn from a ``torch.Generator`` seeded 0 (not
the JAX package's bits); prompts come from numpy ``default_rng(0)`` as
there.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import model as Mdl

__all__ = ["generate", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ArchConfig, params, prompts, max_new: int, max_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, dict]:
    """Prefill ``prompts`` (B, P) integers, then decode ``max_new - 1`` more
    positions: returns the (B, max_new) tokens (on the parameters' device)
    and ``{"prefill_s", "decode_s"}``, wall seconds of each phase, ended by a
    device synchronise.

    ``temperature`` 0 is greedy (argmax, first maximum on ties: the parity
    case).  Above 0 tokens are drawn by ``torch.multinomial`` from
    ``generator``, which does not reproduce ``jax.random.categorical``'s
    bits.
    """
    device = params["embed"].device
    tokens = torch.as_tensor(np.asarray(prompts), device=device).long()
    b, plen = tokens.shape
    if plen + max_new - 1 > max_len:
        raise ValueError(f"prompt {plen} + {max_new - 1} decoded positions "
                         f"exceed max_len {max_len}")

    def sample(logits):
        if temperature <= 0:
            return logits.argmax(-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    caches = Mdl.init_caches(cfg, b, max_len, dtype=params["embed"].dtype,
                             device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches, _ = Mdl.forward(cfg, params, tokens, mode="prefill",
                                    caches=caches)
    out = [sample(logits)]
    _sync(device)
    t1 = time.perf_counter()
    for i in range(max_new - 1):
        logits, caches = Mdl.forward(cfg, params, out[-1][:, None],
                                     mode="decode", caches=caches,
                                     pos=plen + i)
        out.append(sample(logits))
    _sync(device)
    t2 = time.perf_counter()
    return torch.stack(out, dim=1), {"prefill_s": t1 - t0,
                                     "decode_s": t2 - t1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = Mdl.init_params(cfg, gen, device=dev)
    b = args.requests
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(b, args.prompt_len))

    tokens, t = generate(cfg, params, prompts, args.max_new, args.max_len,
                         args.temperature, gen)
    tokens = tokens.cpu().numpy()
    print(f"[serve] arch={cfg.name} batch={b} prompt={args.prompt_len} "
          f"new={args.max_new} device={dev}")
    print(f"[serve] prefill {t['prefill_s'] * 1e3:.1f}ms "
          f"({b * args.prompt_len / max(t['prefill_s'], 1e-9):.0f} tok/s), "
          f"decode {t['decode_s'] * 1e3:.1f}ms "
          f"({b * (args.max_new - 1) / max(t['decode_s'], 1e-9):.0f} tok/s)")
    print(f"[serve] first request continuation: {tokens[0][:16].tolist()}")
    return tokens


if __name__ == "__main__":
    main()
