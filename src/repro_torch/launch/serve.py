"""Batched serving: prefill a batch of prompts together, then decode
tokens one position at a time against the KV caches.  The loop of the JAX
package's ``launch/serve.py`` as a function, :func:`generate`, and its CLI
with the same flags plus ``--device`` and ``--cache-dtype``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --smoke --device cpu --requests 8 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \\
        --smoke --device cpu --cache-dtype fp8

Without ``--device cpu`` it runs on the CUDA card and raises where there is
none.  Weights are random, drawn from a ``torch.Generator`` seeded 0 (not
the JAX package's bits); prompts come from numpy ``default_rng(0)`` as
there.  A vision config (pixtral-12b, llama4-maverick) gets ``n_patches``
random patch embeddings per request, unit normals from a
``torch.Generator`` seeded 1, standing in for the frontend as the
reference's stub input specs do.  ``--cache-dtype`` (fp32, bf16 or fp8 =
float8_e4m3fn) sets the KV cache's dtype; the default is the parameters'.
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

__all__ = ["generate", "patch_embeddings", "main", "CACHE_DTYPE_FLAGS"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ArchConfig, params, prompts, max_new: int, max_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             vision_embeds: Optional[torch.Tensor] = None,
             cache_dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, dict]:
    """Prefill ``prompts`` (B, P) integers (after ``vision_embeds`` (B, Np,
    d), for a vision config), then decode ``max_new - 1`` more positions
    from Np + P on: returns the (B, max_new) tokens (on the parameters'
    device) and ``{"prefill_s", "decode_s"}``, wall seconds of each phase,
    ended by a device synchronise.  The KV caches are ``cache_dtype``
    (None = the parameters' dtype).

    ``temperature`` 0 is greedy (argmax, first maximum on ties: the parity
    case).  Above 0 tokens are drawn by ``torch.multinomial`` from
    ``generator``, which does not reproduce ``jax.random.categorical``'s
    bits.
    """
    device = params["embed"].device
    tokens = torch.as_tensor(np.asarray(prompts), device=device).long()
    b, plen = tokens.shape
    n_vis = 0
    if vision_embeds is not None:
        if cfg.frontend != "vision":
            raise ValueError(f"{cfg.name} has no vision frontend")
        vision_embeds = torch.as_tensor(vision_embeds, device=device)
        n_vis = vision_embeds.shape[1]
    start = n_vis + plen
    if start + max_new - 1 > max_len:
        raise ValueError(f"{n_vis} patches + prompt {plen} + {max_new - 1} "
                         f"decoded positions exceed max_len {max_len}")

    def sample(logits):
        if temperature <= 0:
            return logits.argmax(-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    caches = Mdl.init_caches(cfg, b, max_len,
                             dtype=cache_dtype or params["embed"].dtype,
                             device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches, _ = Mdl.forward(cfg, params, tokens, mode="prefill",
                                    caches=caches,
                                    vision_embeds=vision_embeds)
    out = [sample(logits)]
    _sync(device)
    t1 = time.perf_counter()
    for i in range(max_new - 1):
        logits, caches = Mdl.forward(cfg, params, out[-1][:, None],
                                     mode="decode", caches=caches,
                                     pos=start + i)
        out.append(sample(logits))
    _sync(device)
    t2 = time.perf_counter()
    return torch.stack(out, dim=1), {"prefill_s": t1 - t0,
                                     "decode_s": t2 - t1}


CACHE_DTYPE_FLAGS = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "fp8": torch.float8_e4m3fn}


def patch_embeddings(cfg: ArchConfig, batch: int, device,
                     dtype=torch.float32, seed: int = 1) -> torch.Tensor:
    """(batch, cfg.n_patches, d) unit normals from a ``torch.Generator``
    seeded ``seed`` on ``device``: the frontend's stand-in."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, cfg.n_patches, cfg.d_model), generator=gen,
                       device=device).to(dtype)


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
    ap.add_argument("--cache-dtype", default=None,
                    choices=list(CACHE_DTYPE_FLAGS),
                    help="KV-cache dtype (default: the parameters')")
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

    vis = patch_embeddings(cfg, b, dev) if cfg.frontend == "vision" \
        else None
    cache_dtype = CACHE_DTYPE_FLAGS[args.cache_dtype] if args.cache_dtype \
        else None
    tokens, t = generate(cfg, params, prompts, args.max_new, args.max_len,
                         args.temperature, gen, vision_embeds=vis,
                         cache_dtype=cache_dtype)
    tokens = tokens.cpu().numpy()
    print(f"[serve] arch={cfg.name} batch={b} prompt={args.prompt_len} "
          f"patches={0 if vis is None else vis.shape[1]} "
          f"new={args.max_new} cache={args.cache_dtype or 'params'} "
          f"device={dev}")
    print(f"[serve] prefill {t['prefill_s'] * 1e3:.1f}ms "
          f"({b * args.prompt_len / max(t['prefill_s'], 1e-9):.0f} tok/s), "
          f"decode {t['decode_s'] * 1e3:.1f}ms "
          f"({b * (args.max_new - 1) / max(t['decode_s'], 1e-9):.0f} tok/s)")
    print(f"[serve] first request continuation: {tokens[0][:16].tolist()}")
    return tokens


if __name__ == "__main__":
    main()
