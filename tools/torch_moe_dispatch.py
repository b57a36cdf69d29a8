"""Slot ranking of the port's MoE dispatch on the card: the reference's
one-hot cumsum against the port's stable sort.

    python tools/torch_moe_dispatch.py            # needs an NVIDIA GPU

The reference (``repro/models/moe.py``) ranks each routed copy among the
earlier copies to its expert by a cumsum down a (T k, E) one-hot; the
port's ``models.moe._slots`` gets the same ranks from a stable sort by
expert id.  This swaps in the reference's ranking for ``_slots`` alone and,
on moonshot-v1-16b-a3b at full width (24 of 48 layers, fp32, TF32 off,
random weights seeded 0), prints:

* ``route`` at the prefill's T = 8,192 under each ranking (ms by CUDA
  events), and whether the slots and drops are equal;
* ``launch.serve.generate`` (8 x 1024-token prompts, 32 new tokens,
  greedy) under each, in turns (cumsum, sort, sort, cumsum): prefill and
  decode times, and whether the tokens are equal.

Each line carries the card's name and power limit.  Exits 1 without a
CUDA device.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def onehot_cumsum_slots(eid_f):
    """``models.moe._slots`` by the reference's ranking (``moe.py:70-71``):
    a cumsum down the one-hot of the expert ids (as wide as the largest
    id; the gather reads only routed experts' columns)."""
    import torch.nn.functional as F

    return F.one_hot(eid_f).cumsum(0).gather(1, eid_f[:, None])[:, 0] - 1


def event_ms(fn, reps: int = 20) -> float:
    """Mean device ms per call of ``fn`` by CUDA events, after a warm-up."""
    import torch

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_moe_dispatch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as Mdl
    from repro_torch.models import moe

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"), n_layers=24)
    rankings = {"cumsum": onehot_cumsum_slots, "sort": moe._slots}

    probs = torch.softmax(1.4 * torch.randn(
        8192, cfg.n_experts, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1)), dim=-1)
    cap = moe._capacity(8192, cfg)
    params = Mdl.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(8, 1024))
    routed, tokens = {}, {}
    try:
        for name in rankings:
            moe._slots = rankings[name]
            ms = event_ms(lambda: moe.route(probs, cfg, cap))
            routed[name] = moe.route(probs, cfg, cap)
            print(f"route, T=8192 ({name}): {ms:.4f} ms [{card}]")
        a, b = routed.values()
        print(f"same slots and drops: {torch.equal(a[2], b[2])} "
              f"{torch.equal(a[3], b[3])}")
        for name in ("cumsum", "sort", "sort", "cumsum"):
            moe._slots = rankings[name]
            generate(cfg, params, prompts, 3, 1056)          # warm-up
            tok, t = generate(cfg, params, prompts, 32, 1056)
            tokens.setdefault(name, tok.cpu())
            print(f"{name}: prefill {t['prefill_s']:.4f} s "
                  f"({8192 / t['prefill_s']:.1f} tok/s), decode "
                  f"{t['decode_s'] / 31 * 1e3:.2f} ms a step [{card}]")
    finally:
        moe._slots = rankings["sort"]
    print(f"tokens equal: {torch.equal(tokens['cumsum'], tokens['sort'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
