"""Roofline terms of a counted step, on the NVIDIA H100 (torch port of
``repro.roofline.analysis``).

    compute_s    = FLOPs_per_rank / peak_flops(the GEMMs' dtype)
    memory_s     = bytes_per_rank / HBM_BW
    collective_s = collective_bytes_per_rank / COLLECTIVE_BW

The reference reads these inputs from a compiled SPMD executable
(``cost_analysis()`` and the HLO text); the port counts them by running
rank 0's step once on the ``meta`` device (``roofline.walk``), so every
term is already per rank.  Collective bytes apply the ring-transfer factor
of each op kind and group size (:func:`ring_transfer`, the reference's
formulas).

MODEL_FLOPS = 6*N*D (N = active params, D = tokens per step) is the
"useful work" cross-check: MODEL_FLOPS / (counted FLOPs * ranks) exposes
remat recompute, masked-attention waste and dispatch overhead.

No counterpart: ``parse_collectives`` and its regexes read collectives out
of HLO text, which the port does not have; the port's collectives
(``repro_torch.distributed``) report each call to the walk instead.

The hardware table is the single source of the card's peaks for the port:
``chip_smoke.py``'s bounds import them from here.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

import torch

__all__ = ["PEAK_FLOPS", "FP32_FLOP_PER_S", "TF32_FLOP_PER_S",
           "BF16_FLOP_PER_S", "SFU_PER_S", "HBM_BW", "HBM_BYTES",
           "COLLECTIVE_BW", "NVLINK_BW", "peak_flops", "Collective",
           "ring_transfer", "Roofline", "roofline_from", "model_flops",
           "active_param_count", "COLLECTIVE_OPS"]

# --- NVIDIA H100 SXM 80GB (data sheet), per GPU -----------------------------
# fp32 on the CUDA cores (an FMA counts as two FLOP), dense TF32 and dense
# bf16 on the tensor cores
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 494.7e12
BF16_FLOP_PER_S = 989.4e12
PEAK_FLOPS = {torch.float32: FP32_FLOP_PER_S, torch.bfloat16: BF16_FLOP_PER_S,
              torch.float16: BF16_FLOP_PER_S}
# the special-function units: 16 results a clock an SM, 132 SMs, 1.98 GHz
SFU_PER_S = 16 * 132 * 1.98e9
HBM_BW = 3.35e12             # bytes/s (HBM3)
HBM_BYTES = 80e9
# Collective bandwidth per rank: NDR InfiniBand at 400 Gb/s a GPU in a DGX
# H100 pod.  The production mesh's 256 / 512 ranks span 32 / 64 nodes and
# its 16-wide model axis is wider than a node's 8 NVLink-connected GPUs,
# so its rings cross the network.  NVLink (450e9 B/s a direction) is kept
# for the record only.
COLLECTIVE_BW = 50e9
NVLINK_BW = 450e9

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")


def peak_flops(dtype) -> float:
    """The card's peak FLOP/s for GEMMs in ``dtype`` (fp32 on the CUDA
    cores; bf16 / fp16 dense)."""
    if dtype not in PEAK_FLOPS:
        raise ValueError(f"no peak for GEMMs in {dtype}")
    return PEAK_FLOPS[dtype]


@dataclasses.dataclass
class Collective:
    op: str
    result_bytes: int
    group_size: int
    transfer_bytes: float    # ring-model bytes sent per rank


def ring_transfer(op: str, result_bytes: float, group_size: int) -> float:
    """Ring-model bytes a rank sends for one collective of ``op`` whose
    result is ``result_bytes`` over ``group_size`` ranks (the reference's
    formulas).  A group of one transfers nothing, but a collective-permute
    sends its result whatever the group, as the reference's parser counts
    it (its HLO names pairs, not a group)."""
    if op not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {op!r}")
    g = int(group_size)
    b = float(result_bytes)
    if op == "collective-permute":
        return b
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * b * (g - 1) / g
    if op == "all-gather":
        # the result holds the gathered value; each rank sends its shard
        return b * (g - 1) / g
    if op == "reduce-scatter":
        # the result is the scattered shard; the input is result * g
        return b * (g - 1)
    return b * (g - 1) / g                    # all-to-all


@dataclasses.dataclass
class Roofline:
    flops: float               # per rank
    hbm_bytes: float           # per rank
    collective_bytes: float    # per rank (ring-model transferred)
    collective_raw_bytes: float  # naive sum of the collectives' results
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    n_collectives: int
    by_op: Dict[str, float]

    def to_dict(self):
        return dataclasses.asdict(self)


def _dominant(compute_s: float, memory_s: float, collective_s: float) -> str:
    return max((("compute", compute_s), ("memory", memory_s),
                ("collective", collective_s)), key=lambda kv: kv[1])[0]


def roofline_from(costs, dtype) -> Roofline:
    """The roofline terms of a walk's ``costs`` (``walk.WalkCosts``): the
    FLOPs of the counted GEMMs and of the kernels, and their bytes, at the
    peak of ``dtype`` (the step's GEMMs') and the HBM rate; the
    collectives at :data:`COLLECTIVE_BW`."""
    flops = costs.dot_flops + sum(k["flops"] for k in
                                  costs.by_kernel.values())
    hbm = costs.naive_bytes + sum(k["bytes"] for k in
                                  costs.by_kernel.values())
    compute_s = flops / peak_flops(dtype)
    memory_s = hbm / HBM_BW
    collective_s = costs.collective_bytes / COLLECTIVE_BW
    return Roofline(
        flops=flops, hbm_bytes=hbm, collective_bytes=costs.collective_bytes,
        collective_raw_bytes=float(sum(c.result_bytes
                                       for c in costs.collectives)),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=_dominant(compute_s, memory_s, collective_s),
        n_collectives=len(costs.collectives),
        by_op=dict(costs.collective_by_op))


def model_flops(cfg, n_tokens: int, n_active_params: int) -> float:
    """6 * N_active * D (the standard training-FLOPs estimate; for inference
    steps callers pass the per-step token count)."""
    return 6.0 * n_active_params * n_tokens


def active_param_count(cfg, params) -> int:
    """Active params per token: total minus the non-routed share of experts.
    ``params`` is the port's tree (nested dicts of tensors, on ``meta`` or
    anywhere); a leaf is an expert weight where its path's ``keystr`` (the
    reference's key names) holds ``moe`` and ``w_gate`` / ``w_up`` /
    ``w_down``."""
    from ..launch.shardings import keystr, tree_map_with_path

    sizes = []
    tree_map_with_path(lambda path, leaf: sizes.append(
        (keystr(path), int(leaf.numel()))), params)
    total = sum(n for _, n in sizes)
    if cfg.n_experts == 0:
        return total
    moe_params = sum(n for k, n in sizes
                     if "moe" in k and re.search(r"w_(gate|up|down)", k))
    return total - moe_params + int(moe_params * cfg.top_k / cfg.n_experts)
