"""Mixture-of-Experts layer: top-k routing and capacity-based dispatch (the
JAX package's ``models/moe.py``, its one-device path).

Each token's router probabilities pick k experts; a routed copy's slot in
its expert's buffer is its rank among the earlier copies sent to the same
expert, in token-major, slot-minor order, and copies at slot >= C (the
static capacity ``_capacity``) are dropped (Switch / GShard semantics).
The experts run as batched SwiGLU products over (E, C, d) buffers; each
token's output adds its kept copies' outputs, weighted by their
renormalised gates, in slot order.

Every step is deterministic on CUDA, forward and backward, so a layer run
twice (or recomputed under remat) is bitwise the same:

* top-k ties go to the lower expert id, as ``jax.lax.top_k`` breaks them
  (a stable descending sort; ``torch.topk`` promises no order);
* a token's k copies are an ``expand`` of its row, so their gradient is a
  sum over k rather than a scatter-add;
* the buffer is filled by writing each kept copy to its own row; every
  dropped copy goes to one dump row past the end, which is sliced off;
* the combine gathers from the expert output padded with a zero row (a
  dropped copy reads it) and adds the k slots in order, ``c0 + c1 + ...``,
  the JAX CPU scatter-add's order; no ``index_add_`` (atomics) anywhere.

The expert parallel path over a mesh (the reference's ``shard_map``) is
not ported: ``moe_apply`` raises for a mesh (ROADMAP Queue A item 13f).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import dense_init

__all__ = ["init_moe", "moe_apply", "route", "dispatch_codes",
           "router_aux_loss"]

Params = Dict[str, torch.Tensor]


def init_moe(generator: Optional[torch.Generator], cfg: ArchConfig, dtype,
             device, lead: Tuple[int, ...] = ()) -> Params:
    """Router (d, E), always fp32 (routing-sensitive), and the experts'
    (E, d, f) gate / up and (E, f, d) down weights, each normal x
    sqrt(2 / (d + f)), drawn in that order from ``generator``."""
    d, fe, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    lead = tuple(lead)
    return {
        "router": dense_init(generator, d, e, torch.float32, device, lead),
        "w_gate": dense_init(generator, d, fe, dtype, device, lead + (e,)),
        "w_up": dense_init(generator, d, fe, dtype, device, lead + (e,)),
        "w_down": dense_init(generator, fe, d, dtype, device, lead + (e,)),
    }


def _capacity(t: int, cfg: ArchConfig) -> int:
    """Copies an expert takes from t tokens: int(t k cf / E) + 1, rounded up
    to a multiple of 4, at least 4."""
    c = int(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, -(-c // 4) * 4)


def _slots(eid_f: torch.Tensor) -> torch.Tensor:
    """(T k,) rank of each routed copy among the earlier copies to its
    expert, for expert ids ``eid_f`` in token-major, slot-minor order.

    The reference ranks copies by a cumsum down a (T k, E) one-hot; here a
    stable sort by expert id keeps each expert's copies in that order, so
    a copy's rank is its sorted position less its expert's first one: the
    same slots, where the one-hot cumsum took ~13 ms a layer on an H100 at
    moonshot's prefill shape (T k = 49,152)."""
    by_expert, order = torch.sort(eid_f, stable=True)
    rank = torch.arange(eid_f.numel(), device=eid_f.device) - \
        torch.searchsorted(by_expert, by_expert)
    return torch.empty_like(rank).index_copy_(0, order, rank)


def route(probs: torch.Tensor, cfg: ArchConfig, capacity: int):
    """Dispatch of (T, E) router probabilities: ``(gate, eid, slot, keep)``.
    gate / eid (T, k): the top-k probabilities renormalised to sum to 1 and
    their expert ids, ties to the lower id; slot / keep (T k,): each copy's
    rank among the earlier copies to its expert (``_slots``) and whether it
    is under ``capacity``."""
    eid = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :cfg.top_k]
    gate = probs.gather(1, eid)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    slot = _slots(eid.reshape(-1))
    return gate, eid, slot, slot < capacity


def dispatch_codes(probs: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(T, E) int8 summary of the dispatch of (T, E) router probabilities:
    0 = expert not routed, 1 = routed and dropped (over capacity), 2 =
    routed and kept.  Two runs of a layer dispatched alike where their
    codes are equal."""
    t = probs.shape[0]
    _, eid, _, keep = route(probs, cfg, _capacity(t, cfg))
    codes = torch.zeros((t, cfg.n_experts), dtype=torch.int8,
                        device=probs.device)
    return codes.scatter_(1, eid, 1 + keep.reshape(eid.shape).to(torch.int8))


def _moe_local(router, w_gate, w_up, w_down, xf: torch.Tensor,
               cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE body on (T, d) tokens with all E experts: (y (T, d), router
    probabilities (T, E) in fp32)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(t, cfg)

    probs = torch.softmax(xf.float() @ router, dim=-1)         # (T, E)
    gate, eid, slot, keep = route(probs, cfg, c)
    # each kept copy's row in the (E C) buffer; dropped ones -> row E C
    didx = torch.where(keep, eid.reshape(-1) * c + slot, e * c)
    copies = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xf.new_zeros((e * c + 1, d)).index_copy(0, didx, copies)

    h = buf[:e * c].reshape(e, c, d)
    act = F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_up)
    out = torch.bmm(act, w_down).reshape(e * c, d)

    # gather back (a dropped copy reads the zero row), weight by the gate,
    # and add each token's k copies in slot order
    picked = torch.cat([out, out.new_zeros((1, d))])[didx]
    contrib = (picked * gate.reshape(-1, 1).to(picked.dtype)).reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y, probs


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d), router probabilities (B S, E) for the aux loss) of
    x (B, S, d) on one device.  A ``mesh`` (the reference's expert-parallel
    path) raises."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_apply over a mesh (expert parallelism) is not ported "
            "(ROADMAP Queue A item 13f); pass mesh=None")
    b, s, d = x.shape
    y, probs = _moe_local(p["router"], p["w_gate"], p["w_up"], p["w_down"],
                          x.reshape(b * s, d), cfg)
    return y.reshape(b, s, d), probs


def router_aux_loss(probs: torch.Tensor,
                    eid_top1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch-style load-balancing loss E * sum_e f_e * p_e: f_e the share of
    tokens whose top-1 choice is e (first maximum on ties), p_e the mean
    router probability of e."""
    e = probs.shape[-1]
    if eid_top1 is None:
        eid_top1 = torch.argmax(probs, dim=-1)
    f = F.one_hot(eid_top1, e).float().mean(0)
    return e * torch.sum(f * probs.mean(0))
