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

**Expert parallelism** (``moe_apply(mesh=...)``, the reference's
``shard_map`` body): the tokens are replicated over the ``model`` axis, so
every rank routes all of them identically, fills only its ``E / m``
experts' buffers (ids from ``rank x E / m``), runs their batched SwiGLU,
combines its copies in slot order (zero for another rank's) and the
ranks' partial outputs are summed over the model group
(``distributed.reduce_from``).  The tokens and the gate probabilities
enter the rank's part through ``distributed.copy_to``, so the router's
gradient is whole on every rank; the router probabilities returned (for
the aux loss) are gathered over the data axes, as the reference's
``out_specs`` gather them.  Each data shard routes its own tokens, with
the capacity of its own token count, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import distributed as D
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
               cfg: ArchConfig, e_local: Optional[int] = None,
               e_offset: int = 0,
               group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE body on (T, d) tokens with the ``e_local`` experts from id
    ``e_offset`` (default: all E): (y (T, d), router probabilities (T, E)
    in fp32).  ``group``: the model group whose ranks hold the other
    experts (y is then summed over it)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    e_local = e if e_local is None else e_local
    c = _capacity(t, cfg)

    probs = torch.softmax(xf.float() @ router, dim=-1)         # (T, E)
    xs, ps = xf, probs
    if group is not None:
        xs, ps = D.copy_to(xf, group), D.copy_to(probs, group)
    gate, eid, slot, keep = route(ps, cfg, c)
    # each kept copy of this rank's experts: its row in the (E_l C)
    # buffer; every other copy -> row E_l C
    lid = eid.reshape(-1) - e_offset
    mine = keep & (lid >= 0) & (lid < e_local)
    didx = torch.where(mine, lid * c + slot, e_local * c)
    copies = xs[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xs.new_zeros((e_local * c + 1, d)).index_copy(0, didx, copies)

    h = buf[:e_local * c].reshape(e_local, c, d)
    act = F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_up)
    out = torch.bmm(act, w_down).reshape(e_local * c, d)

    # gather back (another rank's or a dropped copy reads the zero row),
    # weight by the gate, and add each token's k copies in slot order
    picked = torch.cat([out, out.new_zeros((1, d))])[didx]
    contrib = (picked * gate.reshape(-1, 1).to(picked.dtype)).reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    if group is not None:
        y = D.reduce_from(y, group)
    return y, probs


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, mesh=None,
              model_axis: str = "model",
              data_axes: Tuple[str, ...] = ("data",)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d), router probabilities (B S, E) for the aux loss) of x
    (B, S, d).  With a ``mesh`` holding ``model_axis``, expert parallel
    (the module docstring): ``p``'s experts are this rank's E / m, x is
    this rank's data shard, and the probabilities are gathered over
    ``data_axes``.  Raises unless E divides by the model axis."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    if mesh is None or model_axis not in mesh.shape:
        y, probs = _moe_local(p["router"], p["w_gate"], p["w_up"],
                              p["w_down"], xf, cfg)
        return y.reshape(b, s, d), probs
    m = mesh.shape[model_axis]
    if cfg.n_experts % m:
        raise ValueError(f"{cfg.n_experts} experts do not divide over a "
                         f"{m}-way {model_axis!r} axis")
    e_local = cfg.n_experts // m
    if p["w_gate"].shape[0] != e_local:
        raise ValueError(f"expert parallel over {m} ranks: this rank holds "
                         f"{p['w_gate'].shape[0]} experts, not {e_local}")
    group = mesh.group(model_axis) if m > 1 else None
    y, probs = _moe_local(p["router"], p["w_gate"], p["w_up"], p["w_down"],
                          xf, cfg, e_local=e_local,
                          e_offset=mesh.axis_index(model_axis) * e_local,
                          group=group)
    data = tuple(a for a in data_axes if a in mesh.shape)
    if data and mesh.axis_size(data) > 1:
        probs = D.gather_from(probs, mesh.group(data), dim=0)
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
