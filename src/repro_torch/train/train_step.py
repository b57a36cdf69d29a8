"""Training step: masked cross-entropy + AdamW, microbatch gradient
accumulation, remat (the JAX package's ``train/train_step.py`` over torch
tensors).

Label convention: ``labels < 0`` positions (padding, doc boundaries) are
excluded from the loss.

Gradients come from ``torch.autograd``: on CUDA with ``impl="flash"`` the
forward runs K3, K4 and K5 and the backward K3b, K4b and K5b; JAX takes
the same gradient by autodiff of its plain jnp forward.  The microbatch
loop is a Python loop where the reference has a ``lax.scan``; it sums in
the same order.  Parameters are the port's tree (nested dicts of tensors, the JAX
layout); a step returns new tensors and leaves the old ones as they were.

**Over a mesh** (``mesh``, ``data_axes``; the reference's ``jit`` with
``state_specs`` / ``batch_specs`` shardings under ``default_rules``): the
state holds this rank's blocks by ``launch.shardings.state_specs``
(:func:`init_sharded_state`, or ``launch.shardings.shard_params`` of a
whole state) and the batch its data shard by ``batch_specs``.
The forward is tensor / expert parallel (``models.model``).  The
cross-entropy is vocab-parallel where the head is vocab-sharded: a global
max, the sum of exponentials and the target's logit are each reduced over
``model``, and no rank holds the whole vocabulary's logits.  Each data
shard's loss terms (token sums, counts) are summed over the data axes
before the division, so the loss is the global batch's and every rank's
backward gives its shard's part of the global gradient; the parts are
summed over the data axes (``distributed.psum``).  ``optimizer.
adamw_update`` then clips by the norm over every block and, with ZeRO
specs, updates each rank's data slice of the moments.  Microbatches split
each rank's rows in order; ``launch.shardings.local_batch`` lays a rank's
rows out so that its i-th part is its share of the global batch's
microbatch i (rows i B/m ... (i+1) B/m, the reference's split).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import distributed as D
from ..configs.base import ArchConfig
from ..models import model as Mdl
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        tree_leaves, tree_like)

__all__ = ["TrainConfig", "TrainState", "cross_entropy",
           "chunked_cross_entropy", "loss_fn", "init_state",
           "loss_and_grads", "train_step", "state_layout",
           "init_sharded_params", "init_sharded_state"]

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    remat: bool = True
    microbatches: int = 1          # gradient-accumulation steps
    aux_weight: float = 0.01       # MoE load-balancing loss weight
    z_weight: float = 1e-4         # z-loss (logit norm regularizer)
    ce_chunk: int = 0              # >0: chunked CE over S-chunks of this
                                   # size, never holding the (B, S, V)
                                   # logits (each chunk recomputed in bwd)


def _nll_terms(logits: torch.Tensor, labels: torch.Tensor,
               vocab=None) -> tuple:
    """Per-position (lse, nll, mask) of masked CE, in fp32: the
    reference's stable log-sum-exp (its max is not differentiated) and the
    gold logit.  ``vocab`` (model group, first id, ids): the logits are
    this rank's vocabulary columns; the max, the sum of exponentials and
    the gold logit are reduced over the group."""
    mask = (labels >= 0).float()
    lab = labels.clamp_min(0).long()
    lg32 = logits.float()
    m = lg32.amax(-1).detach()
    if vocab is None:
        lse = m + torch.log(torch.sum(torch.exp(lg32 - m[..., None]), dim=-1))
        gold = lg32.gather(-1, lab[..., None])[..., 0]
        return lse, (lse - gold) * mask, mask
    group, v0, n = vocab
    m = D.pmax(m, group)
    lse = m + torch.log(D.reduce_from(
        torch.sum(torch.exp(lg32 - m[..., None]), dim=-1), group))
    local = lab - v0
    mine = (local >= 0) & (local < n)
    gold = lg32.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = D.reduce_from(torch.where(mine, gold, 0.0), group)
    return lse, (lse - gold) * mask, mask


def _global_mean(nll, zl, n, data) -> tuple:
    """(nll, z-loss sum, count) summed over the data group (the sums
    differentiated as ``reduce_from``: each shard's backward is its part)."""
    if data is None:
        return nll, zl, n
    return (D.reduce_from(nll, data), D.reduce_from(zl, data),
            D.psum(n.detach(), data))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_weight: float = 0.0, vocab=None,
                  data=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked token-mean CE.  logits (B, S, V) any dtype; labels (B, S)
    int, negatives masked.  Returns (loss, n_tokens).  ``vocab``: see
    :func:`_nll_terms`; ``data``: the data group the batch is split over
    (the mean is the global batch's)."""
    lse, nll, mask = _nll_terms(logits, labels, vocab)
    nll, zl, n = _global_mean(nll.sum(), torch.sum(torch.square(lse) * mask),
                              mask.sum(), data)
    n = torch.clamp_min(n, 1.0)
    loss = nll / n
    if z_weight:
        loss = loss + z_weight * zl / n
    return loss, n


def _chunk_terms(xb: torch.Tensor, head: torch.Tensor,
                 lb: torch.Tensor, vocab=None) -> tuple:
    lse, nll, mask = _nll_terms(xb @ head, lb, vocab)
    return nll.sum(), torch.sum(torch.square(lse) * mask), mask.sum()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, chunk: int,
                          z_weight: float = 0.0, vocab=None,
                          data=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE without the (B, S, V) logits: S-chunks of ``chunk`` positions,
    each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``).  Peak extra memory: one (B, chunk, V)
    block (V / m with a vocab-sharded ``head``).  A ragged last chunk is
    padded with masked positions, as the reference pads."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad, d))], dim=1)
        labels = torch.cat([labels, labels.new_full((b, pad), -1)], dim=1)
    if vocab is not None:
        x = D.copy_to(x, vocab[0])
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll, zl, n = zero, zero, zero
    for lo in range(0, s + pad, chunk):
        a, b_, c = checkpoint(_chunk_terms, x[:, lo:lo + chunk], head,
                              labels[:, lo:lo + chunk], vocab,
                              use_reentrant=False)
        nll, zl, n = nll + a, zl + b_, n + c
    nll, zl, n = _global_mean(nll, zl, n, data)
    n = torch.clamp_min(n, 1.0)
    loss = nll / n
    if z_weight:
        loss = loss + z_weight * zl / n
    return loss, n


def loss_fn(cfg: ArchConfig, tc: TrainConfig, params: Tree,
            batch: Dict[str, torch.Tensor], impl: str = "flash", mesh=None,
            data_axes=("data",), gather=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {"ce", "aux", "n_tok"}) of ``batch`` ({"tokens",
    "labels"}, (B, S) integers, and for a vision config optionally
    "vision_embeds" (B, Np, d)) under ``params``.  The patch positions
    carry no loss: their labels are padded with -1, as the reference
    pads them.  Over a ``mesh``: this rank's blocks and data shard (the
    module docstring); the loss is the global batch's.  ``gather``: ZeRO-3
    blocks gathered at use (``models.model.forward``)."""
    labels = batch["labels"]
    vis = batch.get("vision_embeds") if cfg.frontend == "vision" else None
    if vis is not None:
        pad = labels.new_full((labels.shape[0], vis.shape[1]), -1)
        labels = torch.cat([pad, labels], dim=1)
    tp, data = Mdl.mesh_groups(mesh, data_axes)
    vocab = Mdl.head_range(cfg, params, tp)
    kw = dict(remat=tc.remat, impl=impl, vision_embeds=vis, mesh=mesh,
              data_axes=data_axes, gather=gather)
    if tc.ce_chunk:
        x, head, aux = Mdl.forward(cfg, params, batch["tokens"],
                                   mode="train_hidden", **kw)
        ce, n_tok = chunked_cross_entropy(x, head, labels, tc.ce_chunk,
                                          tc.z_weight, vocab, data)
    else:
        logits, aux = Mdl.forward(cfg, params, batch["tokens"], mode="train",
                                  **kw)
        ce, n_tok = cross_entropy(logits, labels, tc.z_weight, vocab, data)
    total = ce + tc.aux_weight * aux
    return total, {"ce": ce, "aux": aux, "n_tok": n_tok}


@dataclasses.dataclass
class TrainState:
    params: Tree
    opt: AdamWState


def init_state(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
               *, device=None, dtype=torch.float32) -> TrainState:
    """Random parameters (``models.model.init_params``: a torch generator,
    not ``jax.random``'s bits) and zeroed AdamW moments.  ``device`` None =
    CUDA (raises without a card)."""
    params = Mdl.init_params(cfg, generator, device=device, dtype=dtype)
    return TrainState(params=params, opt=adamw_init(params))


def state_layout(cfg: ArchConfig, mesh, data_axes=("data",),
                 zero: bool = True, dtype=torch.float32):
    """``launch.shardings.state_specs`` of ``cfg``'s whole train state
    (shapes from the ``meta`` device) on ``mesh``."""
    from ..launch.shardings import state_specs

    params = Mdl.init_params(cfg, device="meta", dtype=dtype)
    meta = TrainState(params, AdamWState(
        torch.zeros((), dtype=torch.int32, device="meta"), params, params))
    return state_specs(meta, mesh, data_axes, zero=zero)


def init_sharded_params(cfg: ArchConfig, pspecs, mesh, rank: int,
                        generator: Optional[torch.Generator] = None, *,
                        device=None, dtype=torch.float32):
    """Global rank ``rank``'s blocks of ``init_params``' parameters by
    ``pspecs`` (``param_specs``): each weight drawn whole, in
    ``init_params``' order from ``generator`` (the same bits on any mesh),
    and cut to its block before the next is drawn, so a rank holds one
    whole leaf at a time beside its blocks."""
    from ..device import resolve_device
    from ..launch.shardings import local_slice, tree_map_with_path
    from ..models.layers import Draws

    # the order of the draws, from a pass on the meta device
    drawn = []
    meta = Mdl.init_params(cfg, Draws(None, lambda w: drawn.append(w) or w),
                           device="meta", dtype=dtype)
    order = {id(w): i for i, w in enumerate(drawn)}
    draw_specs = [None] * len(drawn)

    def note(path, m, sp):
        if id(m) in order:
            draw_specs[order[id(m)]] = sp

    tree_map_with_path(note, meta, pspecs)
    if None in draw_specs:       # an init function replaced a drawn leaf
        raise ValueError(f"{cfg.name}: a drawn weight is not a leaf of "
                         f"init_params' tree (scale it in place)")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    blocks, kept = iter(draw_specs), set()

    def keep(w):
        block = local_slice(w, next(blocks), mesh, rank)
        kept.add(id(block))
        return block

    params = Mdl.init_params(cfg, Draws(generator, keep), device=dev,
                             dtype=dtype)
    return tree_map_with_path(
        lambda path, p, sp: p if id(p) in kept
        else local_slice(p, sp, mesh, rank), params, pspecs)


def init_sharded_state(cfg: ArchConfig, specs, mesh, rank: int,
                       generator: Optional[torch.Generator] = None, *,
                       device=None, dtype=torch.float32) -> TrainState:
    """Global rank ``rank``'s blocks of :func:`init_state`'s state by
    ``specs`` (:func:`state_layout`): the parameters by
    :func:`init_sharded_params`, the moments zeros of their blocks'
    shapes."""
    from ..device import resolve_device
    from ..launch.shardings import local_shape, tree_map_with_path

    local = init_sharded_params(cfg, specs.params, mesh, rank, generator,
                                device=device, dtype=dtype)
    meta = Mdl.init_params(cfg, device="meta", dtype=dtype)
    dev = resolve_device(device)

    def zeros(spec_tree):
        return tree_map_with_path(
            lambda path, m, sp: torch.zeros(
                local_shape(tuple(m.shape), sp, mesh), dtype=torch.float32,
                device=dev), meta, spec_tree)

    return TrainState(local, AdamWState(
        torch.zeros((), dtype=torch.int32, device=dev),
        zeros(specs.opt.mu), zeros(specs.opt.nu)))


def _psum_leaves(leaves: list, group, bucket: int = 1 << 26) -> list:
    """Each tensor of ``leaves`` summed over ``group``, in flat buckets of
    up to ``bucket`` elements (one collective a bucket)."""
    out = list(leaves)
    start = 0
    while start < len(leaves):
        stop, size = start, 0
        while stop < len(leaves) and (stop == start or size
                                      + leaves[stop].numel() <= bucket) \
                and leaves[stop].dtype == leaves[start].dtype:
            size += leaves[stop].numel()
            stop += 1
        flat = D.psum(torch.cat([g.reshape(-1) for g in leaves[start:stop]]),
                      group)
        for i, part in zip(range(start, stop), flat.split(
                [g.numel() for g in leaves[start:stop]])):
            out[i] = part.view(leaves[i].shape)
        start = stop
    return out


def _grads(cfg, tc, params, batch, impl, mesh, data_axes,
           gather=None) -> tuple:
    """(loss, metrics, grad leaves) of this rank's part, not yet summed
    over the data axes (but ZeRO-3 leaves, ``gather``: summed, by their
    gather's reduce-scatter)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tc, tree_like(params, leaves), batch,
                                impl, mesh, data_axes, gather)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, list(grads)


def loss_and_grads(cfg: ArchConfig, tc: TrainConfig, params: Tree,
                   batch: Dict[str, torch.Tensor], impl: str = "flash",
                   mesh=None, data_axes=("data",)) -> tuple:
    """(loss, metrics, grads) of one (micro)batch, detached; grads has
    params' structure.  ``params`` is left as it was.  Over a ``mesh``,
    grads are this rank's blocks of the global batch's gradient."""
    loss, metrics, grads = _grads(cfg, tc, params, batch, impl, mesh,
                                  data_axes)
    data = Mdl.mesh_groups(mesh, data_axes)[1]
    if data is not None:
        grads = _psum_leaves(grads, data)
    return loss, metrics, tree_like(params, grads)


def train_step(cfg: ArchConfig, tc: TrainConfig, state: TrainState,
               batch: Dict[str, torch.Tensor],
               grad_transform: Optional[Callable[[Tree], Tree]] = None,
               mesh=None, data_axes=("data",), specs=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step.  With ``tc.microbatches`` > 1 the batch is split
    on the batch axis and gradients are summed over the microbatches in
    order and divided by their count (the metrics are the last
    microbatch's, the loss the mean).  ``grad_transform`` maps the
    gradient tree before the update (the reference's hook for a compressed
    all-reduce).  Over a ``mesh``: ``state`` and ``batch`` are this rank's
    blocks (the module docstring) and ``specs`` is the state's
    :func:`state_layout` (or ``launch.shardings.state_specs(zero3=True)``:
    parameters split over the data axes too, gathered at use, their
    gradients reduce-scattered and not summed over the data axes again)."""
    gather, summed = None, set()
    if mesh is not None and specs is not None:
        from ..launch.shardings import spec_axes, zero3_gather

        gather = zero3_gather(specs.params, mesh, data_axes)
        if gather is not None:
            summed = {i for i, sp in enumerate(tree_leaves(specs.params))
                      if set(data_axes) & set(spec_axes(sp))}
    if tc.microbatches <= 1:
        loss, metrics, grads = _grads(cfg, tc, state.params, batch, "flash",
                                      mesh, data_axes, gather)
    else:
        m = tc.microbatches
        b = batch["tokens"].shape[0]
        if b % m:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"{m} microbatches")
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(state.params)]
        loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        for i in range(m):
            mb = {k: v[i * (b // m):(i + 1) * (b // m)]
                  for k, v in batch.items()}
            l, metrics, g = _grads(cfg, tc, state.params, mb, "flash", mesh,
                                   data_axes, gather)
            acc = [a + gi for a, gi in zip(acc, g)]
            loss = loss + l
        grads = [a / m for a in acc]
        loss = loss / m
    data = Mdl.mesh_groups(mesh, data_axes)[1]
    if data is not None:
        rest = [i for i in range(len(grads)) if i not in summed]
        for i, g in zip(rest, _psum_leaves([grads[i] for i in rest], data)):
            grads[i] = g
    grads = tree_like(state.params, grads)

    if grad_transform is not None:
        grads = grad_transform(grads)
    new_params, new_opt, gnorm = adamw_update(tc.optimizer, grads, state.opt,
                                              state.params, mesh=mesh,
                                              specs=specs)
    metrics = dict(metrics)
    metrics.update(loss=loss, grad_norm=gnorm)
    return TrainState(params=new_params, opt=new_opt), metrics

