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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..models import model as Mdl
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        tree_leaves, tree_like)

__all__ = ["TrainConfig", "TrainState", "cross_entropy",
           "chunked_cross_entropy", "loss_fn", "init_state",
           "loss_and_grads", "train_step"]

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


def _nll_terms(logits: torch.Tensor, labels: torch.Tensor) -> tuple:
    """Per-position (lse, nll, mask) of masked CE, in fp32: the
    reference's stable log-sum-exp (its max is not differentiated) and the
    gold logit."""
    mask = (labels >= 0).float()
    lab = labels.clamp_min(0).long()
    lg32 = logits.float()
    m = lg32.amax(-1).detach()
    lse = m + torch.log(torch.sum(torch.exp(lg32 - m[..., None]), dim=-1))
    gold = lg32.gather(-1, lab[..., None])[..., 0]
    return lse, (lse - gold) * mask, mask


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_weight: float = 0.0) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Masked token-mean CE.  logits (B, S, V) any dtype; labels (B, S)
    int, negatives masked.  Returns (loss, n_tokens)."""
    lse, nll, mask = _nll_terms(logits, labels)
    n = torch.clamp_min(mask.sum(), 1.0)
    loss = nll.sum() / n
    if z_weight:
        loss = loss + z_weight * torch.sum(torch.square(lse) * mask) / n
    return loss, n


def _chunk_terms(xb: torch.Tensor, head: torch.Tensor,
                 lb: torch.Tensor) -> tuple:
    lse, nll, mask = _nll_terms(xb @ head, lb)
    return nll.sum(), torch.sum(torch.square(lse) * mask), mask.sum()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, chunk: int,
                          z_weight: float = 0.0) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """CE without the (B, S, V) logits: S-chunks of ``chunk`` positions,
    each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``).  Peak extra memory: one (B, chunk, V)
    block.  A ragged last chunk is padded with masked positions, as the
    reference pads."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad, d))], dim=1)
        labels = torch.cat([labels, labels.new_full((b, pad), -1)], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll, zl, n = zero, zero, zero
    for lo in range(0, s + pad, chunk):
        a, b_, c = checkpoint(_chunk_terms, x[:, lo:lo + chunk], head,
                              labels[:, lo:lo + chunk], use_reentrant=False)
        nll, zl, n = nll + a, zl + b_, n + c
    n = torch.clamp_min(n, 1.0)
    loss = nll / n
    if z_weight:
        loss = loss + z_weight * zl / n
    return loss, n


def loss_fn(cfg: ArchConfig, tc: TrainConfig, params: Tree,
            batch: Dict[str, torch.Tensor], impl: str = "flash"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {"ce", "aux", "n_tok"}) of ``batch`` ({"tokens",
    "labels"}, (B, S) integers, and for a vision config optionally
    "vision_embeds" (B, Np, d)) under ``params``.  The patch positions
    carry no loss: their labels are padded with -1, as the reference
    pads them."""
    labels = batch["labels"]
    vis = batch.get("vision_embeds") if cfg.frontend == "vision" else None
    if vis is not None:
        pad = labels.new_full((labels.shape[0], vis.shape[1]), -1)
        labels = torch.cat([pad, labels], dim=1)
    if tc.ce_chunk:
        x, head, aux = Mdl.forward(cfg, params, batch["tokens"],
                                   mode="train_hidden", remat=tc.remat,
                                   impl=impl, vision_embeds=vis)
        ce, n_tok = chunked_cross_entropy(x, head, labels, tc.ce_chunk,
                                          tc.z_weight)
    else:
        logits, aux = Mdl.forward(cfg, params, batch["tokens"], mode="train",
                                  remat=tc.remat, impl=impl,
                                  vision_embeds=vis)
        ce, n_tok = cross_entropy(logits, labels, tc.z_weight)
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


def loss_and_grads(cfg: ArchConfig, tc: TrainConfig, params: Tree,
                   batch: Dict[str, torch.Tensor],
                   impl: str = "flash") -> tuple:
    """(loss, metrics, grads) of one (micro)batch, detached; grads has
    params' structure.  ``params`` is left as it was."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tc, tree_like(params, leaves), batch,
                                impl)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_like(params, list(grads))


def train_step(cfg: ArchConfig, tc: TrainConfig, state: TrainState,
               batch: Dict[str, torch.Tensor],
               grad_transform: Optional[Callable[[Tree], Tree]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step.  With ``tc.microbatches`` > 1 the global batch
    is split on the batch axis and gradients are summed over the
    microbatches in order and divided by their count (the metrics are the
    last microbatch's, the loss the mean).  ``grad_transform`` maps the
    gradient tree before the update (the reference's hook for a compressed
    all-reduce)."""
    if tc.microbatches <= 1:
        loss, metrics, grads = loss_and_grads(cfg, tc, state.params, batch)
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
            l, metrics, g = loss_and_grads(cfg, tc, state.params, mb)
            acc = [a + gi for a, gi in zip(acc, tree_leaves(g))]
            loss = loss + l
        grads = tree_like(state.params, [a / m for a in acc])
        loss = loss / m

    if grad_transform is not None:
        grads = grad_transform(grads)
    new_params, new_opt, gnorm = adamw_update(tc.optimizer, grads, state.opt,
                                              state.params)
    metrics = dict(metrics)
    metrics.update(loss=loss, grad_norm=gnorm)
    return TrainState(params=new_params, opt=new_opt), metrics
