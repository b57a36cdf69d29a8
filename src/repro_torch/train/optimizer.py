"""AdamW, global-norm clipping and a warmup+cosine schedule as plain
functions over tensors (torch port of ``repro.train.optimizer``).

Parameters, gradients and moments are a dict (name -> tensor) or a
list/tuple of tensors; every function returns the same kind it was given.
This is deliberately not ``torch.optim.AdamW``: the reference clips by
``norm + 1e-12`` (``clip_grad_norm_`` adds 1e-6) and divides the moments
by their bias corrections before the square root, so the same gradients
give the same step only when the arithmetic is copied.  Moments are fp32
by default; the step counter is a 0-d int32 tensor on the parameters'
device, so an update never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

Tree = Any   # dict of tensors, or list / tuple of tensors

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "warmup_cosine", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Tree             # first moment
    nu: Tree             # second moment


def _leaves(tree: Tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _like(tree: Tree, leaves: list) -> Tree:
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), leaves))
    return type(tree)(leaves)


def adamw_init(params: Tree, moment_dtype=torch.float32) -> AdamWState:
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=_like(params, [torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device) for p in leaves]),
        nu=_like(params, [torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device) for p in leaves]))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's fp32 sum of
    squares."""
    total = 0
    for leaf in _leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree,
                                                              torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return _like(tree, [g * scale.to(g.dtype) for g in _leaves(tree)]), norm


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return peak_lr * torch.where(step < warmup, warm, cos)
    return sched


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """One AdamW step.  Returns (new_params, new_state, grad_norm); the
    inputs are left as they were."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)

    step = state.step + 1
    stepf = step.float()
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    # the bias corrections in fp32, as the reference's weakly typed powers
    b1c = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)

    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(_leaves(grads), _leaves(state.mu),
                          _leaves(state.nu), _leaves(params)):
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g32)
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        new_p.append((p.float() - lr * delta).to(p.dtype))
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
    return (_like(params, new_p),
            AdamWState(step, _like(grads, new_m), _like(grads, new_v)), gnorm)
