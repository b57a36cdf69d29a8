"""AdamW, global-norm clipping and a warmup+cosine schedule as plain
functions over tensors (torch port of ``repro.train.optimizer``).

Parameters, gradients and moments are trees: nested dicts, lists and
tuples of tensors; every function returns the same kind it was given.
Leaves are taken in ``jax.tree.flatten``'s order (dict keys sorted), so
``global_norm`` sums them in the reference's order.
This is deliberately not ``torch.optim.AdamW``: the reference clips by
``norm + 1e-12`` (``clip_grad_norm_`` adds 1e-6) and divides the moments
by their bias corrections before the square root, so the same gradients
give the same step only when the arithmetic is copied.  Moments are fp32
by default; the step counter is a 0-d int32 tensor on the parameters'
device, so an update never waits for the host.

Over a mesh (``adamw_update(..., mesh=, specs=)``, ``specs`` the state's
``launch.shardings.state_specs``): the leaves are a rank's blocks.  The
clip's global norm adds each leaf's sum of squares, summed over the mesh
axes its spec splits it over (so a replicated leaf counts once), in leaf
order.  Where a moment's spec splits a dim that its parameter's does not
(ZeRO over the data axes), the rank holds that data slice of ``mu`` /
``nu``, updates that slice of the parameter and all-gathers the slices
over the data axes into its block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .. import distributed as D
from ..models.sharding import PartitionSpec

Tree = Any   # nested dicts / lists / tuples of tensors

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "warmup_cosine", "global_norm", "clip_by_global_norm",
           "tree_leaves", "tree_like"]


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


def tree_leaves(tree: Tree) -> list:
    """The tensors of ``tree`` in ``jax.tree.flatten``'s order (a
    ``PartitionSpec`` is a leaf, as in a spec tree)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)) and \
            not isinstance(tree, PartitionSpec):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def _rebuild(node, leaves):
    """``node`` with its leaves taken from the iterator ``leaves``."""
    if isinstance(node, dict):
        new = {key: _rebuild(node[key], leaves) for key in sorted(node)}
        return {key: new[key] for key in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(sub, leaves) for sub in node)
    return next(leaves)


def tree_like(tree: Tree, leaves: list) -> Tree:
    """``tree``'s structure with its leaves replaced, in :func:`tree_leaves`'
    order.  A module-level recursion: a nested function that calls itself
    is a reference cycle, which would hold ``leaves`` (a step's gradients)
    until Python's cyclic collector runs."""
    return _rebuild(tree, iter(leaves))


def adamw_init(params: Tree, moment_dtype=torch.float32) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_like(params, [torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device) for p in leaves]),
        nu=tree_like(params, [torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device) for p in leaves]))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's fp32 sum of
    squares."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree,
                                                              torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_like(tree, [g * scale.to(g.dtype)
                            for g in tree_leaves(tree)]), norm


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


def _sharded_norm(grads: list, pspecs: list, mesh) -> torch.Tensor:
    """The global norm of a rank's gradient blocks: each leaf's fp32 sum of
    squares, summed over the axes its spec splits it over (one collective
    an axis set), added in leaf order."""
    from ..launch.shardings import spec_axes

    sums = [torch.sum(torch.square(g.float())) for g in grads]
    by_axes: dict = {}
    for i, sp in enumerate(pspecs):
        axes = tuple(a for a in spec_axes(sp) if mesh.shape[a] > 1)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        total = D.psum(torch.stack([sums[i] for i in idx]),
                       mesh.group(axes))
        for i, t in zip(idx, total):
            sums[i] = t
    total = 0
    for t in sums:
        total = total + t
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _zero_dim(pspec, mspec) -> Optional[tuple]:
    """(dim, axes) where the moment's spec splits a dim the parameter's
    does not (its ZeRO slice), else None."""
    for d, (pe, me) in enumerate(zip(tuple(pspec) + (None,) * len(mspec),
                                     mspec)):
        if pe is None and me is not None:
            return d, PartitionSpec.axes_of(me)
    return None


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree, *, mesh=None, specs=None
                 ) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """One AdamW step.  Returns (new_params, new_state, grad_norm); the
    inputs are left as they were.  ``mesh`` / ``specs``: a rank's blocks
    of a sharded state (the module docstring)."""
    g_leaves = tree_leaves(grads)
    if mesh is not None and mesh.size > 1:
        if specs is None:
            raise ValueError("a sharded update needs the state's specs "
                             "(launch.shardings.state_specs)")
        pspecs = tree_leaves(specs.params)
        mspecs = tree_leaves(specs.opt.mu)
        gnorm = _sharded_norm(g_leaves, pspecs, mesh)
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
            g_leaves = [g * scale.to(g.dtype) for g in g_leaves]
    else:
        pspecs = mspecs = None
        if cfg.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
            g_leaves = tree_leaves(grads)
        else:
            gnorm = global_norm(grads)

    step = state.step + 1
    stepf = step.float()
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    # the bias corrections in fp32, as the reference's weakly typed powers
    b1c = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)

    def upd(g, m, v, p):
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g32)
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m32.to(m.dtype), \
            v32.to(v.dtype)

    new_p, new_m, new_v = [], [], []
    for i, (g, m, v, p) in enumerate(zip(g_leaves, tree_leaves(state.mu),
                                         tree_leaves(state.nu),
                                         tree_leaves(params))):
        zero = None if pspecs is None else _zero_dim(pspecs[i], mspecs[i])
        if zero is None or mesh.axis_size(zero[1]) == 1:
            out = upd(g, m, v, p)
        else:
            # ZeRO: this rank's data slice, then the slices gathered
            d, axes = zero
            n = m.shape[d]
            lo = mesh.axis_index(axes) * n
            pn, mn, vn = upd(g.narrow(d, lo, n), m, v, p.narrow(d, lo, n))
            pn = D.all_gather(pn.movedim(d, 0).contiguous(),
                              mesh.group(axes)).movedim(0, d).contiguous()
            out = (pn, mn, vn)
        new_p.append(out[0])
        new_m.append(out[1])
        new_v.append(out[2])
    return (tree_like(params, new_p),
            AdamWState(step, tree_like(params, new_m),
                       tree_like(params, new_v)), gnorm)

