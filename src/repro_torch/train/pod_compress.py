"""Cross-pod gradient compression: data parallelism over the ``pod`` axis
with the int8 ring all-reduce (torch port of ``repro.train.pod_compress``).

Every rank runs the port's ``train_step`` on its slice of the global
batch.  Pods split the batch's leading dim, as the reference's
``batch_spec`` does, and the ranks of a pod's inner data axes split it
further.  Between the backward and the AdamW update, the gradients are
reduced in two stages:

1. the fp32 mean over the pod's inner data ranks (``dist.all_reduce``),
   each rank weighted by its share of the pod's label tokens, so that the
   result is the gradient of the pod's whole batch, as the reference's pod
   body takes it over the auto-sharded data axes;
2. the paper-adjacent piece: that mean goes round the DGRO-ordered pod
   ring, int8-quantized (``train.collectives.compressed_grad_mean``: the
   reference's ``compressed_grad_allreduce`` with its residual dropped, as
   the reference drops it).

The loss is ``pmean``ed over the pods.  The reference's ``state_shapes``,
``batch_shapes`` and ``grad_shardings`` only feed ``shard_map`` and XLA's
partitioner: there is nothing to pass them to here, so they are gone.  A
mesh with a ``model`` axis (or any other axis) of more than one rank
needs tensor parallelism, which is not ported (ROADMAP Queue A item
13f).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from .. import distributed as D
from ..configs.base import ArchConfig
from .collectives import compressed_grad_mean
from .optimizer import tree_leaves, tree_like
from .train_step import TrainConfig, TrainState, train_step

__all__ = ["pod_compressed_train_step", "shard_batch", "data_mean"]

Tree = Any


def _check_axes(mesh, pod_axis: str, inner: Tuple[str, ...]) -> None:
    other = {a: n for a, n in mesh.shape.items()
             if a != pod_axis and a not in inner and n > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: sharding parameters over them needs "
            f"tensor parallelism, which is not ported (ROADMAP Queue A "
            f"item 13f); pod-compressed training takes pod and data axes "
            f"only")


def _group(mesh, axes) -> D.Group:
    """The axes' group, or this rank alone where they hold one rank (or
    are no axes)."""
    if mesh.axis_size(axes) == 1:
        return D.Group(None, (D.rank(),))
    return mesh.group(axes)


def shard_batch(batch: Dict[str, Any], mesh, pod_axis: str = "pod",
                inner_data_axes: Sequence[str] = ("data",)
                ) -> Dict[str, Any]:
    """This rank's slice of a global batch: the leading dim split over
    (pod, inner data) in row-major order, contiguous rows a rank.  A leaf
    whose leading dim does not divide by the pods is replicated, as the
    reference's ``batch_spec`` leaves it."""
    inner = tuple(inner_data_axes)
    pods = mesh.shape[pod_axis]
    n = pods * mesh.axis_size(inner)
    s = mesh.axis_index(pod_axis) * mesh.axis_size(inner) + (
        mesh.axis_index(inner) if inner else 0)
    out = {}
    for k, v in batch.items():
        lead = np.shape(v)[0] if np.ndim(v) else 0
        if not (lead and lead % pods == 0 and lead >= pods):
            out[k] = v
            continue
        if lead % n:
            raise ValueError(f"batch leaf {k!r}: {lead} rows do not split "
                             f"over {pods} pods x {n // pods} data ranks")
        per = lead // n
        out[k] = v[s * per:(s + 1) * per]
    return out


def pod_compressed_train_step(cfg: ArchConfig, tc: TrainConfig, mesh,
                              pod_axis: str = "pod",
                              inner_data_axes: Tuple[str, ...] = ("data",)):
    """Builds ``step(state, local_batch) -> (state, metrics)``, which every
    rank of ``mesh`` (a ``launch.mesh.Mesh``) runs on its slice of the
    global batch (:func:`shard_batch`).  Collective: every rank calls this,
    which makes the mesh's pod and data groups.  The parameters stay
    bitwise equal on every rank: each dequantizes the same int8 bits.
    ``metrics["loss"]`` is the mean over pods of each pod's loss; the other
    metrics are this rank's."""
    inner = tuple(inner_data_axes)
    _check_axes(mesh, pod_axis, inner)
    pod_group = _group(mesh, pod_axis)
    data_group = _group(mesh, inner)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        def transform(grads: Tree) -> Tree:
            grads = data_mean(grads, batch["labels"], data_group)
            return compressed_grad_mean(grads, pod_group)

        new_state, metrics = train_step(cfg, tc, state, batch,
                                        grad_transform=transform)
        loss = metrics["loss"]
        if data_group.size > 1:
            loss = D.psum(loss * _token_weight(batch["labels"], data_group),
                          data_group)
        metrics["loss"] = D.pmean(loss, pod_group)
        return new_state, metrics

    return step


def _token_weight(labels: torch.Tensor, group: D.Group) -> torch.Tensor:
    """This rank's share of the group's label tokens (labels >= 0)."""
    n_tok = torch.clamp_min((labels >= 0).sum(), 1).to(torch.float32)
    return n_tok / D.psum(n_tok, group)


def data_mean(grads: Tree, labels: torch.Tensor, group=None) -> Tree:
    """The fp32 mean of every rank's gradients over ``group`` (a pod's inner
    data ranks), each weighted by its share of the group's label tokens:
    the gradient of the token-mean loss over the group's whole batch,
    whose parts each rank took the gradient of.  A group of one rank
    returns ``grads`` as they are."""
    g = D.as_group(group)
    if g.size == 1:
        return grads
    weight = _token_weight(labels, g)
    return tree_like(grads, [
        D.psum(x.to(torch.float32) * weight, g).to(x.dtype)
        for x in tree_leaves(grads)])
