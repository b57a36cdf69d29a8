"""Parameter / state / cache / batch PartitionSpecs for the production mesh
(torch port of ``repro.launch.shardings``), and a rank's blocks of them.

Name-based rules map every leaf of the model tree to a
:class:`~repro_torch.models.sharding.PartitionSpec`: tensor-parallel over
``model`` (heads / ff / vocab / experts / d_inner), batch over the data
axes, ZeRO over data for optimizer moments.  Every rule is
divisibility-guarded: a dim that does not divide by its mesh axis falls
back to replicated.  The functions are pure: they read paths, shapes and
``mesh.shape`` only, so the port's trees (nested dicts with the
reference's keys; shapes from ``init_params(..., device="meta")``) get the
reference's specs on a mesh of any size without a process group.

Where the reference hands specs to XLA (``to_shardings`` and
``jax.device_put``), the port keeps a rank's block of each leaf itself:
:func:`local_slice` cuts it and :func:`gather_leaf` puts the whole back
together over the mesh's groups.  A dim split over several axes is split
row-major over them, as JAX splits it; rank r's block along an axis is its
coordinate there, in the ``Mesh``'s grid order (the DGRO order of
``make_production_mesh(dgro_order=True)``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .. import distributed as D
from ..models.sharding import P, PartitionSpec

__all__ = ["_NAME_RULES", "spec_for_param", "param_specs", "zero_spec",
           "zero3_param_specs", "state_specs", "cache_specs", "batch_specs",
           "local_batch", "NamedSharding", "to_shardings", "keystr", "tree_map_with_path",
           "local_shape", "local_slice", "gather_leaf", "shard_params",
           "gather_params", "spec_axes", "zero3_gather"]

Tree = Any

# leaf-name -> UNSTACKED dim index sharded over "model" (leaves under
# "blocks" carry a leading block-stack dim; index is offset by 1 there).
# Megatron convention: column-parallel in-projections shard dim 1 (output
# features); row-parallel out-projections shard dim 0 (input features).
_NAME_RULES = {
    # attention / dense mlp
    "wq": 1, "wk": 1, "wv": 1, "wo": 0,
    "bq": 0, "bk": 0, "bv": 0,
    "w_gate": 1, "w_up": 1, "w_down": 0,
    "embed": 0,                        # vocab-sharded embedding (V, d)
    "lm_head": 1,
    "vision_proj": 1,
    # mamba1 / mamba2: d_inner (or ssm-heads) sharded
    "wx": 1, "wz": 1, "wdt": 1,
    "w_dt": 0, "w_b": 0, "w_c": 0,
    "dt_w": 1, "dt_b": 0,
    "out_proj": 0,
    "A_log": 0,                        # mamba1 (di, N) / mamba2 (nh,)
    "D": 0,
    "gate_norm": 0,
    "conv_w": 1,                       # (K, C) depthwise conv, channel-sharded
    "conv_b": 0,
}


# ---------------------------------------------------------------------------
# trees: nested dicts, NamedTuples (AdamWState) and dataclasses (TrainState)
# ---------------------------------------------------------------------------

def _is_leaf(node) -> bool:
    return isinstance(node, PartitionSpec) or not (
        isinstance(node, (dict, tuple, list))
        or (dataclasses.is_dataclass(node) and not isinstance(node, type)))


def tree_map_with_path(fn: Callable, tree: Tree, *rest: Tree,
                       path: tuple = ()) -> Tree:
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf,
    *leaves of rest)``; ``path`` holds the dict keys, NamedTuple field
    names and dataclass field names down to the leaf (a PartitionSpec is a
    leaf)."""
    if _is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(
            fn, getattr(tree, f), *(getattr(r, f) for r in rest),
            path=path + (f,)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=path + (i,))
                          for i, v in enumerate(tree))
    return type(tree)(**{
        f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                   *(getattr(r, f.name) for r in rest),
                                   path=path + (f.name,))
        for f in dataclasses.fields(tree)})


def keystr(path: tuple) -> str:
    """JAX's ``keystr`` of a path of dict keys: ``['blocks']['pos0']['k']``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


def _leaf_name(path) -> str:
    return str(path[-1])


def _in_moe(path) -> bool:
    return any(k == "moe" for k in path)


def _stacked(path) -> bool:
    return any(k == "blocks" for k in path)


# ---------------------------------------------------------------------------
# the reference's spec functions
# ---------------------------------------------------------------------------

def spec_for_param(path, shape: Tuple[int, ...], mesh,
                   model_axis: str = "model") -> PartitionSpec:
    rank = len(shape)
    spec = [None] * rank
    name = _leaf_name(path)
    base = 1 if _stacked(path) else 0

    def try_set(d: int, axis: str):
        if d < rank and shape[d] % mesh.shape[axis] == 0 \
                and shape[d] >= mesh.shape[axis]:
            spec[d] = axis

    if _in_moe(path) and name in ("w_gate", "w_up", "w_down"):
        try_set(base + 0, model_axis)      # shard the EXPERT dim (EP)
        return P(*spec)
    dim = _NAME_RULES.get(name)
    if dim is not None:
        try_set(base + dim, model_axis)
    return P(*spec)


def param_specs(params_shapes: Tree, mesh, mode: str = "tp") -> Tree:
    """PartitionSpec tree for a params (shape) tree.  mode "tp": Megatron
    tensor parallel over the model axis; "fsdp": each weight ZeRO-3 over
    the model axis on its first divisible dim; "dp": every weight
    replicated."""
    def one(path, leaf):
        shape = _shape(leaf)
        if mode == "fsdp":
            return zero_spec(P(), shape, mesh, ("model",))
        if mode == "dp":
            return P(*([None] * len(shape)))
        return spec_for_param(path, shape, mesh)
    return tree_map_with_path(one, params_shapes)


def zero_spec(spec, shape: Tuple[int, ...], mesh,
              data_axes: Sequence[str]) -> PartitionSpec:
    """ZeRO: additionally shard the first replicated dim over the data axes
    (optimizer moments; params too for full FSDP)."""
    dsize = int(np.prod([mesh.shape[a] for a in data_axes]))
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (cur, dim) in enumerate(zip(parts, shape)):
        if cur is None and dim % dsize == 0 and dim >= dsize:
            parts[i] = tuple(data_axes)
            break
    return P(*parts)


def zero3_param_specs(params_shapes: Tree, mesh,
                      data_axes: Sequence[str]) -> Tree:
    """ZeRO-3: the TP specs plus data-axis sharding of each leaf's first
    free dim."""
    base = param_specs(params_shapes, mesh, mode="tp")
    return tree_map_with_path(
        lambda path, leaf, sp: zero_spec(sp, _shape(leaf), mesh, data_axes),
        params_shapes, base)


def state_specs(state_shapes: Tree, mesh,
                data_axes: Sequence[str] = ("data",),
                zero: bool = True, mode: str = "tp",
                zero3: bool = False) -> Tree:
    """Specs for a ``TrainState(params, opt=AdamWState(step, mu, nu))``
    shape tree."""
    from ..train.optimizer import AdamWState
    from ..train.train_step import TrainState

    if zero3:
        pspecs = zero3_param_specs(state_shapes.params, mesh, data_axes)
    else:
        pspecs = param_specs(state_shapes.params, mesh, mode=mode)

    def moment_specs(shapes):
        base = param_specs(shapes, mesh, mode=mode)
        if not zero:
            return base
        return tree_map_with_path(
            lambda path, leaf, sp: zero_spec(sp, _shape(leaf), mesh,
                                             data_axes), shapes, base)

    opt = AdamWState(step=P(), mu=moment_specs(state_shapes.opt.mu),
                     nu=moment_specs(state_shapes.opt.nu))
    return TrainState(params=pspecs, opt=opt)


def cache_specs(cache_shapes: Tree, mesh, batch: int,
                data_axes: Sequence[str] = ("data",),
                model_axis: str = "model") -> Tree:
    """KV / SSM cache specs, by the reference's rules over its ``keystr``
    names (batch over data when divisible; heads, else the sequence, over
    model for a KV cache).  ``batch`` is unused, as in the reference."""
    del batch
    dsize = int(np.prod([mesh.shape[a] for a in data_axes]))
    msize = mesh.shape[model_axis]
    dp = tuple(data_axes)

    def one(path, leaf):
        shape = _shape(leaf)
        rank = len(shape)
        name = keystr(path)
        stacked = rank >= 1 and "blocks" in name
        base = 1 if stacked else 0
        spec = [None] * rank
        if shape[base] % dsize == 0 and shape[base] >= dsize:
            spec[base] = dp

        def fits(d):
            return d < rank and shape[d] % msize == 0 and shape[d] >= msize

        if re.search(r"\[.(k|v).\]$", name) or rank - base == 4:
            if fits(base + 1):
                spec[base + 1] = model_axis
            elif fits(base + 2):
                spec[base + 2] = model_axis
        elif re.search(r"\bconv\]?$", name):
            if shape[-1] % msize == 0:
                spec[-1] = model_axis
        elif re.search(r"\bh\]?$", name):
            if fits(base + 1):
                spec[base + 1] = model_axis
            elif fits(base + 2):
                spec[base + 2] = model_axis
        return P(*spec)

    return tree_map_with_path(one, cache_shapes)


def batch_specs(batch_shapes: Tree, mesh,
                data_axes: Sequence[str] = ("data",)) -> Tree:
    dsize = int(np.prod([mesh.shape[a] for a in data_axes]))

    def one(path, leaf):
        shape = _shape(leaf)
        if shape and shape[0] % dsize == 0 and shape[0] >= dsize:
            return P(tuple(data_axes), *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return tree_map_with_path(one, batch_shapes)


def local_batch(batch: Dict[str, torch.Tensor], mesh, rank: int,
                data_axes: Sequence[str] = ("data",),
                microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """Global rank ``rank``'s part of the whole ``batch`` (tensors, batch
    dim first) by :func:`batch_specs`, laid out for ``train_step`` with
    ``microbatches``: microbatch i of the global batch (its rows i B/m ...
    (i+1) B/m, the reference's split) is cut by its own ``batch_specs``
    and the rank's parts are concatenated in order, so the step's split
    of the rank's rows into m gives its part of microbatch i."""
    m = max(microbatches, 1)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % m:
            raise ValueError(f"batch {v.shape[0]} is not a multiple of {m} "
                             f"microbatches")
        parts = v.split(v.shape[0] // m)
        spec = batch_specs(parts[0], mesh, data_axes)
        mine = [local_slice(part, spec, mesh, rank) for part in parts]
        out[k] = mine[0] if m == 1 else torch.cat(mine)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what ``checkpoint.restore(shardings=...)`` places
    each leaf by (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec


def to_shardings(specs: Tree, mesh) -> Tree:
    return tree_map_with_path(lambda path, s: NamedSharding(mesh, s), specs)


# ---------------------------------------------------------------------------
# a rank's blocks
# ---------------------------------------------------------------------------

def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits some dim over."""
    return tuple(a for e in spec for a in PartitionSpec.axes_of(e))


def _block(dim: int, entry, mesh, coords) -> Tuple[int, int]:
    """(parts, index) of a dim split over ``entry``'s axes: the product of
    their sizes and the rank's row-major index over them."""
    axes = PartitionSpec.axes_of(entry)
    if not axes:
        return 1, 0
    sizes = [mesh.shape[a] for a in axes]
    idx = [coords[mesh.axis_names.index(a)] for a in axes]
    parts = int(np.prod(sizes))
    if dim % parts:
        raise ValueError(f"a dim of {dim} does not split {parts} ways "
                         f"over {axes}")
    return parts, int(np.ravel_multi_index(idx, sizes))


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The block shape of a ``shape`` array laid out by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    coords = (0,) * len(mesh.axis_names)
    return tuple(d // _block(d, e, mesh, coords)[0]
                 for d, e in zip(shape, spec))


def local_slice(x: torch.Tensor, spec, mesh, rank: int) -> torch.Tensor:
    """Global rank ``rank``'s block of the whole tensor ``x`` laid out by
    ``spec`` on ``mesh``: a copy (so the whole can be freed), or ``x``
    itself where the spec splits nothing."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    coords = mesh.coords(rank)
    out = x
    for d, entry in enumerate(spec):
        parts, i = _block(x.shape[d], entry, mesh, coords)
        if parts > 1:
            n = x.shape[d] // parts
            out = out.narrow(d, i * n, n)
    return out.clone() if out is not x else x


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` laid out by ``spec``:
    an ``all_gather`` over each split dim's axes (every rank of the mesh
    calls it, and gets the whole).  The inverse of :func:`local_slice`."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    for d, entry in enumerate(spec):
        axes = PartitionSpec.axes_of(entry)
        if axes and mesh.axis_size(axes) > 1:
            g = D.all_gather(x.movedim(d, 0), mesh.group(axes))
            x = g.movedim(0, d).contiguous()
    return x


def shard_params(tree: Tree, specs: Tree, mesh, rank: int) -> Tree:
    """``tree`` (whole tensors: ``convert.params_from_jax``, or the port's
    ``init_params``) as global rank ``rank``'s blocks by ``specs``."""
    return tree_map_with_path(
        lambda path, x, s: local_slice(x, s, mesh, rank), tree, specs)


def gather_params(tree: Tree, specs: Tree, mesh) -> Tree:
    """The inverse of :func:`shard_params`, collectively: every rank gets
    the whole tree."""
    return tree_map_with_path(
        lambda path, x, s: gather_leaf(x, s, mesh), tree, specs)


def zero3_gather(pspecs: Tree, mesh, data_axes: Sequence[str] = ("data",)):
    """ZeRO-3's gather at use for ``models.model.forward(gather=)``, or None
    where no leaf of ``pspecs`` (a params spec tree) splits a dim over the
    ``data_axes``.  The hook takes a subtree of rank blocks and its path in
    the params tree and returns the tensor-parallel blocks: each leaf split
    over data axes gathered over them on that dim
    (``distributed.gather_at_use``: its gradient reduce-scattered).  Under
    ``blocks`` a leaf split over data on its leading block dim is gathered
    whole, once, when the hook is given the stacked tree itself
    (``layer=False``); every other leaf there a layer at a time, when it
    is given one layer's weights indexed out of the stack (which lose the
    block dim)."""
    data = set(data_axes)

    def data_dim(spec):
        for d, entry in enumerate(spec):
            axes = PartitionSpec.axes_of(entry)
            if axes and set(axes) <= data and mesh.axis_size(axes) > 1:
                return d, axes
        return None

    found = []
    tree_map_with_path(lambda path, sp: found.append(data_dim(sp)), pspecs)
    if not any(found):
        return None
    # the vocab-parallel head reads its vocabulary range off the blocks'
    # shapes (``models.model.head_range``): the vocab dim is not data's
    for name, vocab_dim in (("embed", 0), ("lm_head", 1)):
        hit = data_dim(pspecs[name]) if name in pspecs else None
        if hit is not None and hit[0] == vocab_dim:
            raise NotImplementedError(
                f"ZeRO-3 over {name}'s vocabulary dim")

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def gather(sub, path: tuple, layer: bool = True):
        stacked = len(path) > 0 and path[0] == "blocks"

        def one(p, leaf, sp):
            hit = data_dim(sp)
            if hit is None:
                return leaf
            d, axes = hit
            if stacked:
                if (d == 0) == layer:      # the stack's dim: gathered whole
                    return leaf
                d -= layer
            return D.gather_at_use(leaf, mesh.group(axes), d)

        return tree_map_with_path(one, sub, at(pspecs, path), path=path)

    return gather
