"""Logical-axis sharding rules (torch port of ``repro.models.sharding``).

The JAX package's models annotate activations with LOGICAL axes
(``shard(x, "batch", "seq", "embed")``) and its launcher installs
``ShardingRules`` mapping logical axes to mesh axes, which XLA's
partitioner turns into a layout.  The port keeps the same rule tables and
the same context (``use_rules`` / ``active_rules``), but nothing partitions
a torch program behind the caller's back: the tensor-parallel code in
``models.layers`` / ``models.moe`` / ``models.model`` lays a rank's tensors
out itself, from the parameter specs of ``launch.shardings``.  So on a
rank's local tensor :func:`shard` is a no-op; the reference's
divisibility fix of the spec it would apply is :func:`fix_spec`.

The residual stream stays replicated over ``model`` in the port: the
reference's ``"embed": model`` (a Megatron-SP carry) is its partitioner's
choice of activation layout between layers, not a different function.

:class:`PartitionSpec` is the port's own: a tuple of per-dim entries, each
None, a mesh axis name or a tuple of names (a 1-tuple is stored as its
name, as JAX stores it), so ``tuple(spec)`` equals ``tuple(jax_spec)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

__all__ = ["Axis", "PartitionSpec", "P", "ShardingRules", "default_rules",
           "fsdp_rules", "dp_rules", "use_rules", "active_rules",
           "fix_spec", "shard"]

Axis = Union[str, Tuple[str, ...], None]


def _norm(entry) -> Axis:
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if len(entry) == 1:
            return entry[0]
        return entry or None
    return entry


class PartitionSpec(tuple):
    """Per-dim mesh axes of an array: ``P("data", None, ("pod", "data"))``.
    Entries are None (replicated), an axis name, or a tuple of names (the
    dim split over their product, row-major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    @staticmethod
    def axes_of(entry) -> Tuple[str, ...]:
        """The mesh axes of one entry, as a tuple (empty for None)."""
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None).  ``mesh``
    is a ``launch.mesh.Mesh`` (anything with an ordered ``shape``
    mapping), for :func:`fix_spec`."""
    rules: Dict[str, Axis]
    mesh: Optional[object] = None

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        return P(*(self.rules.get(ax) if ax else None for ax in logical))


def default_rules(data_axes: Tuple[str, ...] = ("data",),
                  model_axis: str = "model", mesh=None) -> ShardingRules:
    """The production mesh's logical -> mesh mapping (Megatron TP over
    ``model_axis``, batch over ``data_axes``)."""
    return ShardingRules(mesh=mesh, rules={
        "batch": data_axes,
        "seq": None,
        "embed": model_axis,
        "embed_r": None,
        "heads": model_axis,
        "kv_heads": model_axis,
        "ff": model_axis,
        "vocab": model_axis,
        "experts": model_axis,
        "ssm_inner": model_axis,
        "state": None,
    })


def fsdp_rules(data_axes: Tuple[str, ...] = ("data",),
               model_axis: str = "model", mesh=None) -> ShardingRules:
    """FSDP regime: batch over data + model, activations replicated over
    model (weights ZeRO-3 over model: ``param_specs(mode="fsdp")``)."""
    return ShardingRules(mesh=mesh, rules={
        "batch": tuple(data_axes) + (model_axis,),
        "seq": None, "embed": None, "embed_r": None,
        "heads": None, "kv_heads": None, "ff": None,
        "vocab": None, "experts": None, "ssm_inner": None, "state": None,
    })


def dp_rules(data_axes: Tuple[str, ...] = ("data",),
             model_axis: str = "model", mesh=None) -> ShardingRules:
    """Data parallel with the embedding / head vocab-sharded over model."""
    return ShardingRules(mesh=mesh, rules={
        "batch": tuple(data_axes),
        "seq": None, "embed": None, "embed_r": None,
        "heads": None, "kv_heads": None, "ff": None,
        "vocab": model_axis, "experts": None, "ssm_inner": None,
        "state": None,
    })


_ACTIVE: list = []


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    _ACTIVE.append(rules)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_rules() -> Optional[ShardingRules]:
    return _ACTIVE[-1] if _ACTIVE else None


def fix_spec(shape: Sequence[int], spec: Sequence[Axis],
             mesh_shape: Optional[Dict[str, int]]) -> PartitionSpec:
    """The reference's divisibility fix of ``shard``: each dim keeps its
    axes only where their size product divides it and is at most it (a
    batch of 1 at decode falls back to replicated); without a mesh every
    axis counts as size 1.  ``spec`` shorter than ``shape`` is padded with
    None."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        size = 1
        for a in PartitionSpec.axes_of(ax):
            size *= dict(mesh_shape)[a] if mesh_shape is not None else 1
        fixed.append(ax if size and dim % max(size, 1) == 0 and dim >= size
                     else None)
    return P(*fixed)


def shard(x, *logical: Optional[str]):
    """``x`` unchanged.  The reference constrains ``x`` to
    ``fix_spec(x.shape, rules.spec(*logical), mesh.shape)`` under active
    rules; in the port a rank's tensors are laid out by the tensor-parallel
    code itself (the module docstring), so the annotation marks where the
    reference places a constraint and moves nothing."""
    del logical
    return x
