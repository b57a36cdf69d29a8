"""Parameters between the JAX package and the port.

Both keep the same tree: ``embed``, ``final_norm``, ``lm_head`` (absent when
the embeddings are tied: the head is ``embed.T``), ``blocks/pos{j}/...``
stacked on a leading block axis and ``rem/rem{j}/...`` unstacked, each
applied by its forward in the same order.  Leaves travel as numpy arrays
(the JAX side: ``jax.tree.map(np.asarray, params)``), so this module needs
neither package's arrays, only their shapes: :func:`param_shapes` lists the
port's layout on the ``meta`` device without allocating it, which lets a
test compare a full-width layout with ``jax.eval_shape`` of the JAX init.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .model import init_params

__all__ = ["flatten", "param_shapes", "params_from_jax"]


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` for a nested dict of leaves (empty dicts vanish)."""
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(flatten(val, name + "/"))
        else:
            flat[name] = val
    return flat


def param_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """Every parameter's path and shape in the port's layout, built on the
    ``meta`` device (no memory)."""
    return {name: tuple(t.shape)
            for name, t in flatten(init_params(cfg, device="meta")).items()}


def _to_tensor(arr: np.ndarray, device, dtype) -> torch.Tensor:
    arr = np.array(arr)                    # a writable copy
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bf16, as JAX hands it
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig, device=None,
                    dtype=None) -> Dict[str, Any]:
    """The JAX package's parameters (a nested dict of numpy arrays) as the
    port's, on ``device`` (None = CUDA) and in ``dtype`` (None = as given).
    Raises unless names and shapes are exactly the port's layout for
    ``cfg`` -- a tied config carries no ``lm_head``."""
    dev = resolve_device(device)
    got = flatten(tree)
    want = param_shapes(cfg)
    if set(got) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    bad = {n: (tuple(np.shape(got[n])), s) for n, s in want.items()
           if tuple(np.shape(got[n])) != s}
    if bad:
        raise ValueError(f"parameter shapes differ (got, want): {bad}")
    skeleton = init_params(cfg, device="meta")

    def fill(node, src):
        return {k: fill(v, src[k]) if isinstance(v, dict)
                else _to_tensor(src[k], dev, dtype) for k, v in node.items()}

    return fill(skeleton, tree)

