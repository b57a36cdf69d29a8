"""Atomic, async checkpointing of tensor trees, in the JAX package's layout
(``repro.checkpoint.checkpoint``), so that a checkpoint written by either
package restores into the other.

Layout:  <dir>/step_<N>/
             manifest.json      (leaf keys, shapes, dtypes, step, meta)
             shard_0.npz        (every leaf, one host)
             COMMITTED          (written last: atomic-commit marker)

* **Atomic**: everything is written into ``step_<N>.tmp`` and renamed;
  readers ignore directories without the COMMITTED marker, so a job killed
  mid-save can never restore a torn checkpoint.
* **Async**: ``save_async`` copies the tree to host memory synchronously
  (after the device's pending work) and writes in a background thread.
* **Keys**: each leaf is stored under the JAX package's ``keystr`` of its
  path: a dataclass's fields (``TrainState``) as ``[<flat index i>]``, a
  NamedTuple's (``AdamWState``) as ``.name``, dict keys sorted as
  ``['key']``, list items as ``[i]`` -- e.g.
  ``[<flat index 0>]['blocks']['pos0']['attn']['wq']`` and
  ``[<flat index 1>].mu['embed']``.  bf16 leaves are stored as fp32
  (lossless) and cast back to the template's dtype on restore.

* **Sharded** (``shardings``, a tree of ``launch.shardings.NamedSharding``
  matching the tree, from ``to_shardings(specs, mesh)``): ``save`` of a
  rank's blocks gathers each leaf whole over the mesh (every rank calls
  it), rank 0 writes the reference's one-file layout of whole arrays, and
  every rank waits for the commit.  ``restore(..., shardings=...)`` keeps
  each rank's block of each leaf by its spec on the NEW mesh: an elastic
  restart onto another mesh shape (or onto one device, with no
  shardings).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import distributed as D
from ..launch.shardings import (NamedSharding, gather_leaf, local_shape,
                                local_slice)

__all__ = ["save", "restore", "latest_steps", "AsyncCheckpointer",
           "flatten_with_keys"]

Tree = Any
_MARKER = "COMMITTED"


def _children(node):
    """(key string, child) pairs of a tree node in ``jax.tree.flatten``'s
    order, or None for a leaf."""
    if isinstance(node, NamedSharding):
        return None
    if isinstance(node, dict):
        return [(f"[{key!r}]", node[key]) for key in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{name}", getattr(node, name)) for name in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", child) for i, child in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f"[<flat index {i}>]", getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def _walk_keys(node, prefix: str, out: Dict[str, Any]) -> None:
    kids = _children(node)
    if kids is None:
        out[prefix] = node
        return
    for key, child in kids:
        _walk_keys(child, prefix + key, out)


def flatten_with_keys(tree: Tree) -> Dict[str, Any]:
    """``{keystr: leaf}`` in ``jax.tree.flatten``'s order.  (Module-level
    recursions here: a nested function that calls itself is a reference
    cycle, which would hold the leaves until Python's cyclic collector
    runs.)"""
    out: Dict[str, Any] = {}
    _walk_keys(tree, "", out)
    return out


def _rebuild(node: Tree, leaf_of, prefix: str = "") -> Tree:
    """``node`` with each leaf replaced by ``leaf_of(keystr, leaf)``."""
    if isinstance(node, dict):
        return {key: _rebuild(node[key], leaf_of, f"{prefix}[{key!r}]")
                for key in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_rebuild(getattr(node, n), leaf_of,
                                     f"{prefix}.{n}")
                            for n in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(c, leaf_of, f"{prefix}[{i}]")
                          for i, c in enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node)(**{
            f.name: _rebuild(getattr(node, f.name), leaf_of,
                             f"{prefix}[<flat index {i}>]")
            for i, f in enumerate(dataclasses.fields(node))})
    return leaf_of(prefix, node)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:        # npz has no bf16: fp32, lossless
            t = t.float()
        return t.to("cpu", copy=True).numpy()     # never the live storage
    return np.array(leaf)


def _snapshot(tree: Tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in flatten_with_keys(tree).items()}


def _write(directory: str, step: int, arrays: Dict[str, np.ndarray],
           meta: Optional[Dict]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    manifest = {
        "step": step,
        "meta": meta or {},
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "n_hosts": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _gathered(tree: Tree, shardings: Tree) -> Optional[Dict[str, np.ndarray]]:
    """Every leaf of a rank's blocks gathered whole (a collective, one leaf
    at a time), as the snapshot on rank 0 and None elsewhere."""
    keyed, sh = flatten_with_keys(tree), flatten_with_keys(shardings)
    out: Dict[str, np.ndarray] = {}
    for k, leaf in keyed.items():
        s = sh[k]
        whole = gather_leaf(leaf, s.spec, s.mesh) \
            if isinstance(leaf, torch.Tensor) else leaf
        if D.rank() == 0:
            out[k] = _to_numpy(whole)
        del whole
    return out if D.rank() == 0 else None


def _barrier() -> None:
    D.psum(torch.zeros(1), D.world())


def save(directory: str, step: int, tree: Tree, *,
         meta: Optional[Dict] = None, shardings: Optional[Tree] = None
         ) -> str:
    """Synchronous save.  Returns the committed directory.  With
    ``shardings``, ``tree`` holds a rank's blocks; every rank calls it and
    returns once rank 0 has committed."""
    if shardings is None:
        return _write(directory, step, _snapshot(tree), meta)
    arrays = _gathered(tree, shardings)
    final = os.path.join(directory, f"step_{step:08d}")
    if arrays is not None:
        _write(directory, step, arrays, meta)
    _barrier()
    return final


class AsyncCheckpointer:
    """Background-thread checkpointing; at most one save in flight; keeps
    the newest ``keep`` committed steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._sharded = False
        self.last_committed: Optional[str] = None

    def save_async(self, step: int, tree: Tree, meta: Optional[Dict] = None,
                   shardings: Optional[Tree] = None):
        """Snapshot now, write in the background.  With ``shardings`` (a
        rank's blocks; every rank calls it) the leaves are gathered now and
        rank 0 writes; :meth:`wait` then returns on every rank once the
        write is committed."""
        self.wait()
        # copy to host memory NOW: the caller may update the tensors later
        snapshot = _snapshot(tree) if shardings is None else \
            _gathered(tree, shardings)
        self._sharded = shardings is not None
        if snapshot is None:               # a rank other than 0
            self.last_committed = os.path.join(self.directory,
                                               f"step_{step:08d}")
            return

        def work():
            self.last_committed = _write(self.directory, step, snapshot,
                                         meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            _barrier()

    def _gc(self):
        steps = latest_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def latest_steps(directory: str):
    """The committed steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if (name.startswith("step_") and not name.endswith(".tmp")
                and os.path.exists(os.path.join(path, _MARKER))):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def restore(directory: str, template: Tree, *,
            step: Optional[int] = None,
            shardings: Optional[Tree] = None) -> tuple:
    """Restore into the structure of ``template`` (the newest committed
    step, or ``step``): each leaf in its template leaf's dtype, on its
    device.  Returns (tree, step).  ``shardings`` (a tree of
    ``launch.shardings.NamedSharding`` matching ``template``): ``template``
    holds this rank's blocks, and each leaf restored is this rank's block of
    the stored whole by its spec on its mesh."""
    steps = latest_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keyed = flatten_with_keys(template)
    sh = flatten_with_keys(shardings) if shardings is not None else {}
    stored = manifest["leaves"]
    missing = [k for k in keyed if k not in stored]
    if missing:
        raise ValueError(f"checkpoint at step {step} missing leaves: "
                         f"{missing[:5]}")
    for k, leaf in keyed.items():
        got, want = tuple(stored[k]["shape"]), tuple(np.shape(leaf))
        if k in sh:
            got = local_shape(got, sh[k].spec, sh[k].mesh)
        if got != want:
            raise ValueError(f"shape mismatch for {k}: ckpt {got} vs "
                             f"template {want}")
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        def leaf_of(key, leaf):
            arr = data[key]
            if isinstance(leaf, torch.Tensor):
                # ascontiguousarray makes a 0-d array 1-d: shape it back
                t = torch.from_numpy(np.ascontiguousarray(arr).reshape(
                    arr.shape))
                if key in sh:
                    t = local_slice(t, sh[key].spec, sh[key].mesh, D.rank())
                return t.to(device=leaf.device, dtype=leaf.dtype)
            return np.asarray(arr).astype(np.asarray(leaf).dtype)

        tree = _rebuild(template, leaf_of)
    return tree, manifest["step"]
