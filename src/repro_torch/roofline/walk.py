"""Counting pass over an eager torch step: the port's counterpart of
``repro.roofline.hlo_walk``.

The reference walks a compiled HLO module, multiplying each while-loop
body by its inferred trip count.  The port has no HLO: :func:`walk` runs
the step once under a ``TorchDispatchMode`` and adds up what reaches the
dispatcher.  Python loops (layer blocks, microbatches, attention chunks)
simply run, so every trip is counted as it happens and no trip count is
inferred: the reference's ``n_while`` and ``max_trip`` have no
counterpart.  Run on ``meta`` tensors the step allocates nothing and
touches no card; the port's kernel wrappers and collectives report their
own work, so a walk on ``meta``, on the CPU or on the card gives one
count.

Fields (the reference's, :class:`WalkCosts`):
  * ``dot_flops``: 2 * |result| * contracted extent of every ``aten`` mm,
    addmm, bmm, baddbmm, addbmm, mv, addmv and dot (``matmul``, ``linear``
    and ``einsum`` reach the dispatcher as these), outside the kernels;
  * ``naive_bytes``: operand plus result bytes of every op that moves data
    outside the kernels.  Eager torch fuses nothing, so every op is
    "scheduled" in the reference's sense; views, allocations and metadata
    ops move nothing;
  * ``collective_bytes`` / ``collective_by_op`` / ``collectives``: the
    ring-model bytes of every collective of ``repro_torch.distributed``
    (``analysis.ring_transfer``), real or planned (``distributed.planned``).

and the port's own:
  * ``by_kernel``: calls, FLOPs and bytes of each hand-written kernel, by
    its launch counter's name, from the kernel package's ``work(...)``
    (live score pairs only; inputs read once, outputs written once).  The
    ops of a kernel's plain version (its wrapper on the CPU) and of a
    collective's transport are not counted again;
  * ``peak_live_bytes``: the largest sum of live storages during the step,
    the arguments included.  Storages are keyed by their identity (a meta
    tensor has no data pointer) and die when no tensor holds them; a
    kernel's transient workspace counts at its launch;
  * ``argument_bytes``, ``output_bytes``, ``alias_bytes``: the storages of
    the step's arguments, of its result, and of the result's storages that
    are arguments' (caches written in place).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .analysis import Collective, ring_transfer

__all__ = ["Work", "WalkCosts", "walk", "active", "launch", "collective"]

aten = torch.ops.aten


class Work(NamedTuple):
    """One call's work: FLOPs (an FMA = 2), bytes that must move (each
    input read once, each output written once) and special-function
    results (exps) beside the FLOPs."""
    flops: float
    bytes: float
    exps: float = 0.0


@dataclasses.dataclass
class WalkCosts:
    dot_flops: float = 0.0
    naive_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collectives: List[Collective] = dataclasses.field(default_factory=list)
    by_kernel: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    peak_live_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0

    def kernel_calls(self) -> Dict[str, int]:
        return {k: int(v["calls"]) for k, v in self.by_kernel.items()}


def _lhs(func, args) -> torch.Tensor:
    """A product op's left operand: its last dim is the contracted
    extent."""
    if func in (aten.addmm.default, aten.baddbmm.default,
                aten.addbmm.default, aten.addmv.default):
        return args[1]
    return args[0]


_DOTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
         aten.baddbmm.default, aten.addbmm.default, aten.mv.default,
         aten.addmv.default, aten.dot.default}
# ops that allocate, alias or read metadata only
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.detach.default,
         aten.alias.default, aten.lift_fresh.default,
         aten._local_scalar_dense.default, aten.set_.source_Storage,
         aten.set_.source_Storage_storage_offset}


def _tensors(obj):
    """The tensors of an op's arguments or result (lists and tuples of
    tensors flattened)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, (list, tuple)):
                yield from _tensors(x)


def _tree_tensors(obj):
    """Every tensor of a step's argument or result tree (dicts, lists,
    tuples, NamedTuples, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tree_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tree_tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tree_tensors(getattr(obj, f.name))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # no storage (sparse, ...)
        return None


class _Walk:
    def __init__(self):
        self.costs = WalkCosts()
        self.quiet = 0
        self.live: Dict[int, int] = {}
        self.finalizers: Dict[int, weakref.finalize] = {}
        self.cur = 0
        self.lock = threading.RLock()     # a finalizer may run inside

    # -- storages ----------------------------------------------------------
    def note(self, obj, tree: bool = False) -> None:
        """Track the storages of ``obj``'s tensors not yet tracked."""
        for t in (_tree_tensors(obj) if tree else _tensors(obj)):
            st = _storage(t)
            if st is None:
                continue
            key = st._cdata
            with self.lock:
                if key in self.live:
                    continue
                n = st.nbytes()
                self.live[key] = n
                self.cur += n
                self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                                 self.cur)
                self.finalizers[key] = weakref.finalize(st, self._dead, key)

    def _dead(self, key: int) -> None:
        with self.lock:
            n = self.live.pop(key, None)
            self.finalizers.pop(key, None)
            if n is not None:
                self.cur -= n

    def transient(self, nbytes: int) -> None:
        """Workspace alive for one launch beside what is live now."""
        with self.lock:
            self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                             self.cur + int(nbytes))

    def close(self) -> None:
        with self.lock:
            fins = list(self.finalizers.values())
            self.finalizers.clear()
        for f in fins:
            f.detach()

    # -- counting ----------------------------------------------------------
    def count(self, func, args, kwargs, out) -> None:
        c = self.costs
        if func in _DOTS:
            res = out if isinstance(out, torch.Tensor) else None
            if res is not None:
                k = _lhs(func, args).shape[-1]
                c.dot_flops += 2.0 * res.numel() * k
        if func in _FREE or func.is_view:
            return
        ins = (*args, *kwargs.values()) if kwargs else args
        c.naive_bytes += float(sum(_nbytes(t) for t in _tensors(ins))
                               + sum(_nbytes(t) for t in _tensors(out)))

    def kernel(self, name: str, work: Work, out, workspace: int) -> None:
        self.note(out, tree=True)
        self.transient(workspace)
        k = self.costs.by_kernel.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0, "exps": 0.0})
        k["calls"] += 1
        k["flops"] += float(work.flops)
        k["bytes"] += float(work.bytes)
        k["exps"] += float(work.exps)

    def collective(self, op: str, results: List[int], group_size: int,
                   out) -> None:
        self.note(out, tree=True)
        c = self.costs
        for result_bytes in results:
            x = ring_transfer(op, result_bytes, group_size)
            c.collectives.append(Collective(op, int(result_bytes),
                                            int(group_size), x))
            c.collective_bytes += x
            c.collective_by_op[op] = c.collective_by_op.get(op, 0.0) + x


class _Mode(TorchDispatchMode):
    def __init__(self, w: _Walk):
        super().__init__()
        self.w = w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        w = self.w
        if not w.quiet:
            w.count(func, args, kwargs, out)
            w.note(out)
        return out


_ACTIVE: List[_Walk] = []


def active() -> Optional[_Walk]:
    """The innermost running walk, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _quietly(run: Callable) -> tuple:
    """(the running walk or None, ``run()``), its ops not counted."""
    w = active()
    if w is None:
        return None, run()
    w.quiet += 1
    try:
        return w, run()
    finally:
        w.quiet -= 1


def launch(name: str, work: Callable[[], Work], run: Callable,
           workspace: Callable[[], int] = lambda: 0):
    """``run()``, a kernel wrapper's body.  Under a walk its ops are not
    counted; instead its result's storages are tracked, ``workspace()``
    bytes count for the launch, and ``work()`` is added to ``by_kernel``
    under ``name``."""
    w, out = _quietly(run)
    if w is not None:
        w.kernel(name, work(), out, workspace())
    return out


def collective(op: str, results: List[int], group_size: int,
               run: Callable):
    """``run()``, a collective of ``repro_torch.distributed`` (real or
    planned) over ``group_size`` ranks, one result of each of ``results``
    bytes.  Under a walk its transport is not counted; each result is
    recorded with its ring-model bytes and tracked."""
    w, out = _quietly(run)
    if w is not None:
        w.collective(op, results, group_size, out)
    return out


def walk(fn: Callable, *args, **kw) -> WalkCosts:
    """Run ``fn(*args, **kw)`` once and count it (the module docstring).
    ``args`` / ``kw`` may hold tensors in dicts, lists, tuples and
    dataclasses: they are the step's arguments."""
    w = _Walk()
    w.note((args, kw), tree=True)
    w.costs.argument_bytes = w.cur
    arg_keys = set(w.live)
    _ACTIVE.append(w)
    try:
        with _Mode(w):
            out = fn(*args, **kw)
    finally:
        _ACTIVE.remove(w)
    seen = set()
    for t in _tree_tensors(out):
        st = _storage(t)
        if st is None or st._cdata in seen:
            continue
        seen.add(st._cdata)
        w.costs.output_bytes += st.nbytes()
        if st._cdata in arg_keys:
            w.costs.alias_bytes += st.nbytes()
    del out
    w.close()
    return w.costs
