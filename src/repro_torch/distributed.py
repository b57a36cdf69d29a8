"""Collectives over ``torch.distributed`` for the port's multi-device paths:
what ``repro/compat.py`` and ``jax.lax`` give the JAX package's
``shard_map`` code (``axis_size``, ``axis_index``, ``ppermute``,
``all_gather(tiled=True)``, ``psum`` / ``pmean``).

A :class:`Group` is a process group together with its RING ORDER: the
global ranks of its members in the order a mesh axis lists them
(``launch.mesh.Mesh.group``).  ``torch.distributed.new_group`` numbers a
group's members in sorted order, so the ring order is kept beside it:
``ppermute`` hops along it and ``all_gather`` tiles in it, as JAX's do
along a mesh axis.

**Transport rule**, from ``dist.get_backend`` and never from a caught
error:

* gloo -- CPU tensors go as they are; a CUDA tensor is copied to a pinned
  host buffer, sent, and the received buffer copied back to the device
  (gloo's point-to-point ops take no CUDA tensor; every gloo collective
  stages the same way, so there is one rule).  The bytes copied either
  way are counted in ``TRAFFIC.bytes_staged``.
* nccl (one card a rank) -- device buffers go directly, with no staging.

Every group is made with a timeout of at most :data:`TIMEOUT_S` seconds,
so a rank that hangs makes its peers raise instead of waiting forever.  No
collective's failure is caught here.

Under autograd, Megatron's conjugate pair carries tensor parallelism:
:func:`copy_to` (identity forward, ``psum`` of the gradient backward) and
:func:`reduce_from` (``psum`` forward, identity backward), beside
:func:`gather_from` (a tiled ``all_gather`` whose backward keeps the
member's block) and :func:`pmax` (not differentiated).  They are
``torch.autograd.Function``s over the collectives above, so staging, ring
order and ``TRAFFIC`` are theirs.  Every member runs the same autograd
graph, so the backward's collectives come in the same order on each.

Library entry points never start a process group: the caller does, as
``torchrun`` would (:func:`init_process_group`, or :func:`spawn_ranks` for
tests, examples and ``chip_smoke.py``).  Without a process group every
function here acts on a group of one rank and moves nothing.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["TIMEOUT_S", "TRAFFIC", "Traffic", "Group", "init_process_group",
           "is_initialized", "rank", "world_size", "world", "as_group",
           "new_group", "axis_size", "axis_index", "ppermute", "all_gather",
           "psum", "pmean", "pmax", "copy_to", "reduce_from",
           "gather_from", "spawn_ranks"]

TIMEOUT_S = 120.0
_BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass
class Traffic:
    """What this process's collectives moved since the last ``reset``:
    ``bytes_staged`` device <-> pinned-host copies (gloo with CUDA
    tensors), ``bytes_received`` payload bytes that arrived from peers,
    ``hops`` ``ppermute`` rounds and ``seconds`` the collectives' wall time
    (host clock, the transfers' waits included)."""

    bytes_staged: int = 0
    bytes_received: int = 0
    hops: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


TRAFFIC = Traffic()


def _timeout(seconds: Optional[float]) -> datetime.timedelta:
    s = TIMEOUT_S if seconds is None else min(float(seconds), TIMEOUT_S)
    return datetime.timedelta(seconds=s)


def init_process_group(backend: str, rank: int, world_size: int,
                       init_method: str,
                       timeout: Optional[float] = None) -> None:
    """``dist.init_process_group`` with the port's timeout cap
    (:data:`TIMEOUT_S`).  ``backend`` is ``"gloo"`` or ``"nccl"``."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {_BACKENDS}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=_timeout(timeout))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if is_initialized() else 1


class Group:
    """A process group and its members' global ranks in ring order.

    ``pg`` is None for a group of one rank without a process group, and on
    a rank outside the group.
    ``index`` is this process's position in ``ranks`` (JAX's
    ``axis_index``), -1 where it is not a member."""

    def __init__(self, pg, ranks: Sequence[int]):
        self.pg = pg
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        me = rank()
        self.index = self.ranks.index(me) if me in self.ranks else -1
        self.backend = dist.get_backend(pg) if pg is not None else None
        if self.backend is not None and self.backend not in _BACKENDS:
            raise ValueError(f"backend {self.backend!r}: the transport rule "
                             f"covers {_BACKENDS} only")

    @property
    def staged(self) -> bool:
        """True where CUDA tensors travel through pinned host buffers."""
        return self.backend == "gloo"

    def __repr__(self) -> str:
        return f"Group(ranks={self.ranks}, backend={self.backend})"


def world() -> Group:
    """Every rank, in rank order (one rank without a process group)."""
    if not is_initialized():
        return Group(None, (0,))
    return Group(dist.group.WORLD, range(dist.get_world_size()))


def as_group(group) -> Group:
    """``None`` -> :func:`world`; a ``ProcessGroup`` -> its members in rank
    order; a :class:`Group` as it is."""
    if group is None:
        return world()
    if isinstance(group, Group):
        return group
    return Group(group, dist.get_process_group_ranks(group))


def new_group(ranks: Sequence[int],
              timeout: Optional[float] = None) -> Group:
    """A group of ``ranks`` in that ring order.  Collective: every rank of
    the world calls it, with the same groups in the same order.  A rank
    outside ``ranks`` gets a group it cannot use (``pg`` None)."""
    ranks = [int(r) for r in ranks]
    pg = dist.new_group(sorted(ranks), timeout=_timeout(timeout))
    return Group(pg if rank() in ranks else None, ranks)


def axis_size(group=None) -> int:
    return as_group(group).size


def axis_index(group=None) -> int:
    return as_group(group).index


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

def _to_wire(g: Group, t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """The buffer that goes on the wire for ``t``: a pinned host copy of a
    CUDA tensor on gloo, else ``t`` itself (a copy where the collective
    writes in place and ``copy`` is set)."""
    t = t.contiguous()
    if g.staged and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        TRAFFIC.bytes_staged += t.numel() * t.element_size()
        return host
    return t.clone() if copy else t


def _from_wire(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    if buf.device != device:
        TRAFFIC.bytes_staged += buf.numel() * buf.element_size()
        return buf.to(device)
    return buf


def _wire_empty(g: Group, like: torch.Tensor) -> torch.Tensor:
    if g.staged and like.is_cuda:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like, memory_format=torch.contiguous_format)


def ppermute(xs, group=None, shift: int = 1):
    """Send ``xs`` (a tensor or a list of tensors) to the member ``shift``
    places further along the ring and return what arrives from the member
    ``shift`` places back: JAX's ``ppermute`` with the cyclic permutation
    ``[(j, (j + shift) % n)]``.  One ``batch_isend_irecv`` for all
    tensors."""
    g = as_group(group)
    single = isinstance(xs, torch.Tensor)
    xs = [xs] if single else list(xs)
    if g.size == 1 or shift % g.size == 0:
        return xs[0] if single else xs
    t0 = time.perf_counter()
    dst = g.ranks[(g.index + shift) % g.size]
    src = g.ranks[(g.index - shift) % g.size]
    sends = [_to_wire(g, x) for x in xs]
    recvs = [_wire_empty(g, x) for x in xs]
    ops = ([dist.P2POp(dist.isend, s, dst, g.pg, tag) for tag, s
            in enumerate(sends)]
           + [dist.P2POp(dist.irecv, r, src, g.pg, tag) for tag, r
              in enumerate(recvs)])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = [_from_wire(r, x.device) for r, x in zip(recvs, xs)]
    TRAFFIC.bytes_received += sum(r.numel() * r.element_size()
                                  for r in recvs)
    TRAFFIC.hops += 1
    TRAFFIC.seconds += time.perf_counter() - t0
    return out[0] if single else out


_BYTE_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every member's ``x`` concatenated on dim 0 in ring order: JAX's
    ``all_gather(x, axis, axis=0, tiled=True)``."""
    g = as_group(group)
    if g.size == 1:
        return x
    if x.dtype in _BYTE_DTYPES:
        # fp8 goes as its bytes (gloo has no float8 type)
        return all_gather(x.view(torch.uint8), g).view(x.dtype)
    t0 = time.perf_counter()
    buf = _to_wire(g, x)
    parts = [torch.empty_like(buf) for _ in range(g.size)]
    dist.all_gather(parts, buf, group=g.pg)
    # ``parts`` follows the group's sorted numbering; tile in ring order
    out = torch.cat([parts[dist.get_group_rank(g.pg, r)] for r in g.ranks])
    TRAFFIC.bytes_received += (g.size - 1) * buf.numel() * buf.element_size()
    out = _from_wire(out, x.device)
    TRAFFIC.seconds += time.perf_counter() - t0
    return out


def _all_reduce(x: torch.Tensor, g: Group, op) -> torch.Tensor:
    t0 = time.perf_counter()
    buf = _to_wire(g, x, copy=True)
    dist.all_reduce(buf, op=op, group=g.pg)
    TRAFFIC.bytes_received += buf.numel() * buf.element_size()
    out = _from_wire(buf, x.device)
    TRAFFIC.seconds += time.perf_counter() - t0
    return out


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every member's ``x`` (``dist.all_reduce``), as a new
    tensor on ``x``'s device."""
    g = as_group(group)
    if g.size == 1:
        return x
    return _all_reduce(x, g, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of every member's ``x``; not differentiated
    (the vocab-parallel cross-entropy's stabilizer)."""
    g = as_group(group)
    if g.size == 1:
        return x
    return _all_reduce(x.detach(), g, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    g = as_group(group)
    return x if g.size == 1 else psum(x, g) / g.size


# ---------------------------------------------------------------------------
# collectives under autograd: Megatron's conjugate operators
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return psum(dy, ctx.g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return psum(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim, ctx.n = g, dim, x.shape[dim]
        # contiguous: the kernels downstream (K3 on a gathered q / k) take
        # rows of unit stride
        return all_gather(x.movedim(dim, 0), g).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.g.index * ctx.n, ctx.n), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, ``psum`` of the gradient over ``group`` backward:
    where a tensor replicated over the group feeds work that each member
    does a part of (column-parallel products, a rank's heads or experts),
    the parts' gradients add up to the whole on every member."""
    g = as_group(group)
    return x if g.size == 1 else _CopyTo.apply(x, g)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``psum`` forward, identity backward: the members' partial results
    (a row-parallel product) summed into the replicated whole, whose
    gradient each member passes on as it is."""
    g = as_group(group)
    return x if g.size == 1 else _ReduceFrom.apply(x, g)


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The members' blocks concatenated on ``dim`` in ring order forward;
    backward, this member's block of the gradient.  For a result that every
    member then uses whole, with the whole gradient (wrap it in
    :func:`copy_to` where members use parts of it)."""
    g = as_group(group)
    if g.size == 1:
        return x
    return _GatherFrom.apply(x, g, dim % x.dim())


# ---------------------------------------------------------------------------
# starting ranks (what torchrun does, for tests, examples and the smoke)
# ---------------------------------------------------------------------------

def _rank_main(fn, rank_: int, world: int, store: str, out: str,
               args: tuple) -> None:
    # the host's cores shared among the ranks, as torchrun's one thread a
    # rank shares them, instead of every rank taking them all
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_process_group("gloo", rank_, world, f"file://{store}")
    try:
        result = fn(rank_, world, *args)
        with open(out, "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: tuple = (), *,
                timeout: float = 120.0,
                workdir: Optional[str] = None) -> List:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method), each in a gloo process group over a
    ``FileStore`` in a temporary directory, and return their results in
    rank order.  (A caller that wants NCCL starts its ranks as ``torchrun``
    does and calls :func:`init_process_group` itself.)

    ``fn`` must be importable by name (a module-level function).  Each rank
    writes its pickled result to a file that the parent reads.  The parent
    polls the ranks: when one exits with an error the rest are killed at
    once, and when ``timeout`` seconds pass first all are killed; either
    raises.  No rank outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, store, outs[r],
                                   tuple(args)), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(
                        f"rank(s) {failed} of {world} failed (exit codes "
                        f"{[procs[r].exitcode for r in failed]}); see "
                        f"their tracebacks above")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in "
                                       f"{timeout:.0f} s")
                time.sleep(0.02)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(f"rank(s) {failed} of {world} failed")
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join(10)
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
