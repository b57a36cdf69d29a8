"""Distributed-optimization collectives: int8-compressed ring all-reduce
with error feedback over the DGRO-ordered ring (torch port of
``repro.train.collectives``).

The gradient all-reduce across hosts is a RING reduce-scatter + all-gather
of ``ppermute`` hops (``repro_torch.distributed``); the ring ORDER is the
group's, i.e. the mesh's rank order along the axis, which
``launch.mesh.make_production_mesh`` builds from the DGRO ring
optimization (the paper's technique applied to the collective plane).

Compression: per-chunk symmetric int8 quantization (scale = max|x|/127),
4x less traffic than fp32.  The quantization error is returned so the
caller can apply error feedback (add the residual into the next step's
gradient).  Functions here are called by every rank of ``group`` (a
``distributed.Group``, e.g. ``Mesh.group("data")``; None = the world), as
the reference's are called inside ``shard_map``.  The arithmetic is the
reference's op for op as XLA compiles it (fused multiply-adds, the
reciprocal of 127), so each rank's result is bitwise the JAX device's
under ``jit``.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .. import distributed as D
from .optimizer import tree_leaves, tree_like

__all__ = ["ring_allreduce", "compressed_grad_mean",
           "compressed_grad_allreduce", "ring_chunks", "ring_allreduce_bound",
           "chunk_error_bound"]

Tree = Any


# the reference's ``max|x| / 127.0 + 1e-12`` as XLA compiles it: a multiply
# by the fp32 reciprocal of 127, fused with the add
_INV127 = float(np.float32(1.0) / np.float32(127.0))
_EPS = float(np.float32(1e-12))


_FMA_SLICE = 1 << 22


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once.  The product of an fp32 and an fp32
    or int8 is exact in fp64; the fp64 sum is made round-to-odd (where it
    is inexact and its last bit even, it moves one step toward the part it
    lost, which TwoSum gives exactly), and an fp64 value rounded to odd
    rounds to fp32 as the exact sum would: 53 bits hold 24 + 2, so an fp32
    tie seen in fp64 is a real tie."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    lost = (p - (s - bb)) + (c - bb)             # p + c == s + lost exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, torch.inf), lost)
    s = torch.where((lost != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """fp32 ``a * b + c`` with one rounding, as XLA fuses a multiply-add
    (LLVM contracts it to an FMA), by :func:`_fma64`.  Elementwise over
    ``a`` and ``c`` (``b`` a scalar tensor or a tensor of ``a``'s shape),
    2^22 elements at a time to bound the fp64 temporaries."""
    c = c if torch.is_tensor(c) else torch.tensor(c, dtype=torch.float64)
    if a.dim() == 0 or a.numel() <= _FMA_SLICE:
        return _fma64(a, b, c)
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    af, of = a.reshape(-1), out.reshape(-1)
    bf = b.reshape(-1) if b.dim() else b
    cf = c.reshape(-1) if c.dim() else c
    for lo in range(0, af.numel(), _FMA_SLICE):
        hi = lo + _FMA_SLICE
        of[lo:hi] = _fma64(af[lo:hi], bf[lo:hi] if b.dim() else bf,
                           cf[lo:hi] if c.dim() else cf)
    return out


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes and their fp32 scale, bitwise the reference's
    ``_quantize`` as it runs inside the compiled ring (under ``jit``; eager
    JAX divides by 127 instead, which differs in the scale's last bit for
    about 7% of vectors)."""
    scale = _fma(torch.max(torch.abs(x)), torch.tensor(_INV127), _EPS)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _ring_allreduce_1d(x: torch.Tensor, group: D.Group) -> torch.Tensor:
    """Ring all-reduce (reduce-scatter + all-gather) of a flat fp32 vector
    with int8-compressed hops; ``x`` divides by the group's size."""
    n, i = group.size, group.index
    acc = x.reshape(n, -1).clone()

    # reduce-scatter: after n-1 hops, rank i holds the full sum of chunk
    # (i+1) mod n; each hop sends the chunk accumulated for (i - step)
    for step in range(n - 1):
        q, s = _quantize(acc[(i - step) % n])
        q_r, s_r = D.ppermute([q, s], group)
        recv = (i - step - 1) % n
        acc[recv] = _fma(q_r, s_r, acc[recv])

    # all-gather: quantize each finished chunk ONCE and circulate the int8
    # payload unchanged, so every rank dequantizes identical bits
    own = (i + 1) % n
    q, s = _quantize(acc[own])
    out_q = torch.zeros((n,) + q.shape, dtype=torch.int8, device=x.device)
    out_s = torch.zeros((n,), dtype=torch.float32, device=x.device)
    out_q[own], out_s[own] = q, s
    for step in range(n - 1):
        q, s = D.ppermute([q, s], group)
        idx = (i - step) % n              # the chunk that arrives now
        out_q[idx], out_s[idx] = q, s
    return (out_q.to(torch.float32) * out_s[:, None]).reshape(x.shape)


def ring_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed ring all-reduce of ``x`` (the same shape on every
    rank of ``group``): the sum, in ``x``'s dtype.  Flattened to fp32 and
    padded with zeros to a multiple of the group's size."""
    g = D.as_group(group)
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % g.size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = _ring_allreduce_1d(flat, g)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)


def _error_fed(grads: Tree, error_fb: Tree | None) -> list:
    """The gradient leaves with the error feedback added, in their dtype."""
    leaves = tree_leaves(grads)
    if error_fb is None:
        return leaves
    return [x + e.to(x.dtype) for x, e in zip(leaves, tree_leaves(error_fb))]


def compressed_grad_mean(grads: Tree, group=None,
                         error_fb: Tree | None = None) -> Tree:
    """The mean over ``group`` of every rank's gradients (plus ``error_fb``
    where given), one int8 ring per leaf: the first output of
    :func:`compressed_grad_allreduce`, without its residuals -- what the
    reference computes when the residuals go unused (XLA drops them)."""
    g = D.as_group(group)
    # ``/ n`` as XLA compiles it: by the fp32 reciprocal, in fp32
    inv = float(np.float32(1.0) / np.float32(g.size))
    return tree_like(grads, [
        (ring_allreduce(x, g).to(torch.float32) * inv).to(x.dtype)
        for x in _error_fed(grads, error_fb)])


def compressed_grad_allreduce(grads: Tree, group=None,
                              error_fb: Tree | None = None
                              ) -> Tuple[Tree, Tree]:
    """Mean-all-reduce per-rank gradients with int8 compression and error
    feedback.  One ring per leaf, as the reference's ``jax.tree.map``
    runs one, so the per-chunk scales are the reference's.

    Returns (reduced_grads, new_error_feedback): the residual this rank's
    quantization of its (error-fed) gradients drops, to be added to the
    next step's gradients."""
    mean = compressed_grad_mean(grads, group, error_fb)

    def residual(x):
        q, s = _quantize(x.to(torch.float32))
        return _fma(q, -s, x.to(torch.float32))

    return mean, tree_like(grads, [residual(x)
                                   for x in _error_fed(grads, error_fb)])


def chunk_error_bound(parts, first: int) -> float:
    """Bound on |ring result - exact sum| over one chunk of the ring:
    ``parts[r]`` is rank r's slice of the chunk (ring order), and the chunk
    starts its trip at rank ``first``.

    The sender of the j-th hop quantizes the partial sum S_j of ranks
    first..first+j-1 plus the error e_j carried so far, adding at most
    max|S_j + e_j| / 254 an element (a scale of max / 127, round to
    nearest); the finished sum S_n is quantized once more.  So with
    e_0 = 0, e_j = e_{j-1} + (max|S_j| + e_{j-1}) / 254 for j = 1..n,
    each term widened by one fp32 rounding of the running sum (2^-24 of
    its magnitude)."""
    n = len(parts)
    part = torch.zeros(parts[0].shape, dtype=torch.float64,
                       device=parts[0].device)
    err = 0.0
    for j in range(n):                    # n - 1 hops, then the final sum
        part += parts[(first + j) % n].to(torch.float64)
        top = float(part.abs().max()) + err
        err += top / 254.0 + top * 2.0 ** -24
    return err


def ring_chunks(size: int, n: int) -> list:
    """The ring's chunks of a flat vector of ``size`` values over ``n``
    ranks, as (c, lo, hi): :func:`ring_allreduce` pads the vector to a
    multiple of n and chunk c, [c * m, (c + 1) * m) with m = ceil(size /
    n), starts its trip at rank c.  Chunks of padding alone are left out."""
    m = -(-size // n)
    return [(c, c * m, min((c + 1) * m, size)) for c in range(n)
            if c * m < size]


def ring_allreduce_bound(xs) -> torch.Tensor:
    """Elementwise bound on |ring_allreduce - exact sum| for per-rank inputs
    ``xs`` (a sequence of n same-shape tensors, in ring order), flattened,
    in float64 on their device: each chunk (:func:`ring_chunks`) bounded by
    :func:`chunk_error_bound`."""
    flat = [x.reshape(-1) for x in xs]
    out = torch.empty(flat[0].numel(), dtype=torch.float64,
                      device=flat[0].device)
    for c, lo, hi in ring_chunks(flat[0].numel(), len(xs)):
        out[lo:hi] = chunk_error_bound([x[lo:hi] for x in flat], c)
    return out
