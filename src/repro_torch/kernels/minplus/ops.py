"""Public min-plus entry points: padding, tile choice, blocked-FW schedule.

Dispatch is by the device of the operands, inside the wrappers of
``kernel.py``: a CUDA tensor runs the hand-written kernels, a CPU tensor
their plain twins.  The padding and tile rules are the JAX package's, so
the blocked Floyd-Warshall visits the same candidates in the same blocks
and stays bit-equal to it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import fw_tile, minplus_acc
from .ref import minplus_batched_ref, minplus_ref

INF = 1e9
_CHUNK = 8


def _ceil_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def default_tile(n: int, cap: int = 256) -> int:
    """Tile for the blocked-FW APSP: the smallest 8-multiple tiling N in
    ``ceil(N / cap)`` blocks (N=300 tiles as 2 x 152, not 2 x 256).  The
    tile fixes which candidates each block sees, so it must stay the JAX
    package's for bit parity."""
    nb = max(1, -(-n // cap))
    return _ceil_to(max(-(-n // nb), _CHUNK), _CHUNK)


def _pad_to(x: torch.Tensor, mult: int, fill: float) -> torch.Tensor:
    """Pad the last two dims up to multiples of ``mult`` with ``fill``."""
    pm = (-x.shape[-2]) % mult
    pn = (-x.shape[-1]) % mult
    if pm == 0 and pn == 0:
        return x
    return F.pad(x, (0, pn, 0, pm), value=fill)


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-plus product of two matrices in float32: K1 with B=1 on CUDA
    (it masks ragged edges itself, so no padding), the dense twin on the
    CPU."""
    a, b = a.float(), b.float()
    if a.device.type == "cpu":
        return minplus_ref(a, b)
    return minplus_acc(a.contiguous()[None], b.contiguous()[None])[0]


def minplus_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched min-plus ``(B, M, K) x (B, K, N) -> (B, M, N)`` in the
    operands' dtype (fp32 or bf16): K1 on CUDA, the dense twin on the CPU."""
    if a.device.type == "cpu":
        return minplus_batched_ref(a, b)
    return minplus_acc(a.contiguous(), b.contiguous())


def _blocked_fw(d: torch.Tensor, t: int, symmetric: bool) -> torch.Tensor:
    """Blocked Floyd-Warshall of one padded (N, N) matrix, updated in
    place: per diagonal block, K2 closes the tile, K1 relaxes the row and
    column panels out of place (their operands stay frozen), then K1
    updates the whole matrix in place against the two fresh panels."""
    n = d.shape[0]
    for o in range(0, n, t):
        s = slice(o, o + t)
        diag = fw_tile(d[s, s])
        d[s, s] = diag
        rowp = minplus_acc(diag[None], d[None, s, :], init=d[None, s, :])[0]
        if symmetric:
            colp = rowp.T.contiguous()
        else:
            colp = minplus_acc(d[None, :, s], diag[None],
                               init=d[None, :, s])[0]
        d[s, :] = rowp
        d[:, s] = colp
        minplus_acc(colp[None], rowp[None], init=d[None], out=d[None])
    return d


def apsp_tiled(d: torch.Tensor, tile: int | None = None, *,
               symmetric: bool = False) -> torch.Tensor:
    """Blocked Floyd-Warshall APSP of one (N, N) adjacency, fp32 or bf16.

    Pads N to a ``tile`` multiple with INF (padded nodes are unreachable
    and sliced off) and runs the (N/T, N/T) block schedule of
    ``ref.apsp_tiled_ref``: on CUDA through K2 and K1, on the CPU through
    their twins.  ``symmetric`` derives the column panel as the row panel's
    transpose -- bitwise-safe for undirected overlays.  ``d`` is not
    modified.
    """
    n = d.shape[-1]
    if d.dim() != 2 or d.shape[0] != n:
        raise ValueError(f"apsp_tiled needs one square matrix, got "
                         f"{tuple(d.shape)}")
    if tile is None:
        tile = default_tile(n)
    dp = _pad_to(d, tile, INF)
    out = _blocked_fw(dp.clone() if dp is d else dp, tile, symmetric)
    return out[:n, :n]


__all__ = ["minplus", "minplus_batched", "minplus_ref", "minplus_batched_ref",
           "apsp_tiled", "default_tile"]
