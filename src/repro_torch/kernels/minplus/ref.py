"""Plain-torch twins of the min-plus kernels (unbatched, batched, tiled).

Each function here is the plain version of a CUDA kernel in ``kernel.py``
or of an oracle of the JAX package's ``kernels/minplus/ref.py``, and works
on a tensor of any device.  A min over floats is exact, so any regrouping
of the same candidate set -- the kernels' register tiles against the
rank-1 loops here -- gives identical bits; the tests and ``chip_smoke.py``
hold the kernels to these twins bitwise.
"""
from __future__ import annotations

import torch


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i, j] = min_k A[i, k] + B[k, j] (dense broadcast)."""
    return torch.amin(a[:, :, None] + b[None, :, :], dim=1)


def minplus_batched_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[b, i, j] = min_k A[b, i, k] + B[b, k, j] (dense broadcast)."""
    return torch.amin(a[:, :, :, None] + b[:, None, :, :], dim=2)


def minplus_acc_ref(a: torch.Tensor, b: torch.Tensor,
                    init: torch.Tensor | None = None) -> torch.Tensor:
    """Twin of K1: ``min(init, a ⊗ b)`` over a leading batch axis, by
    rank-1 updates against FROZEN ``a`` and ``b`` (O(B·M·N) memory).
    With no ``init`` the accumulator starts at +inf, so the result is the
    plain min over k."""
    if init is None:
        init = torch.full((*a.shape[:-1], b.shape[-1]), float("inf"),
                          dtype=a.dtype, device=a.device)
    acc = init
    for k in range(a.shape[-1]):
        acc = torch.minimum(acc, a[..., :, k:k + 1] + b[..., k:k + 1, :])
    return acc


# ---------------------------------------------------------------------------
# blocked Floyd-Warshall (the tiled APSP)
# ---------------------------------------------------------------------------

def fw_tile_ref(d: torch.Tensor, *, symmetric: bool = False) -> torch.Tensor:
    """Twin of K2: transitive closure of one (T, T) tile by rank-1
    Floyd-Warshall, pivot row and column taken from the tile before each
    pivot's update.  ``symmetric`` reads only the pivot row -- bitwise
    equal on symmetric tiles (the two update terms commute under +)."""
    for k in range(d.shape[0]):
        row = d[k:k + 1, :]
        col = row.T if symmetric else d[:, k:k + 1]
        d = torch.minimum(d, col + row)
    return d


def _panel_update(p: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """``min(p, a ⊗ b)`` with the product taken against FROZEN a, b.

    Freezing matters: updating the operand mid-loop would admit ulp-level
    double-relaxation candidates the kernel (which reduces against the
    unmodified block) never sees, breaking bit parity.
    """
    return minplus_acc_ref(a, b, p)


def apsp_tiled_ref(d: torch.Tensor, tile: int, *,
                   symmetric: bool = False) -> torch.Tensor:
    """Blocked Floyd-Warshall APSP over a (tile, tile) block grid.

    For each diagonal block k: close the diagonal tile; relax the k-th row
    panel against it (``min(rowp, diag ⊗ rowp)``) and the column panel
    symmetrically; then one rank-T outer update of the WHOLE matrix against
    the fresh panels (``min(d, colp ⊗ rowp)``).  ``symmetric`` derives the
    column panel as ``rowp.T``.  Requires ``d.shape[0] % tile == 0``
    (callers pad with INF).  Does not modify ``d``.
    """
    n = d.shape[0]
    assert n % tile == 0, (n, tile)
    d = d.clone()
    for o in range(0, n, tile):
        s = slice(o, o + tile)
        diag = fw_tile_ref(d[s, s], symmetric=symmetric)
        rowp = d[s, :].clone()
        rowp[:, s] = diag
        rowp = _panel_update(rowp, diag, rowp)
        if symmetric:
            colp = rowp.T
        else:
            colp = d[:, s].clone()
            colp[s, :] = diag
            colp = _panel_update(colp, colp, diag)
        d[s, :] = rowp
        d[:, s] = colp
        d = _panel_update(d, colp, rowp)
    return d
