"""Graph embedding + Q-head (paper §IV-D, Eqns 2-4, Fig. 4), torch port of
``repro.core.embedding``.

structure2vec-style embedding over (complete graph W, partial solution A_t):

    mu_v^{t+1} = relu( theta1 * x_v
                     + theta2 @ sum_{u in N(v)} mu_u
                     + theta3 @ sum_{u in N(v)} relu(theta4 * w(v,u)) )   (2)

    x(u) = [ w(v_t,u), theta5 @ sum_v mu_v, theta6 @ mu_{v_t}, theta7 @ mu_u ]  (3)

    Qhat(S_t, u) = theta10^T relu(theta9 relu(theta8 relu(x)))            (4)

Every neighbourhood sum is a product with the partial-solution adjacency
A_t (Fig. 4), so a batch of states is a handful of batched matrix
products; they run in fp32 (keep TF32 off on the card, or argmax decisions
drift from the reference's).  theta1 is in R^p as in structure2vec.

:func:`init_qparams` draws from a ``torch.Generator`` -- the reference
draws with ``jax.random``, which torch cannot reproduce, so parity with
the JAX package goes through :func:`qparams_from_jax`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn.functional import relu

from repro_torch.device import resolve_device

__all__ = ["QParams", "THETAS", "init_qparams", "embed", "q_values",
           "q_values_batch", "qparams_from_jax", "qparams_to_numpy"]

THETAS = tuple(f"theta{i}" for i in range(1, 11))


class QParams(nn.Module):
    """theta1..theta10 of Eqns 2-4 as parameters under those names:

    theta1 (p,), theta2/3 (p, p), theta4 (p,), theta5/6/7 (p, p),
    theta8 (h, 3p+1), theta9 (h, h), theta10 (h,).
    """

    def __init__(self, **thetas: torch.Tensor):
        super().__init__()
        if set(thetas) != set(THETAS):
            raise ValueError(f"QParams needs exactly {THETAS}, got "
                             f"{sorted(thetas)}")
        for name in THETAS:
            t = thetas[name]
            self.register_parameter(
                name, t if isinstance(t, nn.Parameter) else nn.Parameter(t))

    def tensors(self) -> Dict[str, torch.Tensor]:
        """theta1..theta10 in order, as a name -> parameter dict."""
        return {name: getattr(self, name) for name in THETAS}

    def on(self, device) -> "QParams":
        """These parameters on ``device``: ``self`` when already there, else
        a copy (``nn.Module.to`` would move the caller's module)."""
        device = torch.device(device)
        if self.theta1.device == device:
            return self
        return QParams(**{k: v.detach().to(device)
                          for k, v in self.tensors().items()})


def init_qparams(generator: torch.Generator, p: int = 16, h: int = 64,
                 device=None) -> QParams:
    """Glorot-style normal draws from ``generator``, in theta order, then
    moved to ``device`` (so a seed gives the same parameters on any
    device)."""
    dev = resolve_device(device)
    shapes = [(p,), (p, p), (p, p), (p,), (p, p), (p, p), (p, p),
              (h, 3 * p + 1), (h, h), (h,)]
    thetas = {}
    for name, shape in zip(THETAS, shapes):
        fan = sum(shape) if len(shape) > 1 else shape[0] + 1
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        thetas[name] = (x * np.float32(np.sqrt(2.0 / fan))).to(dev)
    return QParams(**thetas)


def qparams_from_jax(arrays: Dict[str, np.ndarray], device=None) -> QParams:
    """Carry parameters across from the JAX package: ``arrays`` maps
    theta1..theta10 to numpy arrays (``{k: np.asarray(v) for k, v in
    jax_params._asdict().items()}``)."""
    dev = resolve_device(device)
    return QParams(**{k: torch.tensor(np.asarray(arrays[k], np.float32),
                                      device=dev) for k in THETAS})


def qparams_to_numpy(params: QParams) -> Dict[str, np.ndarray]:
    """The inverse of :func:`qparams_from_jax`: theta name -> numpy array."""
    return {k: v.detach().cpu().numpy() for k, v in params.tensors().items()}


def embed(params: QParams, w: torch.Tensor, adj: torch.Tensor,
          n_rounds: int = 3) -> torch.Tensor:
    """``n_rounds`` rounds of Eqn. (2) over (..., N, N) latencies and {0,1}
    partial-solution adjacencies.  Returns (..., N, p) node embeddings.

    relu(w x theta4) is materialised as (..., N, N, p), as in the
    reference."""
    deg = adj.sum(-1)                                            # x_v
    lat_feat = torch.einsum("...vu,...vup->...vp", adj,
                            relu(w[..., None] * params.theta4))
    lat_term = lat_feat @ params.theta3.T                        # (..., N, p)
    deg_term = deg[..., None] * params.theta1                    # (..., N, p)
    mu = torch.zeros(adj.shape[:-1] + (params.theta1.shape[0],),
                     dtype=adj.dtype, device=adj.device)
    for _ in range(n_rounds):
        agg = adj @ mu                                           # Fig. 4 row 1
        mu = relu(deg_term + agg @ params.theta2.T + lat_term)
    return mu


def q_values_batch(params: QParams, w: torch.Tensor, adj: torch.Tensor,
                   v_t: torch.Tensor, n_rounds: int = 3) -> torch.Tensor:
    """Q(S_t, u) for every candidate u of B states at once (Eqns 3-4):
    ``w``/``adj`` (B, N, N), ``v_t`` (B,) current end nodes.  Returns
    (B, N)."""
    b, n = w.shape[0], w.shape[-1]
    mu = embed(params, w, adj, n_rounds)                         # (B, N, p)
    p = mu.shape[-1]
    v_t = torch.as_tensor(v_t, device=w.device).long().reshape(b)
    pooled = mu.sum(1) @ params.theta5.T                         # (B, p)
    src = mu.gather(1, v_t[:, None, None].expand(b, 1, p))[:, 0] \
        @ params.theta6.T                                        # (B, p)
    tgt = mu @ params.theta7.T                                   # (B, N, p)
    w_row = w.gather(1, v_t[:, None, None].expand(b, 1, n))[:, 0]
    x = torch.cat([w_row[..., None], pooled[:, None].expand(b, n, p),
                   src[:, None].expand(b, n, p), tgt], dim=-1)   # (B, N, 3p+1)
    hidden = relu(relu(x) @ params.theta8.T)
    hidden = relu(hidden @ params.theta9.T)
    return hidden @ params.theta10                               # (B, N)


def q_values(params: QParams, w: torch.Tensor, adj: torch.Tensor, v_t,
             n_rounds: int = 3) -> torch.Tensor:
    """Q(S_t, u) for every candidate u of one state.  Returns (N,)."""
    v = torch.as_tensor(v_t, device=w.device).reshape(1)
    return q_values_batch(params, w[None], adj[None], v, n_rounds)[0]
